"""K1 and K2: the circulant-G diffusion stencil and the fused zero-drift
RK4 forward step, as CUDA kernels, and K2's whole forward solve.

K1 replaces the Pallas kernel ``_circ_pallas`` (sdeflow_tpu/ops/pallas/
circulant.py:35-75), K2 replaces ``_rk4_pallas`` (:98-146). The wrappers
``circulant_apply``, ``circulant_rk4_step`` and
``circulant_rk4_solve_select`` (the forward solve of integrate_select with K2
as its step, in one launch: the JAX package's ``lax.scan`` over the Pallas
kernel, sdeflow_tpu/ops/integrators.py:203-243) go through their
``torch.autograd.Function``: the kernel (``csrc/circulant.cu``,
``csrc/rk4.cu``) on CUDA tensors, the plain versions ``circ_math``,
``rk4_math_fwd`` and ``rk4_solve_select_math`` on CPU tensors, and the
plain versions' derivatives in every case (ops/kernels/common.py; K1's
forward through the operator ``sdeflow::circulant_apply``): their
closed-form tangents ``circ_math_jvp``, ``rk4_math_jvp`` and
``rk4_solve_select_jvp`` for forward mode. Unlike the JAX entry points,
which keep the Pallas kernels for d ≥ 128, the CUDA kernels take any B and
d: one warp per row in registers where d % 32 == 0 and d ≤ 1,024, a
general plan otherwise (``circulant_plan`` and ``rk4_plan`` mirror the C
choosers, ``kernel_plan`` reads them).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sdeflow_tpu_torch.ops.gapply import circulant_sigma_apply
from sdeflow_tpu_torch.ops.kernels import common

_P, _I = ctypes.c_void_p, ctypes.c_longlong
_PLAN = [_I, _I, ctypes.c_int, _P]
K1 = common.register(common.Kernel(
    "circulant_apply", "circulant.cu",
    {"circulant_apply_f32": [_P, _P, _P, _P, _I, _I, _P],
     "circulant_plan": _PLAN},
))
K2 = common.register(common.Kernel(
    "circulant_rk4_step", "rk4.cu",
    {"circulant_rk4_step_f32": [_P] * 5 + [_I] * 3 + [_P],
     "circulant_rk4_plan": _PLAN},
))
K2_SOLVE = common.register(common.Kernel(
    "circulant_rk4_solve", "rk4.cu",
    {"circulant_rk4_solve_select_f32": [_P, _P, ctypes.c_float]
     + [_P] * 4 + [_I] * 4 + [_P]},
))

# the launch plans' constants in csrc/circ_row.cuh, circulant.cu, rk4.cu
_THREADS = 256  # threads of a general-plan block (K1: elements; K2: rows)
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
MAX_PER_LANE = 32  # warp plan: rows of up to 32 * 32 = 1,024 floats
K1_ROWS, K2_ROWS = 8, 4  # warp plan: rows (warps) per block
K2_BUFFERS = 4  # K2's general plan: state, stage state, k, running sum

# plain version, c·(roll(√β·y, −1)·w − roll(√β·y·w, +1)): the roll stencil
circ_math = circulant_sigma_apply


def rk4_math_fwd(sb3, x, w):
    """Plain version of K2, a copy of ``_rk4_math_fwd`` (sdeflow_tpu/ops/
    pallas/circulant.py:87-95) with its operation order: one RK4 step of the
    zero-drift circulant flow, stage √β = sb3[:, 0], sb3[:, 1] (twice),
    sb3[:, 2], one shared increment w."""
    k1 = circ_math(sb3[:, 0:1], x, w)
    k2 = circ_math(sb3[:, 1:2], x + 0.5 * k1, w)
    k3 = circ_math(sb3[:, 1:2], x + 0.5 * k2, w)
    k4 = circ_math(sb3[:, 2:3], x + k3, w)
    return x + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0


def circ_math_jvp(sb, y, w, dsb, dy, dw):
    """Tangent of ``circ_math``, which is trilinear in (√β, y, w): the sum
    of circ_math with one argument swapped for its tangent, over the
    tangents that are not None."""
    out = None
    for args, d in (((dsb, y, w), dsb), ((sb, dy, w), dy),
                    ((sb, y, dw), dw)):
        if d is not None:
            out = common.add(out, circ_math(*args))
    return torch.zeros_like(y) if out is None else out


def rk4_math_jvp(sb3, x, w, dsb3, dx, dw):
    """Tangent of ``rk4_math_fwd``, stage by stage (None: no tangent)."""
    ks, dks = [], []
    xs, dxs = x, dx
    for col, frac in ((0, 0.5), (1, 0.5), (1, 1.0), (2, None)):
        sb = sb3[:, col:col + 1]
        dsb = None if dsb3 is None else dsb3[:, col:col + 1]
        ks.append(circ_math(sb, xs, w))
        dks.append(circ_math_jvp(sb, xs, w, dsb, dxs, dw))
        if frac is not None:
            xs = x + frac * ks[-1]
            dxs = common.add(dx, frac * dks[-1])
    return common.add(dx, (dks[0] + 2.0 * dks[1] + 2.0 * dks[2] + dks[3])
                      / 6.0)


def rk4_solve_select_math(x0, z, sb, select_idx, sqrt_delta):
    """Plain version of K2's solve: integrate_select's loop with
    ``rk4_math_fwd`` as the step. x0 (B, d); z (n, B, d) the normals, step i
    taking w = sqrt_delta·z[i] and √β sb[i] (n, 3) at its stage times;
    select_idx (B,). Returns, per row b, the state after select_idx[b]
    steps (x0 where it is 0, or outside [0, n])."""
    b = x0.shape[0]
    sel = select_idx.reshape(-1, 1)
    x = kept = x0
    for i in range(z.shape[0]):
        x = rk4_math_fwd(sb[i].expand(b, 3), x, sqrt_delta * z[i])
        kept = torch.where(sel == i + 1, x, kept)
    return kept


def rk4_solve_select_jvp(x0, z, sb, select_idx, sqrt_delta, dx0, dz, dsb):
    """Tangent of ``rk4_solve_select_math``: the same loop over
    ``rk4_math_jvp`` (None: no tangent)."""
    b = x0.shape[0]
    sel = select_idx.reshape(-1, 1)
    x, dx = x0, dx0
    dkept = torch.zeros_like(x0) if dx0 is None else dx0
    for i in range(z.shape[0]):
        sb3, w = sb[i].expand(b, 3), sqrt_delta * z[i]
        dx = rk4_math_jvp(sb3, x, w, None if dsb is None else
                          dsb[i].expand(b, 3), dx,
                          None if dz is None else sqrt_delta * dz[i])
        x = rk4_math_fwd(sb3, x, w)
        dkept = torch.where(sel == i + 1, dx, dkept)
    return dkept


class RowPlan(NamedTuple):
    kind: str      # "warp": one warp per row in registers; else "general"
    per_lane: int  # floats per lane (warp plan), else 0
    vec: int       # floats per load: 4 (float4) or 1
    rows: int      # rows per block (0: K1's general plan, 256 elements each)
    blocks: int
    in_smem: bool  # K2's general plan: its four buffers in shared memory


def _per_lane(d):
    return d // 32 if 0 < d <= 32 * MAX_PER_LANE and d % 32 == 0 else 0


def circulant_plan(b, d, aligned=True):
    """K1's launch plan for (B, d) (the C function ``choose`` in
    csrc/circulant.cu): one warp per row, 8 rows per block, float4 loads
    where d % 128 == 0 and the rows are 16-byte aligned; else one thread
    per element."""
    v = _per_lane(d)
    if v:
        return RowPlan("warp", v, 4 if v % 4 == 0 and aligned else 1,
                       K1_ROWS, -(-b // K1_ROWS), False)
    return RowPlan("general", 0, 1, 0, -(-(b * d) // _THREADS), False)


def rk4_layout(b, d):
    """The layout of K2's general plan: rows per block (whole rows, several
    when d < 256), the blocks, and whether its four buffers (4·rows·d
    floats) fit shared memory; if not they live in a global scratch."""
    rows = max(1, _THREADS // d) if d else 1
    blocks = -(-b // rows)
    return rows, blocks, 4 * K2_BUFFERS * rows * d <= _SMEM_LIMIT


def rk4_plan(b, d, aligned=True):
    """The launch plan of K2 and its solve for (B, d) (the C function
    ``choose`` in csrc/rk4.cu): the warp plan as K1's with 4 rows per
    block; else the general plan of ``rk4_layout``."""
    v = _per_lane(d)
    if v:
        return RowPlan("warp", v, 4 if v % 4 == 0 and aligned else 1,
                       K2_ROWS, -(-b // K2_ROWS), False)
    return RowPlan("general", 0, 1, *rk4_layout(b, d))


def kernel_plan(kernel, b, d, aligned=True):
    """The plan the compiled chooser of ``kernel`` (K1, or K2 and its
    solve) picks, to hold ``circulant_plan`` and ``rk4_plan`` to on a
    card."""
    out = (ctypes.c_longlong * 6)()
    fn = (K1.lib().circulant_plan if kernel is K1
          else K2.lib().circulant_rk4_plan)
    fn(b, d, int(aligned), out)
    kind, per_lane, vec, rows, blocks, in_smem = out
    return RowPlan(("general", "warp")[kind], per_lane, vec, rows, blocks,
                   bool(in_smem))


def _check(name, x, w):
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32 inputs")
    if w.shape != x.shape or x.ndim != 2:
        raise ValueError(f"w {tuple(w.shape)} and x {tuple(x.shape)} must "
                         "be the same (B, d)")


def _launch_k1(sb, y, w):
    _check("circulant_apply", y, w)
    b, d = y.shape
    sb, y, w = sb.contiguous(), y.contiguous(), w.contiguous()
    out = torch.empty_like(y)
    K1.launch("circulant_apply_f32", common.ptr(sb), common.ptr(y),
              common.ptr(w), common.ptr(out), b, d)
    return out


def _scratch(b, d, x):
    """The global buffers of K2's general plan where shared memory cannot
    hold them: the pointer, its floats and the tensor (null, 0, None where
    the plan needs none)."""
    plan = rk4_plan(b, d)
    if plan.kind == "warp" or plan.in_smem:
        return ctypes.c_void_p(0), 0, None
    floats = plan.blocks * K2_BUFFERS * plan.rows * d
    buf = torch.empty(floats, dtype=x.dtype, device=x.device)
    return common.ptr(buf), floats, buf


def _launch_k2(sb3, x, w):
    _check("circulant_rk4_step", x, w)
    b, d = x.shape
    if tuple(sb3.shape) != (b, 3) or sb3.dtype != torch.float32:
        raise ValueError(f"sb3 {tuple(sb3.shape)} {sb3.dtype}: expected "
                         f"float32 {(b, 3)}")
    sb3, x, w = sb3.contiguous(), x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    scratch, floats, _buf = _scratch(b, d, x)
    K2.launch("circulant_rk4_step_f32", common.ptr(sb3), common.ptr(x),
              common.ptr(w), common.ptr(out), scratch, floats, b, d)
    return out


def _launch_solve(x0, z, sb, select_idx, sqrt_delta):
    _check("circulant_rk4_solve", x0, x0)
    b, d = x0.shape
    if z.ndim != 3 or tuple(z.shape[1:]) != (b, d) or z.dtype != x0.dtype:
        raise ValueError(f"z {tuple(z.shape)} {z.dtype}: expected float32 "
                         f"(n, {b}, {d})")
    n = z.shape[0]
    if tuple(sb.shape) != (n, 3) or sb.dtype != torch.float32:
        raise ValueError(f"sb {tuple(sb.shape)} {sb.dtype}: expected "
                         f"float32 {(n, 3)}")
    if tuple(select_idx.shape) != (b,) or select_idx.device != x0.device:
        raise ValueError(f"select_idx {tuple(select_idx.shape)} on "
                         f"{select_idx.device}: expected ({b},) on "
                         f"{x0.device}")
    x0, z, sb = x0.contiguous(), z.contiguous(), sb.contiguous()
    sel = select_idx.to(torch.int64).contiguous()
    out = torch.empty_like(x0)
    scratch, floats, _buf = _scratch(b, d, x0)
    K2_SOLVE.launch("circulant_rk4_solve_select_f32", common.ptr(x0),
                    common.ptr(z), ctypes.c_float(sqrt_delta),
                    common.ptr(sb), common.ptr(sel), common.ptr(out),
                    scratch, floats, b, d, n)
    return out


CircApply = common.kernel_function(
    "CircApply", circ_math, _launch_k1, circ_math_jvp, 3,
    op=common.register_op(
        "circulant_apply", "(Tensor sb, Tensor y, Tensor w) -> Tensor",
        circ_math, _launch_k1, lambda sb, y, w: y.new_empty(y.shape)))
RK4Step = common.kernel_function("RK4Step", rk4_math_fwd, _launch_k2,
                                 rk4_math_jvp, 3)
RK4SolveSelect = common.kernel_function(
    "RK4SolveSelect", rk4_solve_select_math, _launch_solve,
    rk4_solve_select_jvp, 3)


def sqrt_beta_column(sqrt_beta, y):
    """√β as the (B, 1) column K1 takes: from a number, (B,) or (B, 1)."""
    b = y.shape[0]
    if isinstance(sqrt_beta, torch.Tensor):
        return sqrt_beta.to(y.dtype).reshape(-1, 1).expand(b, 1)
    # a fill, not a host-to-device copy
    return torch.full((b, 1), float(sqrt_beta), dtype=y.dtype,
                      device=y.device)


def circulant_apply(sqrt_beta, y, w):
    """(g·w) for the circulant G: sqrt_beta a number, (B,) or (B, 1);
    y, w (B, d). Returns (B, d)."""
    return CircApply.apply(sqrt_beta_column(sqrt_beta, y), y, w)


def circulant_rk4_step(sb3, x, w):
    """One fused RK4 step of the zero-drift circulant flow: sb3 (B, 3) √β
    at the stage times (t, t+δ/2, t+δ); x, w (B, d) the state and the
    Wiener increment. Returns (B, d)."""
    return RK4Step.apply(sb3.to(x.dtype).expand(x.shape[0], 3), x, w)


def circulant_rk4_solve_select(x0, z, sb, select_idx, sqrt_delta):
    """The forward solve of the zero-drift circulant flow with K2 as its
    step, in one launch: x0 (B, d); z (n, B, d) standard normals, step i
    taking the Wiener increment sqrt_delta·z[i] (sqrt_delta a number) and
    √β sb[i] (n, 3) at its stage times; select_idx (B,) integers. Returns
    (B, d): per row b the state after select_idx[b] steps, x0 where it is
    0."""
    return RK4SolveSelect.apply(x0, z, sb.to(x0.dtype), select_idx,
                                float(sqrt_delta))
