"""K1 and K2: the circulant-G diffusion stencil and the fused zero-drift
RK4 forward step, as CUDA kernels.

K1 replaces the Pallas kernel ``_circ_pallas`` (sdeflow_tpu/ops/pallas/
circulant.py:35-75), K2 replaces ``_rk4_pallas`` (:98-146). Both wrappers,
``circulant_apply`` and ``circulant_rk4_step``, go through their
``torch.autograd.Function``: the kernel (``csrc/circulant.cu``,
``csrc/rk4.cu``) on CUDA tensors, the plain versions ``circ_math`` and
``rk4_math_fwd`` on CPU tensors, and the plain versions' derivatives in
every case (ops/kernels/common.py): their closed-form tangents
``circ_math_jvp`` and ``rk4_math_jvp`` for forward mode. Unlike the JAX entry points, which keep
the Pallas kernels for d ≥ 128, the CUDA kernels take any B and d.
"""

from __future__ import annotations

import ctypes

import torch

from sdeflow_tpu_torch.ops.gapply import circulant_sigma_apply
from sdeflow_tpu_torch.ops.kernels import common

_P, _I = ctypes.c_void_p, ctypes.c_longlong
K1 = common.register(common.Kernel(
    "circulant_apply", "circulant.cu",
    {"circulant_apply_f32": [_P, _P, _P, _P, _I, _I, _P]},
))
K2 = common.register(common.Kernel(
    "circulant_rk4_step", "rk4.cu",
    {"circulant_rk4_step_f32": [_P, _P, _P, _P, _P, _I, _I, _I,
                                ctypes.c_int, _P]},
))

_THREADS = 256  # threads of one K2 block (must match rk4.cu)
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use

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


def rk4_layout(b, d):
    """K2's launch layout: rows per block (whole rows, several when
    d < 256), the blocks, and whether the two stage buffers (2·rows·d
    floats) fit shared memory; if not they live in a global scratch."""
    rows = max(1, _THREADS // d) if d else 1
    blocks = -(-b // rows)
    return rows, blocks, 8 * rows * d <= _SMEM_LIMIT


def _launch_k2(sb3, x, w):
    _check("circulant_rk4_step", x, w)
    b, d = x.shape
    if tuple(sb3.shape) != (b, 3) or sb3.dtype != torch.float32:
        raise ValueError(f"sb3 {tuple(sb3.shape)} {sb3.dtype}: expected "
                         f"float32 {(b, 3)}")
    sb3, x, w = sb3.contiguous(), x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    rows, blocks, in_smem = rk4_layout(b, d)
    scratch = (None if in_smem else
               torch.empty(blocks * 2 * rows * d, dtype=x.dtype,
                           device=x.device))
    K2.launch("circulant_rk4_step_f32", common.ptr(sb3), common.ptr(x),
              common.ptr(w), common.ptr(out),
              ctypes.c_void_p(0 if scratch is None else scratch.data_ptr()),
              b, d, rows, int(in_smem))
    return out


CircApply = common.kernel_function("CircApply", circ_math, _launch_k1,
                                   circ_math_jvp, 3)
RK4Step = common.kernel_function("RK4Step", rk4_math_fwd, _launch_k2,
                                 rk4_math_jvp, 3)


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
