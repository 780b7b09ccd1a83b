"""K5 and K5b: GroupNorm (+SiLU) and its backward as CUDA kernels,
channels-first.

Port of ``group_norm_silu`` (sdeflow_tpu/ops/pallas/groupnorm.py:139-151):
statistics per (sample, group) in fp32, eps 1e-5, two-pass variance, then
the affine and, if asked, SiLU. The JAX package takes channels-last
(B, S, C); the port's U-Net is channels-first, so here x is (B, C, S) and
one (sample, group) is one contiguous slab. ``group_norm_silu`` goes
through its ``torch.autograd.Function`` (ops/kernels/common.py): on CUDA
tensors its forward launches K5 (``csrc/groupnorm.cu``
``group_norm_silu_f32``, replacing ``_gn_pallas`` :111-136) and its
backward with grad mode off launches K5b (``group_norm_silu_bwd_f32``:
dx, dγ and dβ in one pass over x and dy; the JAX package has no kernel for
it, XLA fuses the transpose of the ``custom_jvp`` rule :147-151). On CPU
tensors they run the plain versions ``gn_math`` (the fp32 branch of
``_gn_math`` :36-75) and ``gn_math_vjp`` (its vector-Jacobian product in
closed form). Forward mode goes through the closed form ``gn_math_jvp``,
and a backward with grad mode on (a second reverse pass) through
``torch.func.vjp`` of ``gn_math``. ``launch_plan`` is the Python mirror of
the kernels' launch plan (the C function ``choose``). The JAX package runs
its kernel only under ``SDEFLOW_PALLAS_NN=1``, because on the TPU XLA's
fusion of the plain chain matched it; eager PyTorch launches each operator
of the plain chain, so here the kernels run in every GroupNorm on CUDA.

bf16 x (the score net's bf16 compute; gamma and beta stay fp32) takes the
JAX package's sub-fp32 branch (:64-75): channel sums first, statistics in
fp32, then scale = bf16(rstd·γ) and shift = bf16(β − mean·rstd·γ), one
multiply and one add in bf16, SiLU in bf16, the output in x's dtype; the
kernels' bf16 symbols (``group_norm_silu_bf16``,
``group_norm_silu_bwd_bf16``) round where that plain version rounds. The
tangent and the vjp of the bf16 branch are the fp32 closed forms evaluated
on the widened inputs, their result rounded to x's dtype (dγ and dβ fp32).
K5 and K5b in bf16 run on plans of their own (``fwd_bf16_plan``,
``bwd_bf16_plan``: ``bf16_plan`` with a block of 32 KB and of 16 KB of
x); K5b's takes one part a slab, so its dγ/dβ scratch is (2, C, B).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sdeflow_tpu_torch.ops.kernels import common

EPS = 1e-5

_FWD_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
K5 = common.register(common.Kernel(
    "group_norm_silu", "groupnorm.cu",
    {"group_norm_silu_f32": _FWD_ARGS, "group_norm_silu_bf16": _FWD_ARGS,
     "group_norm_silu_plan": [ctypes.c_longlong] + [ctypes.c_int] * 3
     + [ctypes.c_void_p],
     "group_norm_silu_bf16_plan": [ctypes.c_longlong] + [ctypes.c_int] * 2
     + [ctypes.c_void_p]},
))
K5B = common.register(common.Kernel(
    "group_norm_silu_bwd", "groupnorm.cu",
    {"group_norm_silu_bwd_f32": _BWD_ARGS,
     "group_norm_silu_bwd_bf16": _BWD_ARGS,
     "group_norm_silu_bwd_bf16_plan": [ctypes.c_longlong] + [ctypes.c_int] * 2
     + [ctypes.c_void_p]},
))

# the launch plans' constants in csrc/groupnorm.cu
THREADS = 256       # threads per block
SMALL_MAX = 1024    # floats: the largest slab of the small plan
BLOCK_FLOATS = 4096  # floats per block that the cluster size aims at
MAX_CLUSTER = 8     # blocks per cluster
# the bf16 plans (choose_bf16), in elements: the small plan's largest slab,
# what a block of K5b holds with 16-byte loads (4 vectors of 8 a thread:
# 16 KB of x, an fp32 block's bytes) and without (16 a thread), and what a
# block of K5 holds (8 vectors of 8 a thread: 32 KB of x)
BF16_SMALL_MAX, BF16_BLOCK_ELEMS, BF16_SCALAR_ELEMS = 1024, 8192, 4096
BF16_FWD_BLOCK_ELEMS = 16384


class Plan(NamedTuple):
    kind: str     # "small", "cluster" or "stream"
    lanes: int    # threads on one part of a slab: lanes of a warp, or a block
    cluster: int  # parts (blocks) per slab
    nv: int       # vectors each thread holds in registers (0: streamed)
    vec: int      # elements per vector: 4 fp32 or 8 bf16 (16-byte loads)
    #               where S is a multiple of that, else 1


def _pow2_at_least(v):
    p = 1
    while p < v:
        p *= 2
    return p


def vector_width(dtype):
    """Elements of one 16-byte load: 4 in fp32, 8 in bf16."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def launch_plan(n, s, aligned=True, width=4):
    """The launch plan of K5 and K5b for slabs of n = (C/G)·S elements of
    `width` per 16-byte vector (the C function ``choose`` in
    csrc/groupnorm.cu): a slab per 8, 16 or 32 lanes up to 1,024 elements,
    a cluster of 2-8 blocks holding it in registers above (at most 32
    floats a thread), and the same cluster streaming beyond."""
    vec = width if s % width == 0 and aligned else 1
    nvec = n // vec
    if n <= SMALL_MAX:
        if vec == 1:
            nv = _pow2_at_least(-(-n // 32))
            return Plan("small", 32, 1, 1 if nv <= 1 else 4 if nv <= 4
                        else 32, 1)
        lanes = 8 if nvec <= 8 else 16 if nvec <= 16 else 32
        return Plan("small", lanes, 1, _pow2_at_least(-(-nvec // lanes)),
                    vec)
    cs = min(MAX_CLUSTER, max(2, _pow2_at_least(-(-n // BLOCK_FLOATS))))
    nv = _pow2_at_least(-(-nvec // (cs * THREADS)))
    if vec > 1 and nv * vec <= 32:
        return Plan("cluster", THREADS, cs, nv, vec)
    if vec == 1 and nv <= 16:
        return Plan("cluster", THREADS, cs, 16, 1)
    return Plan("stream", THREADS, MAX_CLUSTER, 0, vec)


def bf16_plan(n, s, aligned, block_elems):
    """The bf16 kernels' plan (the C function ``choose_bf16``), sized in
    bytes: up to 1,024 elements 8, 16 or 32 lanes of a warp a slab; above,
    one block of 256 threads holding `block_elems` elements in registers,
    a cluster of blocks only past that, and the fp32 plan's stream kernel
    beyond 8 blocks. Without 16-byte loads (S % 8 ≠ 0 or a misaligned
    tensor) one element a vector: 32 lanes up to 1,024, 16 elements a
    thread of a cluster block above, streaming beyond."""
    vec = 8 if s % 8 == 0 and aligned else 1
    nvec = n // vec
    if n <= BF16_SMALL_MAX:
        if vec == 1:
            nv = _pow2_at_least(-(-n // 32))
            return Plan("small", 32, 1, 1 if nv <= 1 else 4 if nv <= 4
                        else 32, 1)
        lanes = 8 if nvec <= 8 else 16 if nvec <= 16 else 32
        return Plan("small", lanes, 1, _pow2_at_least(-(-nvec // lanes)), 8)
    cap = (block_elems // THREADS // 8 if vec == 8
           else BF16_SCALAR_ELEMS // THREADS)  # vectors a thread
    cs = min(MAX_CLUSTER, _pow2_at_least(-(-nvec // (THREADS * cap))))
    nv = _pow2_at_least(-(-nvec // (cs * THREADS)))
    if nv <= cap:
        return Plan("cluster", THREADS, cs, nv if vec == 8 else cap, vec)
    return Plan("stream", THREADS, MAX_CLUSTER, 0, vec)


def bwd_bf16_plan(n, s, aligned=True):
    """K5b bf16's plan (``choose_bwd_bf16``): a block holds 8,192 elements
    (16 KB of x, the bytes of an fp32 block's 4,096 floats; 4 vectors of 8
    a thread, which also keeps g = dL/dh in fp32 registers), so a slab takes
    one block up to 8,192 elements and a cluster only above (2 blocks at
    16,384, 8 at 49,152)."""
    return bf16_plan(n, s, aligned, BF16_BLOCK_ELEMS)


def fwd_bf16_plan(n, s, aligned=True):
    """K5 bf16's plan (``choose_fwd_bf16``): a block holds 16,384 elements
    (32 KB of x as its bits, 8 vectors of 8 a thread), so a slab takes one
    block up to 16,384 elements and a cluster only above (2 blocks at
    32,768, 4 at 49,152)."""
    return bf16_plan(n, s, aligned, BF16_FWD_BLOCK_ELEMS)


def _plan_of(out):
    kind, lanes, cluster, nv, vec = out
    return Plan(("small", "cluster", "stream")[kind], lanes, cluster, nv, vec)


def kernel_plan(n, s, aligned=True, width=4):
    """The plan the compiled kernels choose (the C function ``choose``), to
    hold ``launch_plan`` to on a card."""
    out = (ctypes.c_int * 5)()
    K5.lib().group_norm_silu_plan(n, s, int(aligned), width, out)
    return _plan_of(out)


def kernel_fwd_bf16_plan(n, s, aligned=True):
    """K5 bf16's compiled plan (``choose_fwd_bf16``), to hold
    ``fwd_bf16_plan`` to on a card."""
    out = (ctypes.c_int * 5)()
    K5.lib().group_norm_silu_bf16_plan(n, s, int(aligned), out)
    return _plan_of(out)


def kernel_bwd_bf16_plan(n, s, aligned=True):
    """K5b bf16's compiled plan (``choose_bwd_bf16``), to hold
    ``bwd_bf16_plan`` to on a card."""
    out = (ctypes.c_int * 5)()
    K5B.lib().group_norm_silu_bwd_bf16_plan(n, s, int(aligned), out)
    return _plan_of(out)


def _normalized(x, groups):
    """x̂ (B, groups, n) of x (B, C, S), and rstd (B, groups, 1)."""
    b = x.shape[0]
    xg = x.reshape(b, groups, -1)
    xc = xg - xg.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc**2).mean(dim=-1, keepdim=True) + EPS)
    return xc * rstd, rstd


def gn_parts(x, gamma, beta, groups, dx=None, dgamma=None, dbeta=None):
    """The affine GroupNorm y = x̂·γ + β of x (B, C, S) (before any SiLU)
    and its tangent, in closed form, for the tangents given (None where
    no input has one): dx̂ = rstd·(dx_c − x̂·mean(x̂·dx_c)) over each
    group."""
    b, c, s = x.shape
    xhat, rstd = _normalized(x, groups)
    y = xhat.reshape(b, c, s) * gamma[:, None] + beta[:, None]
    dy = None
    if dx is not None:
        dxg = dx.reshape(b, groups, -1)
        dxc = dxg - dxg.mean(dim=-1, keepdim=True)
        dxhat = rstd * (dxc - xhat * (xhat * dxc).mean(dim=-1, keepdim=True))
        dy = dxhat.reshape(b, c, s) * gamma[:, None]
    if dgamma is not None:
        dy = common.add(dy, xhat.reshape(b, c, s) * dgamma[:, None])
    if dbeta is not None:
        dy = common.add(dy, dbeta[:, None])
    return y, (None if dy is None else dy.expand(b, c, s))


def _gn_bf16(x, gamma, beta, groups, silu):
    """The sub-fp32 branch of ``_gn_math`` (ops/pallas/groupnorm.py:64-75)
    on x (B, C, S) channels-first: statistics in fp32 from channel sums,
    scale and shift rounded to x's dtype, then x·scale + shift and the
    SiLU h·σ(h) in that dtype."""
    b, c, s = x.shape
    cg = c // groups
    n = s * cg
    xf = x.float()
    mean = xf.sum(dim=-1).reshape(b, groups, cg).sum(dim=-1) / n
    mean_c = mean.repeat_interleave(cg, dim=1)  # (B, C)
    xc = xf - mean_c[:, :, None]
    var = (xc * xc).sum(dim=-1).reshape(b, groups, cg).sum(dim=-1) / n
    rstd_c = torch.rsqrt(var + EPS).repeat_interleave(cg, dim=1)
    a = rstd_c * gamma
    scale = a.to(x.dtype)[:, :, None]
    shift = (beta - mean_c * a).to(x.dtype)[:, :, None]
    h = x * scale + shift
    return h * torch.sigmoid(h) if silu else h


def gn_math(x, gamma, beta, groups, silu):
    """Plain version. x (B, C, S) channels-first, gamma/beta (C,); float32
    (float64 runs the same math, for the autograd checks), or bfloat16 x
    with float32 gamma and beta (``_gn_bf16``)."""
    if x.dtype == torch.bfloat16:
        if gamma.dtype != torch.float32 or beta.dtype != torch.float32:
            raise NotImplementedError(
                "bf16 GroupNorm takes float32 gamma and beta (a bf16 "
                "compute dtype keeps the parameters fp32)")
        return _gn_bf16(x, gamma, beta, groups, silu)
    if x.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"GroupNorm runs in float32 or bfloat16, not {x.dtype}")
    y, _ = gn_parts(x, gamma, beta, groups)
    return F.silu(y) if silu else y


def gn_math_jvp(x, gamma, beta, groups, silu, dx, dgamma, dbeta):
    """Tangent of ``gn_math`` (None: no tangent; at least one is given);
    the SiLU's is dy·σ(y)·(1 + y·(1 − σ(y))). For bf16 x, the fp32 closed
    form on the widened x and dx, rounded to bf16."""
    if x.dtype == torch.bfloat16:
        return gn_math_jvp(x.float(), gamma, beta, groups, silu,
                           None if dx is None else dx.float(), dgamma,
                           dbeta).to(x.dtype)
    y, dy = gn_parts(x, gamma, beta, groups, dx, dgamma, dbeta)
    if silu:
        sig = torch.sigmoid(y)
        dy = dy * sig * (1.0 + y * (1.0 - sig))
    return dy.contiguous()


def gn_math_vjp(x, gamma, beta, groups, silu, dy):
    """Vector-Jacobian product of ``gn_math`` in closed form (the plain
    version of K5b): (dx, dγ, dβ) for the cotangent dy, with
    g = dy·σ(h)·(1 + h·(1 − σ(h))) under SiLU (else dy), d = g·γ,
    dx = rstd·(d − mean(d) − x̂·mean(d·x̂)) over each group,
    dγ = Σ g·x̂ and dβ = Σ g over batch and space. For bf16 x and dy, the
    fp32 closed form on the widened inputs, dx rounded to bf16 and dγ, dβ
    fp32."""
    if x.dtype == torch.bfloat16:
        dx, dgamma, dbeta = gn_math_vjp(x.float(), gamma, beta, groups,
                                        silu, dy.float())
        return dx.to(x.dtype), dgamma, dbeta
    b, c, s = x.shape
    xhat, rstd = _normalized(x, groups)
    xc = xhat.reshape(b, c, s)
    g = dy
    if silu:
        h = xc * gamma[:, None] + beta[:, None]
        sig = torch.sigmoid(h)
        g = dy * sig * (1.0 + h * (1.0 - sig))
    d = (g * gamma[:, None]).reshape(b, groups, -1)
    dx = rstd * (d - d.mean(dim=-1, keepdim=True)
                 - xhat * (d * xhat).mean(dim=-1, keepdim=True))
    return dx.reshape(b, c, s), (g * xc).sum(dim=(0, 2)), g.sum(dim=(0, 2))


_SYMBOL = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _checked(x, gamma, beta, groups, *more):
    if (x.dtype not in _SYMBOL or gamma.dtype != torch.float32
            or beta.dtype != torch.float32
            or any(a.dtype != x.dtype for a in more)):
        raise NotImplementedError(
            "group_norm_silu kernel takes float32 or bfloat16 x (and dy) "
            f"with float32 gamma and beta, got {x.dtype}, {gamma.dtype}, "
            f"{beta.dtype}")
    c = x.shape[1]
    if c % groups or tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"C={c} must divide by groups={groups}; gamma and "
                         "beta must be (C,)")
    if any(a.shape != x.shape for a in more):
        raise ValueError("dy must have x's shape")
    return [a.contiguous() for a in (x, gamma, beta, *more)]


def _launch(x, gamma, beta, groups, silu):
    x, gamma, beta = _checked(x, gamma, beta, groups)
    b, c, s = x.shape
    out = torch.empty_like(x)
    K5.launch(f"group_norm_silu_{_SYMBOL[x.dtype]}", common.ptr(x),
              common.ptr(gamma),
              common.ptr(beta), common.ptr(out), b, c, groups, s, int(silu))
    return out


def _launch_vjp(x, gamma, beta, groups, silu, dy):
    x, gamma, beta, dy = _checked(x, gamma, beta, groups, dy)
    b, c, s = x.shape
    dx = torch.empty_like(x)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx))
    # per-part sums of g·x̂ and g for each channel, summed over B by the
    # entry's second kernel: one part a slab on bf16's own plan unless it
    # streams
    n = c // groups * s
    if x.dtype == torch.bfloat16:
        plan = bwd_bf16_plan(n, s, aligned)
        parts = plan.cluster if plan.kind == "stream" else 1
    else:
        parts = launch_plan(n, s, aligned, vector_width(x.dtype)).cluster
    scratch = torch.empty(2 * c * b * parts, dtype=torch.float32,
                          device=x.device)
    K5B.launch(f"group_norm_silu_bwd_{_SYMBOL[x.dtype]}", *map(common.ptr, (
        x, gamma, beta, dy, dx, dgamma, dbeta, scratch)), scratch.numel(),
        b, c, groups, s, int(silu))
    return dx, dgamma, dbeta


GroupNormSiLU = common.kernel_function("GroupNormSiLU", gn_math, _launch,
                                       gn_math_jvp, 3,
                                       vjp=(gn_math_vjp, _launch_vjp))


def group_norm_silu(x, gamma, beta, groups, silu):
    """x (B, C, S) -> (B, C, S): GroupNorm over `groups` groups, then SiLU
    if `silu`."""
    return GroupNormSiLU.apply(x, gamma, beta, groups, silu)
