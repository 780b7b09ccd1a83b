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
of the plain chain, so here the kernels run in every GroupNorm on CUDA. The
bf16 branch comes with bf16 compute.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sdeflow_tpu_torch.ops.kernels import common

EPS = 1e-5

K5 = common.register(common.Kernel(
    "group_norm_silu", "groupnorm.cu",
    {"group_norm_silu_f32": [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
     + [ctypes.c_int] * 4 + [ctypes.c_void_p],
     "group_norm_silu_plan": [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]},
))
K5B = common.register(common.Kernel(
    "group_norm_silu_bwd", "groupnorm.cu",
    {"group_norm_silu_bwd_f32": [ctypes.c_void_p] * 8
     + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]},
))

# the launch plans' constants in csrc/groupnorm.cu
THREADS = 256       # threads per block
SMALL_MAX = 1024    # floats: the largest slab of the small plan
BLOCK_FLOATS = 4096  # floats per block that the cluster size aims at
MAX_CLUSTER = 8     # blocks per cluster


class Plan(NamedTuple):
    kind: str     # "small", "cluster" or "stream"
    lanes: int    # threads on one part of a slab: lanes of a warp, or a block
    cluster: int  # parts (blocks) per slab
    nv: int       # vectors each thread holds in registers (0: streamed)
    vec: int      # floats per vector: 4 (float4 loads) where S % 4 == 0


def _pow2_at_least(v):
    p = 1
    while p < v:
        p *= 2
    return p


def launch_plan(n, s, aligned=True):
    """The launch plan of K5 and K5b for slabs of n = (C/G)·S floats (the C
    function ``choose`` in csrc/groupnorm.cu): a slab per 8, 16 or 32 lanes
    up to 1,024 floats, a cluster of 2-8 blocks holding it in registers
    above, and the same cluster streaming beyond what its registers hold."""
    vec = 4 if s % 4 == 0 and aligned else 1
    nvec = n // vec
    if n <= SMALL_MAX:
        if vec == 1:
            nv = _pow2_at_least(-(-n // 32))
            return Plan("small", 32, 1, 1 if nv <= 1 else 4 if nv <= 4
                        else 32, 1)
        lanes = 8 if nvec <= 8 else 16 if nvec <= 16 else 32
        return Plan("small", lanes, 1, _pow2_at_least(-(-nvec // lanes)), 4)
    cs = min(MAX_CLUSTER, max(2, _pow2_at_least(-(-n // BLOCK_FLOATS))))
    nv = _pow2_at_least(-(-nvec // (cs * THREADS)))
    if vec == 4 and nv <= 8:
        return Plan("cluster", THREADS, cs, nv, 4)
    if vec == 1 and nv <= 16:
        return Plan("cluster", THREADS, cs, 16, 1)
    return Plan("stream", THREADS, MAX_CLUSTER, 0, vec)


def kernel_plan(n, s, aligned=True):
    """The plan the compiled kernels choose (the C function ``choose``), to
    hold ``launch_plan`` to on a card."""
    out = (ctypes.c_int * 5)()
    K5.lib().group_norm_silu_plan(n, s, int(aligned), out)
    kind, lanes, cluster, nv, vec = out
    return Plan(("small", "cluster", "stream")[kind], lanes, cluster, nv, vec)


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


def gn_math(x, gamma, beta, groups, silu):
    """Plain version. x (B, C, S) channels-first, gamma/beta (C,); float32
    (float64 runs the same math, for the autograd checks)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            "GroupNorm runs in float32 only (bf16: ROADMAP Queue 1 item 8)")
    y, _ = gn_parts(x, gamma, beta, groups)
    return F.silu(y) if silu else y


def gn_math_jvp(x, gamma, beta, groups, silu, dx, dgamma, dbeta):
    """Tangent of ``gn_math`` (None: no tangent; at least one is given);
    the SiLU's is dy·σ(y)·(1 + y·(1 − σ(y)))."""
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
    dγ = Σ g·x̂ and dβ = Σ g over batch and space."""
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


def _checked(x, gamma, beta, groups, *more):
    if any(a.dtype != torch.float32 for a in (x, gamma, beta, *more)):
        raise NotImplementedError(
            "group_norm_silu kernel is float32 only (bf16: ROADMAP Queue 1 "
            "item 8)")
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
    K5.launch("group_norm_silu_f32", common.ptr(x), common.ptr(gamma),
              common.ptr(beta), common.ptr(out), b, c, groups, s, int(silu))
    return out


def _launch_vjp(x, gamma, beta, groups, silu, dy):
    x, gamma, beta, dy = _checked(x, gamma, beta, groups, dy)
    b, c, s = x.shape
    dx = torch.empty_like(x)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx))
    plan = launch_plan(c // groups * s, s, aligned)
    # per-part sums of g·x̂ and g for each channel, summed over B by the
    # entry's second kernel
    scratch = torch.empty(2 * c * b * plan.cluster, dtype=torch.float32,
                          device=x.device)
    K5B.launch("group_norm_silu_bwd_f32", *map(common.ptr, (
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
