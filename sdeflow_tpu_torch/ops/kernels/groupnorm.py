"""K5: GroupNorm (+SiLU) as a CUDA kernel, channels-first.

Port of ``group_norm_silu`` (sdeflow_tpu/ops/pallas/groupnorm.py:139-151):
statistics per (sample, group) in fp32, eps 1e-5, two-pass variance, then
the affine and, if asked, SiLU. The JAX package takes channels-last
(B, S, C); the port's U-Net is channels-first, so here x is (B, C, S) and
one (sample, group) is one contiguous slab. ``group_norm_silu`` goes
through its ``torch.autograd.Function`` (ops/kernels/common.py): it
launches ``csrc/groupnorm.cu`` (replacing ``_gn_pallas`` :111-136) on CUDA
tensors and runs the plain version ``gn_math`` (the fp32 branch of
``_gn_math`` :36-75) on CPU tensors; forward mode goes through the closed
form ``gn_math_jvp``. The JAX package runs its kernel only under
``SDEFLOW_PALLAS_NN=1``, because on the TPU XLA's fusion of the plain chain
matched it; eager PyTorch launches each operator of the plain chain, so
here the kernel runs in every GroupNorm on CUDA. The bf16 branch comes with
bf16 compute.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sdeflow_tpu_torch.ops.kernels import common

EPS = 1e-5

K5 = common.register(common.Kernel(
    "group_norm_silu", "groupnorm.cu",
    {"group_norm_silu_f32": [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
     + [ctypes.c_int] * 4 + [ctypes.c_void_p]},
))


def gn_parts(x, gamma, beta, groups, dx=None, dgamma=None, dbeta=None):
    """The affine GroupNorm y = x̂·γ + β of x (B, C, S) (before any SiLU)
    and its tangent, in closed form, for the tangents given (None where
    no input has one): dx̂ = rstd·(dx_c − x̂·mean(x̂·dx_c)) over each
    group."""
    b, c, s = x.shape
    xg = x.reshape(b, groups, -1)
    xc = xg - xg.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc**2).mean(dim=-1, keepdim=True) + EPS)
    xhat = xc * rstd
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


def _launch(x, gamma, beta, groups, silu):
    if any(a.dtype != torch.float32 for a in (x, gamma, beta)):
        raise NotImplementedError(
            "group_norm_silu kernel is float32 only (bf16: ROADMAP Queue 1 "
            "item 8)")
    b, c, s = x.shape
    if c % groups or tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"C={c} must divide by groups={groups}; gamma and "
                         "beta must be (C,)")
    x, gamma, beta = x.contiguous(), gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x)
    K5.launch("group_norm_silu_f32", common.ptr(x), common.ptr(gamma),
              common.ptr(beta), common.ptr(out), b, c, groups, s, int(silu))
    return out


GroupNormSiLU = common.kernel_function("GroupNormSiLU", gn_math, _launch,
                                       gn_math_jvp, 3)


def group_norm_silu(x, gamma, beta, groups, silu):
    """x (B, C, S) -> (B, C, S): GroupNorm over `groups` groups, then SiLU
    if `silu`."""
    return GroupNormSiLU.apply(x, gamma, beta, groups, silu)
