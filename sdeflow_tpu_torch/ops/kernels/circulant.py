"""K1: the circulant-G diffusion stencil as a CUDA kernel.

Replaces the Pallas kernel ``_circ_pallas`` (sdeflow_tpu/ops/pallas/
circulant.py:35-75). ``circulant_apply`` launches ``csrc/circulant.cu`` on a
CUDA tensor and runs the plain version ``circ_math`` on a CPU tensor (see
ops/kernels/common.py for the dispatch rule). Unlike the JAX entry point,
which keeps the kernel for d ≥ 128, the CUDA kernel takes any B and d.
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


# plain version, c·(roll(√β·y, −1)·w − roll(√β·y·w, +1)): the roll stencil
circ_math = circulant_sigma_apply


def circulant_apply(sqrt_beta, y, w):
    """(g·w) for the circulant G: sqrt_beta a number, (B,) or (B, 1);
    y, w (B, d). Returns (B, d)."""
    b, d = y.shape
    if isinstance(sqrt_beta, torch.Tensor):
        sb = sqrt_beta.to(y.dtype).reshape(-1, 1).expand(b, 1)
    else:  # a fill, not a host-to-device copy
        sb = torch.full((b, 1), float(sqrt_beta), dtype=y.dtype,
                        device=y.device)
    if not common.use_kernel(sb, y, w):
        return circ_math(sb, y, w)
    if y.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("circulant_apply kernel takes float32 y and w")
    if w.shape != y.shape:
        raise ValueError(f"w {tuple(w.shape)} != y {tuple(y.shape)}")
    sb = sb.contiguous()
    y, w = y.contiguous(), w.contiguous()
    out = torch.empty_like(y)
    K1.launch("circulant_apply_f32", common.ptr(sb), common.ptr(y),
              common.ptr(w), common.ptr(out), b, d)
    return out
