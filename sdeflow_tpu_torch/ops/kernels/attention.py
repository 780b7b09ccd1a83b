"""K6 and K4: the attention core as one CUDA kernel.

qkv (B, T, 3C) -> (B, T, C): per head, softmax attention with q and k each
scaled by ch^-1/4 and the softmax in fp32; head h owns the interleaved
channel slice [q_h k_h v_h] of width 3·ch of each row. Port of
``qkv_attention`` (sdeflow_tpu/ops/pallas/attention.py:258-288).
``qkv_attention`` goes through its ``torch.autograd.Function``
(ops/kernels/common.py): it launches ``csrc/attention.cu`` on CUDA tensors
and runs the plain version ``attention_math`` (``_attention_math`` :35-51)
on CPU tensors; forward mode goes through the closed form
``attention_jvp``. The one kernel replaces both TPU kernels: the
single-block ``_attention_pallas`` (:225-255, K6, T ≤ 1024; opt-in there
under ``SDEFLOW_PALLAS_NN=1``) and the flash-tiled ``_attention_flash``
(:201-222, K4, T > 1024). Here it runs at every T on CUDA (no gate: eager
PyTorch does not fuse the plain chain as XLA does). Float32 and head widths
up to 128; anything else raises on CUDA.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sdeflow_tpu_torch.ops.kernels import common

_P, _I = ctypes.c_void_p, ctypes.c_int
K6 = common.register(common.Kernel(
    "qkv_attention", "attention.cu",
    {"qkv_attention_f32": [_P, _P, ctypes.c_longlong] + [_I] * 4
     + [ctypes.c_float, _P]},
))

MAX_HEAD_WIDTH = 128
_TQ, _TK, _WARPS, _ROWS_PER_WARP = 32, 32, 8, 4  # must match attention.cu


def _split(qkv, num_heads):
    b, t, c3 = qkv.shape
    ch = c3 // 3 // num_heads
    return qkv.reshape(b, t, num_heads, 3 * ch).split(ch, dim=-1)


def _scale(qkv, num_heads):
    return 1.0 / math.sqrt(math.sqrt(qkv.shape[-1] // 3 // num_heads))


def attention_math(qkv, num_heads):
    """Plain version; float32 (float64 runs the same math, for the autograd
    checks)."""
    if qkv.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            "attention runs in float32 only (bf16: ROADMAP Queue 1 item 8)")
    b, t, c3 = qkv.shape
    q, k, v = _split(qkv, num_heads)
    scale = _scale(qkv, num_heads)
    w = torch.softmax(torch.einsum("bthc,bshc->bhts", q * scale, k * scale),
                      dim=-1)
    return torch.einsum("bhts,bshc->bthc", w, v).reshape(b, t, c3 // 3)


def attention_jvp(qkv, num_heads, dqkv):
    """Tangent of ``attention_math`` in closed form, through the scores,
    the softmax (dp = p·(ds − Σ p·ds)) and P·V."""
    b, t, c3 = qkv.shape
    q, k, v = _split(qkv, num_heads)
    dq, dk, dv = _split(dqkv.expand(b, t, c3), num_heads)
    scale = _scale(qkv, num_heads)
    qs, ks = q * scale, k * scale
    p = torch.softmax(torch.einsum("bthc,bshc->bhts", qs, ks), dim=-1)
    ds = (torch.einsum("bthc,bshc->bhts", dq * scale, ks)
          + torch.einsum("bthc,bshc->bhts", qs, dk * scale))
    dp = p * (ds - (p * ds).sum(dim=-1, keepdim=True))
    return (torch.einsum("bhts,bshc->bthc", dp, v)
            + torch.einsum("bhts,bshc->bthc", p, dv)).reshape(b, t, c3 // 3)


def smem_bytes(ch):
    """Dynamic shared memory of one block (must match attention.cu): the
    Q rows (32·ch), the K tile padded to ch+1, the V tile and one row of
    probabilities per (warp, query row), float32."""
    return 4 * (_TQ * ch + _TK * (ch + 1) + _TK * ch
                + _WARPS * _ROWS_PER_WARP * _TK)


def _launch(qkv, num_heads):
    if qkv.dtype != torch.float32:
        raise NotImplementedError(
            "qkv_attention kernel is float32 only (bf16: ROADMAP Queue 1 "
            "item 8)")
    b, t, c3 = qkv.shape
    if c3 % 3 or (c3 // 3) % num_heads:
        raise ValueError(f"3C={c3} must be 3·heads·ch for heads={num_heads}")
    ch = c3 // 3 // num_heads
    if ch > MAX_HEAD_WIDTH:
        raise NotImplementedError(
            f"qkv_attention kernel takes head widths up to {MAX_HEAD_WIDTH}, "
            f"got {ch}")
    qkv = qkv.contiguous()
    out = qkv.new_empty(b, t, c3 // 3)
    K6.launch("qkv_attention_f32", common.ptr(qkv), common.ptr(out), b, t,
              num_heads, ch, smem_bytes(ch), _scale(qkv, num_heads))
    return out


QKVAttention = common.kernel_function("QKVAttention", attention_math,
                                      _launch, attention_jvp, 1)


def qkv_attention(qkv, num_heads=1):
    """qkv (B, T, 3C) -> (B, T, C), any T."""
    return QKVAttention.apply(qkv, num_heads)


# The AttentionBlock's entry point (attention.py:491-502). The JAX package
# sends reverse mode at T > 1024 to the flash pair K7a/K7b under
# SDEFLOW_FLASH_VJP=1; that pair is ROADMAP Queue 2's next slice.
attention_core = qkv_attention
