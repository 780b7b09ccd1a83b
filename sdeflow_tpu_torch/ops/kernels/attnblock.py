"""K3: the whole AttentionBlock as one CUDA kernel.

GroupNorm (fp32 statistics, eps 1e-5) → qkv projection C→3C → per-head
softmax attention (q and k each scaled by ch^-1/4, heads laid out as
interleaved [q_h k_h v_h] channel slices) → output projection → residual.

Replaces the Pallas kernel ``_attn_block_pallas`` (sdeflow_tpu/ops/pallas/
attnblock.py:75-265). ``fused_attention_block`` launches
``csrc/attnblock.cu`` on a CUDA tensor and runs the plain version
``attn_block_math`` on a CPU tensor (ops/kernels/common.py). The kernel
covers float32, T ≤ 256, heads 1–8 and shapes whose working set fits one
block's shared memory; anything else raises on CUDA (bf16 and T > 256 are
queued in ROADMAP).
"""

from __future__ import annotations

import ctypes
import math

import torch

from sdeflow_tpu_torch.ops.kernels import common
from sdeflow_tpu_torch.ops.kernels.groupnorm import gn_math

_P, _I = ctypes.c_void_p, ctypes.c_int
K3 = common.register(common.Kernel(
    "fused_attention_block", "attnblock.cu",
    {"attn_block_f32": [_P] * 8 + [_I] * 7 + [ctypes.c_float, _P]},
))

MAX_T = 256
MAX_HEADS = 8
_THREADS = 256
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def attn_block_math(x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj, groups,
                    heads=1):
    """Plain version. x (B, T, C); wqkv (C, 3C) and wproj (C, C) as
    (in, out); returns (B, T, C)."""
    h = gn_math(x, gn_scale, gn_bias, groups, False)
    qkv = h @ wqkv + bqkv
    b, t, c = x.shape
    ch = c // heads
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    qkv_h = qkv.reshape(b, t, heads, 3 * ch)
    q, k, v = qkv_h.split(ch, dim=-1)
    w = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
    w = torch.softmax(w, dim=-1)
    out = torch.einsum("bhts,bshc->bthc", w, v).reshape(b, t, c)
    return x + (out @ wproj + bproj)


def smem_bytes(t, c, groups, tq):
    """Dynamic shared memory of one block (must match attnblock.cu):
    h/O (T·C), K (T·(C+1)), V (T·C), a Q chunk (tq·C), one score row per
    warp (8·T), channel sums (C) and group statistics (2·G), all float32."""
    return 4 * (t * c + t * (c + 1) + t * c + tq * c
                + (_THREADS // 32) * t + c + 2 * groups)


def query_chunk(t, c, groups):
    """Rows of Q held at once: all T when they fit, else the largest
    halving of T that does; None if even 8 rows do not fit."""
    tq = t
    while smem_bytes(t, c, groups, tq) > _SMEM_LIMIT:
        if tq <= 8:
            return None
        tq = (tq + 1) // 2
    return tq


def fused_attention_block(x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj,
                          groups, heads=1):
    """x: (B, T, C) -> (B, T, C); the whole 1-8-head AttentionBlock."""
    args = (x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj)
    if not common.use_kernel(*args):
        return attn_block_math(*args, groups, heads)
    b, t, c = x.shape
    if any(a.dtype != torch.float32 for a in args):
        raise NotImplementedError(
            "fused_attention_block kernel is float32 only (bf16: ROADMAP "
            "Queue 2, K3 gaps)")
    if t > MAX_T:
        raise NotImplementedError(
            f"fused_attention_block kernel takes T <= {MAX_T}, got {t} "
            "(ROADMAP Queue 2, K3 gaps)")
    if not 1 <= heads <= MAX_HEADS or c % heads or c % groups:
        raise ValueError(f"C={c} must divide by heads={heads} (1..8) and "
                         f"groups={groups}")
    if (tuple(wqkv.shape), tuple(bqkv.shape), tuple(wproj.shape),
            tuple(bproj.shape), tuple(gn_scale.shape),
            tuple(gn_bias.shape)) != ((c, 3 * c), (3 * c,), (c, c), (c,),
                                      (c,), (c,)):
        raise ValueError("weight shapes do not match C")
    tq = query_chunk(t, c, groups)
    if tq is None:
        raise NotImplementedError(
            f"(T={t}, C={c}) does not fit one block's shared memory "
            "(ROADMAP Queue 2, K3 gaps)")
    x = x.contiguous()
    out = torch.empty_like(x)
    ws = [a.contiguous() for a in args[1:]]
    K3.launch("attn_block_f32", common.ptr(x), *map(common.ptr, ws),
              common.ptr(out), b, t, c, groups, heads, tq,
              smem_bytes(t, c, groups, tq),
              1.0 / math.sqrt(math.sqrt(c // heads)))
    return out
