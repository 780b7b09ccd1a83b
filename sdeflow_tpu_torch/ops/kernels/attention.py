"""K6, K4, K7a and K7b: the attention core as CUDA kernels.

qkv (B, T, 3C) -> (B, T, C): per head, softmax attention with q and k each
scaled by ch^-1/4 and the softmax in fp32; head h owns the interleaved
channel slice [q_h k_h v_h] of width 3·ch of each row. Port of
sdeflow_tpu/ops/pallas/attention.py.

- ``qkv_attention`` (:258-288) goes through its ``torch.autograd.Function``
  (ops/kernels/common.py), whose forward is the operator
  ``sdeflow::qkv_attention``: on CUDA tensors it launches ``csrc/attention.cu``
  (K6, the single-block ``_attention_pallas`` :225-255, T ≤ 1024; opt-in
  there under ``SDEFLOW_PALLAS_NN=1``; on the tensor cores in 3xTF32, each
  (sample, head) whole in shared memory up to T = 64 and flash_fwd.cuh's
  tiles above; bf16 on bf16 tensor cores) or, above T = 1024,
  ``csrc/flash_fwd.cu`` (K4, the flash-tiled ``_attention_flash``
  :201-222, on the tensor cores in 3xTF32); on CPU tensors it runs the
  plain version ``attention_reference`` (:106-112). Its rules
  differentiate the plain math (to any order, ops/kernels/common.py), as
  the JAX ``custom_jvp`` differentiates
  ``_attention_reference`` (:279-288): at
  T ≤ 1024 the (T, T) ``attention_math`` (tangent ``attention_jvp``); above
  it the tiled ``attention_flash_math`` (:54-103), whose key tiles are
  checkpointed so that a gradient holds O(T·512) per head, and the tiled
  closed-form tangent ``attention_flash_jvp``.
- ``flash_attention_vjp`` (:455-488) goes through the Function
  ``FlashAttention``: its forward is ``csrc/flash_fwd.cu``'s second entry,
  K7a (``_attention_flash_stats`` :344-368), which also writes the per-row
  log-sum-exp of the scaled scores; its backward is ``csrc/attention_bwd.cu``,
  K7b (``_attention_flash_bwd`` :436-452), from the saved lse and
  Δ = rowsum(dO∘O): in float32 one pass whose dQ sums arrive by atomics
  (so two runs agree to rounding, not bit for bit), in bf16 a dK/dV kernel
  and a dQ kernel, each sum with one writer (two runs agree bit for bit);
  its jvp is ``attention_flash_jvp``. K6, K4,
  K7a and K7b form every product on the tensor cores in 3xTF32 (fp32 split
  into two TF32 halves, three products), close enough to fp32 that the
  tolerances against the plain fp32 versions stand; their bf16 entries
  take bf16 operands on the tensor cores (below), all on wgmma (K6 up to
  T = 64 by ``short_bf16_plan``'s persistent tiles). On CPU tensors the
  plain versions ``attention_flash_stats_math`` and
  ``attention_flash_bwd_math`` run.
- ``attention_core`` (:491-502), the AttentionBlock's entry point, sends
  T > 1024 with T % 512 == 0 to the pair when autograd records the call,
  and everything else to ``qkv_attention``. The JAX package chooses by the
  flag ``SDEFLOW_FLASH_VJP`` because on the TPU XLA's fusion of the tiled
  math beat the pair and because its ``custom_vjp`` cannot run forward mode.
  Here the rule follows what the call needs: a forward that nothing
  differentiates (serving, the Trainer's ELBO print) needs no lse and keeps
  K4; a call that autograd records will run a backward, which K7b computes
  from K7a's lse in O(T) memory. ``FlashAttention`` also has a forward-mode
  rule, so the pair serves the SSM loss's JVP under autograd as well (the
  JAX package raises there with the flag on and runs the tiled math with it
  off; the port gives the flag-off numbers). Inside ``torch.func.jvp`` a
  tensor's ``requires_grad`` reads False even when autograd records the
  tensor it wraps, so the rule looks through the wrapper.

Float32 (float64 in the plain versions, for the autograd checks) or
bfloat16, head widths up to 128; anything else raises on CUDA. In bf16 the
plain versions keep the JAX math versions' semantics
(``_attention_math`` :35-51, ``_attention_flash_math`` :54-103): the scale
rounded to bf16 so that q·s and k·s stay bf16, the scores, the softmax
statistics and P·V's sums in fp32, the weights cast to bf16 for P·V (the
normalised softmax up to T = 1024, the tiles' unnormalised exp(s − m)
above it), the output rounded to bf16 once, lse fp32; the plain K7a
(``attention_flash_stats_math``) keeps its kernel body's instead, since
K7b and its plain version recompute p and Δ from its O and lse. The tangents
(``attention_jvp``, ``attention_flash_jvp``) and K7b's plain version
(``attention_flash_bwd_math``) evaluate their fp32 forms on the widened
bf16 inputs and round once, as K7b's body does (:383-433). The kernels'
bf16 entries (``qkv_attention_bf16``, ``qkv_attention_flash_bf16``,
``qkv_attention_stats_bf16``, ``qkv_attention_bwd_bf16``) keep the JAX
kernel bodies' semantics instead: the scale a float32 scalar, so that the
scores are those of q·s and k·s in fp32 (the kernels form q·kᵀ of the
bf16 operands with exact products on bf16 tensor cores and multiply the
fp32 sums by s²), the weights rounded where the bodies round them
(:136, :189-191, :331-333), and K7b fp32 throughout, each sum rounded
into dqkv once. float16 raises everywhere.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from sdeflow_tpu_torch.ops.kernels import common

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P, _P, ctypes.c_longlong] + [_I] * 4 + [ctypes.c_float, _P]
_STATS_ARGS = [_P, _P, _P, ctypes.c_longlong] + [_I] * 4 + [ctypes.c_float,
                                                             _P]
# each kernel's launches are also counted per entry point
# (Kernel.entry_launches), so that a run can tell the bf16 entries from the
# float32 ones
K6 = common.register(common.Kernel(
    "qkv_attention", "attention.cu",
    {"qkv_attention_f32": _FWD_ARGS, "qkv_attention_bf16": _FWD_ARGS,
     "qkv_attention_bf16_plan": [ctypes.c_longlong] + [_I] * 3 + [_P]},
))
K4 = common.register(common.Kernel(
    "qkv_attention_flash", "flash_fwd.cu",
    {"qkv_attention_flash_f32": _FWD_ARGS,
     "qkv_attention_flash_bf16": _FWD_ARGS},
))
K7A = common.register(common.Kernel(
    "qkv_attention_stats", "flash_fwd.cu",
    {"qkv_attention_stats_f32": _STATS_ARGS,
     "qkv_attention_stats_bf16": _STATS_ARGS},
))
K7B = common.register(common.Kernel(
    "qkv_attention_bwd", "attention_bwd.cu",
    {"qkv_attention_bwd_f32": [_P] * 5 + [ctypes.c_longlong] + [_I] * 4
     + [ctypes.c_float, _P],
     "qkv_attention_bwd_bf16": [_P] * 5 + [ctypes.c_longlong] + [_I] * 5
     + [ctypes.c_float, _P]},
))
_SYMBOL = {torch.float32: "f32", torch.bfloat16: "bf16"}

MAX_HEAD_WIDTH = 128
# tile constants of the .cu files (tests/test_torch_flash_tc.py parses the
# sources and holds these to them)
_K6_WARPS, _K6_SHORT_T, _K6_KEYS = 4, 64, 32    # attention.cu (K6)
_K6_TILED_ROWS, _K6_TILED_KEYS, _K6_TILED_STAGES = 128, 64, 2  # its bf16 body
_K6_SHORT_ROWS, _K6_SHORT_STAGES = 64, 2  # its bf16 body up to T = 64
_FWD_ROWS, _FWD_KEYS = 64, 64                    # flash_fwd.cu (K4, K7a)
# flash_fwd.cu's bf16 body: key tiles, ring depth, query rows per consumer
# warpgroup, and the grid from which a block takes two warpgroups
_FWD_BF_KEYS, _FWD_BF_STAGES, _FWD_BF_GROUP_ROWS, _FWD_BF_WIDE_FROM = (
    64, 4, 64, 264)
_BWD_KEYS, _BWD_ROWS, _BWD_ROWS_WIDE, _BWD_WIDE_FROM = 64, 64, 32, 128
_BWD_BF_QUERIES, _BWD_BF_STAGES = 64, 3          # attention_bwd.cu's bf16
_STAGES, _PAD_QK, _PAD_V, _PAD_DS = 2, 4, 8, 8    # both tensor-core files
_WIDTHS = (32, 64, 128)  # the head widths the tensor-core kernels pad to
_FLASH_SEQ_THRESHOLD = 1024  # attention.py:148
_FLASH_KV_BLOCK = 512        # :149
_BWD_KV_BLOCK = 128          # :295


def _split(qkv, num_heads):
    b, t, c3 = qkv.shape
    ch = c3 // 3 // num_heads
    return qkv.reshape(b, t, num_heads, 3 * ch).split(ch, dim=-1)


def _split_heads(qkv, num_heads):
    """q, k, v as (B, heads, T, ch) views of the interleaved qkv."""
    return [a.transpose(1, 2) for a in _split(qkv, num_heads)]


def _heads(x, num_heads):
    """(B, T, heads·ch) -> (B, heads, T, ch)."""
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2)


def _merge(x):
    """(B, heads, T, w) -> (B, T, heads·w)."""
    b, h, t, w = x.shape
    return x.transpose(1, 2).reshape(b, t, h * w)


def _scale(qkv, num_heads):
    return 1.0 / math.sqrt(math.sqrt(qkv.shape[-1] // 3 // num_heads))


def _check_dtype(qkv):
    """The plain versions run in float32, float64 (for the autograd checks)
    and bfloat16; anything else raises, naming what is not ported."""
    if qkv.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise NotImplementedError(
            f"the attention core runs in float32 or bfloat16, not "
            f"{qkv.dtype}: float16 and other dtypes are not ported (no "
            "preset computes in them)")


def _bf16_scale(qkv, num_heads):
    """The scale rounded to bf16, as the JAX math versions take it
    (``_attention_math`` :42-47)."""
    return float(torch.tensor(_scale(qkv, num_heads), dtype=torch.bfloat16))


def attention_math(qkv, num_heads):
    """Plain version; float32 (float64 runs the same math, for the autograd
    checks), or bfloat16: q and k scaled by the scale rounded to bf16, the
    scores and the softmax in fp32, the weights cast to bf16 for P·V."""
    b, t, c3 = qkv.shape
    q, k, v = _split(qkv, num_heads)
    if qkv.dtype == torch.bfloat16:
        scale = _bf16_scale(qkv, num_heads)
        w = torch.softmax(torch.einsum(
            "bthc,bshc->bhts", (q * scale).float(), (k * scale).float()),
            dim=-1).to(v.dtype)
    else:
        _check_dtype(qkv)
        scale = _scale(qkv, num_heads)
        w = torch.softmax(torch.einsum("bthc,bshc->bhts", q * scale,
                                       k * scale), dim=-1)
    return torch.einsum("bhts,bshc->bthc", w, v).reshape(b, t, c3 // 3)


def attention_jvp(qkv, num_heads, dqkv):
    """Tangent of ``attention_math`` in closed form, through the scores,
    the softmax (dp = p·(ds − Σ p·ds)) and P·V; for bf16 qkv the same in
    fp32 on the widened qkv and dqkv, rounded to bf16."""
    if qkv.dtype == torch.bfloat16:
        return attention_jvp(qkv.float(), num_heads,
                             dqkv.float()).to(qkv.dtype)
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


def _softmax_tile(qs, kb, vb, m, l, acc):
    """One key tile of the online softmax: the running max m, normaliser l
    and accumulator acc (B, heads, T, ·) updated by the scaled keys kb and
    values vb (B, heads, blk, ch). With bf16 qs, kb and vb (m, l and acc
    fp32): the scores in fp32 from the bf16 operands, and p cast to bf16
    for an fp32-accumulated P·V (``_attention_flash_math`` :86-95)."""
    wide = m.dtype
    s = qs.to(wide) @ kb.to(wide).transpose(-1, -2)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    return (m_new, l * corr + p.sum(dim=-1, keepdim=True),
            acc * corr + p.to(vb.dtype).to(wide) @ vb.to(wide))


def _online_softmax(qkv, num_heads, kv_block, remat, body=False):
    """(out (B, T, C), lse (B, heads, T)) by the online softmax over key
    tiles of kv_block rows (the last one shorter when T is ragged); with
    remat each tile runs under a checkpoint, as ``jax.checkpoint`` does.
    For bf16 qkv, ``_attention_flash_math``'s semantics (:72-102): the
    scale rounded to bf16, q·s and k·s bf16, m, l and acc fp32, the output
    rounded to bf16 once; lse fp32. With body, the kernel bodies' instead
    (:163-198, :305-341): the scale a float32 scalar, so that q·s and k·s
    are the fp32 products of the widened q and k; p is still cast to bf16
    for P·V."""
    _check_dtype(qkv)
    q, k, v = _split_heads(qkv, num_heads)
    bf16 = qkv.dtype == torch.bfloat16
    wide = torch.float32 if bf16 else qkv.dtype
    if bf16 and body:
        q, k = q.to(wide), k.to(wide)
    scale = (_bf16_scale if bf16 and not body else _scale)(qkv, num_heads)
    qs = q * scale
    b, h, t, ch = q.shape
    m = qs.new_full((b, h, t, 1), -math.inf, dtype=wide)
    l = qs.new_zeros((b, h, t, 1), dtype=wide)
    acc = qs.new_zeros((b, h, t, ch), dtype=wide)
    for j in range(0, t, kv_block):
        args = (qs, k[:, :, j:j + kv_block] * scale, v[:, :, j:j + kv_block],
                m, l, acc)
        m, l, acc = (checkpoint(_softmax_tile, *args, use_reentrant=False)
                     if remat else _softmax_tile(*args))
    return _merge(acc / l).to(qkv.dtype), (m + torch.log(l)).squeeze(-1)


def attention_flash_math(qkv, num_heads, kv_block=None):
    """The tiled counterpart of ``attention_math`` (``_attention_flash_math``
    :54-103): the online softmax over key tiles of kv_block rows, each tile
    checkpointed, so that no (T, T) tensor exists under autograd either.
    Falls back to ``attention_math`` when T % kv_block ≠ 0, as the JAX one
    does (kv_block: 512 unless given)."""
    kv_block = kv_block or _FLASH_KV_BLOCK
    if qkv.shape[1] % kv_block:
        return attention_math(qkv, num_heads)
    return _online_softmax(qkv, num_heads, kv_block, remat=True)[0]


def attention_reference(qkv, num_heads):
    """Tiled above the long-sequence threshold, plain below it
    (``_attention_reference`` :106-112)."""
    if qkv.shape[1] > _FLASH_SEQ_THRESHOLD:
        return attention_flash_math(qkv, num_heads)
    return attention_math(qkv, num_heads)


def _jvp_tile(qs, dqs, kb, dkb, vb, dvb, m, l, acc, tacc, dsum):
    """One key tile of the online tangent: besides m, l and acc, the sums
    tacc = Σ e·(ds·v + dv) and dsum = Σ e·ds over the keys, with
    e = exp(s − m) and ds the scores' tangent."""
    s = qs @ kb.transpose(-1, -2)
    ds = dqs @ kb.transpose(-1, -2) + qs @ dkb.transpose(-1, -2)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    pds = p * ds
    return (m_new, l * corr + p.sum(dim=-1, keepdim=True),
            acc * corr + p @ vb, tacc * corr + pds @ vb + p @ dvb,
            dsum * corr + pds.sum(dim=-1, keepdim=True))


def attention_flash_jvp(qkv, num_heads, dqkv, kv_block=None):
    """Tangent of ``attention_flash_math`` in closed form, accumulated tile
    by tile: per query row, with p the softmax over all keys,
    d_out = Σ_j p_j (ds_j v_j + dv_j) − out · Σ_j p_j ds_j, where
    ds = dq·s·(k·s)ᵀ + q·s·(dk·s)ᵀ. Each tile is checkpointed, so the
    gradient of this tangent (the SSM loss) holds no (T, T) tensor either.
    ``attention_jvp`` when T % kv_block ≠ 0 (kv_block: 512 unless given).
    For bf16 qkv the same in fp32 on the widened qkv and dqkv, rounded to
    bf16, as ``attention_jvp``."""
    if qkv.dtype == torch.bfloat16:
        return attention_flash_jvp(qkv.float(), num_heads, dqkv.float(),
                                   kv_block).to(qkv.dtype)
    kv_block = kv_block or _FLASH_KV_BLOCK
    b, t, c3 = qkv.shape
    if t % kv_block:
        return attention_jvp(qkv, num_heads, dqkv)
    _check_dtype(qkv)
    q, k, v = _split_heads(qkv, num_heads)
    dq, dk, dv = _split_heads(dqkv.expand(b, t, c3), num_heads)
    scale = _scale(qkv, num_heads)
    qs, dqs = q * scale, dq * scale
    h, ch = q.shape[1], q.shape[3]
    m = qs.new_full((b, h, t, 1), -math.inf)
    l, dsum = qs.new_zeros((b, h, t, 1)), qs.new_zeros((b, h, t, 1))
    acc, tacc = qs.new_zeros((b, h, t, ch)), qs.new_zeros((b, h, t, ch))
    for j in range(0, t, kv_block):
        tile = slice(j, j + kv_block)
        m, l, acc, tacc, dsum = checkpoint(
            _jvp_tile, qs, dqs, k[:, :, tile] * scale, dk[:, :, tile] * scale,
            v[:, :, tile], dv[:, :, tile], m, l, acc, tacc, dsum,
            use_reentrant=False)
    out = acc / l
    return _merge(tacc / l - out * (dsum / l))


def attention_tangent(qkv, num_heads, dqkv):
    """The tangent rule of ``attention_reference``."""
    if qkv.shape[1] > _FLASH_SEQ_THRESHOLD:
        return attention_flash_jvp(qkv, num_heads, dqkv)
    return attention_jvp(qkv, num_heads, dqkv)


def attention_flash_stats_math(qkv, num_heads):
    """Plain version of K7a (``_flash_fwd_stats_kernel`` :299-341): the
    output and lse = m + log l of the scaled scores, (B, heads, T), by the
    online softmax over key tiles of min(512, T) rows (any T). For bf16
    qkv, with K7a's body's semantics rather than ``_attention_flash_math``'s
    (``_online_softmax`` with body): it is the forward of a pair whose
    backward (K7b's body, and ``attention_flash_bwd_math``) recomputes
    p = exp(s − lse) and Δ = rowsum(dO∘O) from the fp32 scores of the
    widened qkv, and the pair's gradient is right only where O and lse come
    from those same scores (from the bf16-rounded q·s and k·s, p drifts by
    up to 2^-8 of |s|: at (2, 256, 64), two heads, the gradient lay 3-10×
    farther from the fp32 one than JAX's pair does)."""
    return _online_softmax(qkv, num_heads, min(_FLASH_KV_BLOCK,
                                               qkv.shape[1]), remat=False,
                           body=True)


def attention_flash_bwd_math(qkv, dout, lse, delta, num_heads):
    """Plain version of K7b (``_flash_bwd_kernel`` :371-433): over key tiles
    of min(128, T) rows, p = exp(s − lse), dV = pᵀ·dO,
    dS = p∘(dO·vᵀ − Δ), dK = dSᵀ·q·s·s and dQ += dS·k·s·s, written as the
    interleaved [dq_h dk_h dv_h] of (B, T, 3C). For bf16 qkv and dout, the
    body's semantics (:383-433): the same in fp32 on the widened inputs,
    dqkv rounded to bf16 once."""
    if qkv.dtype == torch.bfloat16:
        return attention_flash_bwd_math(qkv.float(), dout.float(), lse,
                                        delta, num_heads).to(qkv.dtype)
    _check_dtype(qkv)
    q, k, v = _split_heads(qkv, num_heads)
    do = _heads(dout, num_heads)
    scale = _scale(qkv, num_heads)
    qs = q * scale
    lse, delta = lse[..., None], delta[..., None]
    blk = min(_BWD_KV_BLOCK, qkv.shape[1])
    dq = torch.zeros_like(qs)
    dks, dvs = [], []
    for j in range(0, qkv.shape[1], blk):
        kb, vb = k[:, :, j:j + blk] * scale, v[:, :, j:j + blk]
        p = torch.exp(qs @ kb.transpose(-1, -2) - lse)
        dvs.append(p.transpose(-1, -2) @ do)
        ds = p * (do @ vb.transpose(-1, -2) - delta)
        dks.append(ds.transpose(-1, -2) @ qs * scale)
        dq = dq + ds @ kb * scale
    return _merge(torch.cat([dq, torch.cat(dks, dim=2),
                             torch.cat(dvs, dim=2)], dim=-1))


def _padded_width(ch):
    """The width W ≥ ch that the tensor-core kernels pad a head to (zero
    channels past ch), one of 32, 64, 128."""
    return next(w for w in _WIDTHS if ch <= w)


def _swizzled_width(ch):
    """The width that the wgmma kernels (the tiled bf16 K6, bf16 K4, K7a
    and K7b) pad a head to: 64 or 128, whole column blocks of their
    128-byte swizzle."""
    return max(64, _padded_width(ch))


def flash_fwd_bf16_rows(b, t, heads):
    """Query rows per block of flash_fwd.cu's bf16 body (K4, K7a; its
    ``bf_groups``): 128, two consumer warpgroups sharing each K and V tile,
    where the grid of 128-row blocks holds at least 264 of them (two per
    SM of the H100's 132); else 64, one warpgroup, so that a small grid
    still spreads over the SMs ((4, 4096, 64): 256 blocks of 64 rows, not
    128 of 128)."""
    wide = 2 * _FWD_BF_GROUP_ROWS
    if b * heads * -(-t // wide) >= _FWD_BF_WIDE_FROM:
        return wide
    return _FWD_BF_GROUP_ROWS


def flash_fwd_smem_bytes(ch, dtype=torch.float32, rows=_FWD_ROWS):
    """Dynamic shared memory of one block of flash_fwd.cu (K4, K7a): the
    block's 64 scaled Q rows split into big and small halves (rows of W+4
    floats) and a two-stage ring of 64-row K tiles (W+4) and V tiles (W+8),
    float32. 204,800 bytes at W = 128. In bf16, for a block of ``rows``
    query rows (``flash_fwd_bf16_rows``): its raw Q rows and a four-stage
    ring of 64-row K and V tiles, rows of W = 64 or 128 bf16
    (``_swizzled_width``), and 1,024 bytes to align them; 82,944 bytes at
    W = 64 with 128 rows (two blocks an SM), 164,864 at W = 128."""
    if dtype == torch.bfloat16:
        return 1024 + 2 * _swizzled_width(ch) * (
            rows + 2 * _FWD_BF_STAGES * _FWD_BF_KEYS)
    w = _padded_width(ch)
    return 4 * (2 * _FWD_ROWS * (w + _PAD_QK)
                + _STAGES * _FWD_KEYS * (2 * w + _PAD_QK + _PAD_V))


def smem_bytes(t, ch, dtype=torch.float32):
    """Dynamic shared memory of one block of attention.cu (K6): above
    T = 64, flash_fwd.cuh's K6 variant: the block's 64 raw scaled Q rows
    (W+4 floats) and a two-stage ring of 32-row K (W+4) and V (W+8) tiles,
    102,400 bytes at W = 128; up to T = 64, per unit (sample, head) packed
    into the block (4 warps of 16 query rows: 4 units at T ≤ 16, 2 at
    T ≤ 32, else 1), T rounded up to 16 rows of Q and K (w + 4 floats) and
    of V (w + 8), w = ch rounded up to 8. In bf16: above T = 64 the tiled
    bf16 body's 128 raw Q rows and a two-stage ring of 64-row K and V
    tiles, rows of W = 64 or 128 bf16 (``_swizzled_width``), and 1,024
    bytes to align them (99,328 bytes at W = 128, two blocks per SM); up
    to T = 64 a two-slot ring of 64-row tiles of Q, K and V at W, and
    1,024 bytes to align them (50,176 bytes at W = 64, 99,328 at W =
    128), whatever T and the units a tile (``short_bf16_plan``)."""
    units = lambda tp: _K6_WARPS // (tp // 16)  # noqa: E731
    if dtype == torch.bfloat16:
        if t > _K6_SHORT_T:
            return 1024 + 2 * _swizzled_width(ch) * (
                _K6_TILED_ROWS + 2 * _K6_TILED_STAGES * _K6_TILED_KEYS)
        return 1024 + _K6_SHORT_STAGES * 3 * 2 * _K6_SHORT_ROWS * (
            _swizzled_width(ch))
    if t > _K6_SHORT_T:
        w = _padded_width(ch)
        return 4 * (_FWD_ROWS * (w + _PAD_QK)
                    + _STAGES * _K6_KEYS * (2 * w + _PAD_QK + _PAD_V))
    tp, w = -(-t // 16) * 16, -(-ch // 8) * 8
    return 4 * units(tp) * tp * (2 * (w + _PAD_QK) + w + _PAD_V)


class ShortBf16Plan(NamedTuple):
    samples: int  # units (sample, head) packed row after row into a tile
    tiles: int    # tiles of 64 rows that the persistent grid walks
    width: int    # W: the head width padded to 64 or 128
    smem: int     # shared memory a block (``smem_bytes``)


def short_bf16_plan(b, t, heads, ch, sms):
    """The plan of K6 bf16 up to T = 64 (attention.cu ``short_samples``
    and ``ShortBf``): each tile packs as many units (sample, head) as fit
    its 64 rows, fewer where the tiles would leave some of the card's
    ``sms`` SMs without one (down to one unit a tile); a block, one
    warpgroup, walks tiles through a two-slot ring. The grid (as many
    blocks as the SMs hold) is the card's: ``kernel_short_bf16_plan``."""
    if not 1 <= t <= _K6_SHORT_T or not 1 <= ch <= MAX_HEAD_WIDTH:
        raise ValueError(f"the short bf16 path takes T in 1..{_K6_SHORT_T}"
                         f" and head widths up to {MAX_HEAD_WIDTH}")
    units = b * heads
    samples = max(1, min(_K6_SHORT_ROWS // t, units // sms))
    return ShortBf16Plan(samples, -(-units // samples), _swizzled_width(ch),
                         smem_bytes(t, ch, torch.bfloat16))


def kernel_short_bf16_plan(b, t, heads, ch):
    """The compiled kernel's plan on this card (``qkv_attention_bf16_plan``):
    (samples a tile, tiles, grid, blocks an SM holds, shared memory)."""
    out = (ctypes.c_longlong * 5)()
    err = K6.lib().qkv_attention_bf16_plan(b, t, heads, ch, out)
    if err:
        raise RuntimeError(f"qkv_attention_bf16_plan: CUDA error {err}")
    return tuple(out)


def bwd_query_rows(ch):
    """Query rows per tile of attention_bwd.cu (K7b): 64, and 32 at the
    padded width 128, where a 64-row tile's score, dP, dK and dV
    accumulators would not fit the 255 registers of a thread."""
    wide = _padded_width(ch) >= _BWD_WIDE_FROM
    return _BWD_ROWS_WIDE if wide else _BWD_ROWS


def bwd_smem_bytes(ch, dtype=torch.float32):
    """Dynamic shared memory of one block of attention_bwd.cu (K7b): the
    block's 64 keys' scaled K and V rows (W+4 floats) and a two-stage ring
    of query tiles (Q and dO rows of W+4, lse and Δ), float32; the dSᵀ tile
    (64 keys × rows+8) reuses its stage's Q and dO rows. 105,472 bytes at
    W = 64 (two blocks per SM), 135,680 at W = 128. In bf16, of its dK/dV
    kernel: the 64 keys' K and V rows and a three-stage ring of query tiles
    (Q and dO rows, lse and Δ fp32), rows of W = 64 or 128 bf16
    (``_swizzled_width``), and 1,024 bytes to align them; 68,096 bytes at
    W = 64, 83,712 at W = 128."""
    w, rows = _padded_width(ch), bwd_query_rows(ch)
    if dtype == torch.bfloat16:
        w = _swizzled_width(ch)
        return (1024 + 4 * _BWD_KEYS * w
                + _BWD_BF_STAGES * (4 * rows * w + 8 * rows))
    return 4 * (2 * _BWD_KEYS * (w + _PAD_QK)
                + _STAGES * (2 * rows * (w + _PAD_QK) + 2 * rows))


def bwd_dq_smem_bytes(ch):
    """Dynamic shared memory of one block of attention_bwd.cu's bf16 dQ
    kernel: the block's 64 queries' Q and dO rows and a three-stage ring of
    key tiles (K and V rows, ``bwd_query_rows`` of them), rows of W = 64 or
    128 bf16, and 1,024 bytes to align them; 66,560 bytes at W = 64,
    82,944 at W = 128."""
    w, rows = _swizzled_width(ch), bwd_query_rows(ch)
    return 1024 + 4 * w * (_BWD_BF_QUERIES + _BWD_BF_STAGES * rows)


def _checked(qkv, num_heads, what):
    """(contiguous qkv, B, T, ch) after the checks every launch makes."""
    if qkv.dtype not in _SYMBOL:
        raise NotImplementedError(
            f"{what} kernel takes float32 or bfloat16 qkv, not {qkv.dtype}:"
            " float16 and other dtypes are not ported (no preset computes "
            "in them)")
    b, t, c3 = qkv.shape
    if c3 % 3 or (c3 // 3) % num_heads:
        raise ValueError(f"3C={c3} must be 3·heads·ch for heads={num_heads}")
    ch = c3 // 3 // num_heads
    if ch > MAX_HEAD_WIDTH:
        raise NotImplementedError(
            f"{what} kernel takes head widths up to {MAX_HEAD_WIDTH}, "
            f"got {ch}")
    return qkv.contiguous(), b, t, ch


def _launch(qkv, num_heads):
    """K6 at T ≤ 1024, K4 above it."""
    qkv, b, t, ch = _checked(qkv, num_heads, "qkv_attention")
    out = qkv.new_empty(b, t, num_heads * ch)
    args = (common.ptr(qkv), common.ptr(out), b, t, num_heads, ch)
    sym, dt = _SYMBOL[qkv.dtype], qkv.dtype
    if t > _FLASH_SEQ_THRESHOLD:
        K4.launch(f"qkv_attention_flash_{sym}", *args,
                  flash_fwd_smem_bytes(ch, dt, flash_fwd_bf16_rows(
                      b, t, num_heads)), _scale(qkv, num_heads))
    else:
        K6.launch(f"qkv_attention_{sym}", *args, smem_bytes(t, ch, dt),
                  _scale(qkv, num_heads))
    return out


def _launch_stats(qkv, num_heads):
    """K7a: (out, lse) as ``attention_flash_stats_math``."""
    qkv, b, t, ch = _checked(qkv, num_heads, "qkv_attention_stats")
    out = qkv.new_empty(b, t, num_heads * ch)
    lse = qkv.new_empty(b, num_heads, t, dtype=torch.float32)
    K7A.launch(f"qkv_attention_stats_{_SYMBOL[qkv.dtype]}", common.ptr(qkv),
               common.ptr(out), common.ptr(lse), b, t, num_heads, ch,
               flash_fwd_smem_bytes(ch, qkv.dtype, flash_fwd_bf16_rows(
                   b, t, num_heads)), _scale(qkv, num_heads))
    return out, lse


def _launch_bwd(qkv, dout, lse, delta, num_heads):
    """K7b: dqkv as ``attention_flash_bwd_math``; dout in qkv's dtype, lse
    and Δ float32. In float32 the kernel adds dQ into a zeroed dqkv by
    atomics; in bf16 two kernels write every element of dqkv once."""
    qkv, b, t, ch = _checked(qkv, num_heads, "qkv_attention_bwd")
    want = {"dout": (qkv.dtype, (b, t, num_heads * ch)),
            "lse": (torch.float32, (b, num_heads, t)),
            "delta": (torch.float32, (b, num_heads, t))}
    for name, a in zip(want, (dout, lse, delta)):
        if (a.dtype, tuple(a.shape)) != want[name]:
            raise ValueError(f"{name}: {a.dtype} {tuple(a.shape)}, want "
                             f"{want[name]}")
    dout, lse, delta = (a.contiguous() for a in (dout, lse, delta))
    ptrs = [common.ptr(a) for a in (qkv, dout, lse, delta)]
    if qkv.dtype == torch.bfloat16:
        dqkv = torch.empty_like(qkv)
        smem = (bwd_smem_bytes(ch, qkv.dtype), bwd_dq_smem_bytes(ch))
    else:
        dqkv = torch.zeros_like(qkv)  # the q slots take atomic sums
        smem = (bwd_smem_bytes(ch),)
    K7B.launch(f"qkv_attention_bwd_{_SYMBOL[qkv.dtype]}", *ptrs,
               common.ptr(dqkv), b, t, num_heads, ch, *smem,
               _scale(qkv, num_heads))
    return dqkv


def _checkpointed(qkv, num_heads):
    """True where ``attention_reference`` runs the checkpointed tiled math
    (``attention_flash_math`` with T % 512 == 0 above T = 1024)."""
    t = qkv.shape[1]
    return t > _FLASH_SEQ_THRESHOLD and t % _FLASH_KV_BLOCK == 0


QKVAttention = common.kernel_function(
    "QKVAttention", attention_reference, _launch, attention_tangent, 1,
    _checkpointed, op=common.register_op(
        "qkv_attention", "(Tensor qkv, int num_heads) -> Tensor",
        attention_reference, _launch,
        lambda qkv, num_heads: qkv.new_empty(
            (*qkv.shape[:2], qkv.shape[2] // 3))))


def qkv_attention(qkv, num_heads=1):
    """qkv (B, T, 3C) -> (B, T, C), any T."""
    return QKVAttention.apply(qkv, num_heads)


class FlashAttention(torch.autograd.Function):
    """(qkv, heads) -> (out, lse): K7a forward and K7b backward on CUDA
    tensors, their plain versions on CPU tensors; forward mode through
    ``attention_flash_jvp``. lse is not differentiable."""

    @staticmethod
    def forward(qkv, num_heads):
        if common.use_kernel(qkv):
            return _launch_stats(qkv, num_heads)
        return attention_flash_stats_math(qkv, num_heads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        qkv, ctx.num_heads = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(qkv, out, lse)
        ctx.save_for_forward(qkv)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, _):
        qkv, out, lse = ctx.saved_tensors
        h = ctx.num_heads
        # Δ = rowsum(dO∘O) per (sample, head, row) in lse's precision (fp32
        # from bf16 dO and O), left to PyTorch as the JAX package leaves it
        # to XLA (:477-484)
        wide = lse.dtype
        delta = (_heads(dout, h).to(wide) * _heads(out, h).to(wide)).sum(-1)
        bwd = (_launch_bwd if common.use_kernel(qkv, dout)
               else attention_flash_bwd_math)
        return bwd(qkv, dout, lse, delta, h), None

    @staticmethod
    def jvp(ctx, dqkv, _):
        (qkv,) = ctx.saved_tensors
        return attention_flash_jvp(qkv, ctx.num_heads, dqkv), None


def flash_attention_vjp(qkv, num_heads=1):
    """qkv (B, T, 3C) -> (B, T, C) through the pair K7a/K7b."""
    return FlashAttention.apply(qkv, num_heads)[0]


def _recorded(t):
    """True if autograd records t, seen through torch.func's wrappers."""
    if not torch.is_grad_enabled():
        return False
    functorch = torch._C._functorch
    while functorch.is_functorch_wrapped_tensor(t):
        t = functorch.get_unwrapped(t)
    return t.requires_grad


def attention_core(qkv, num_heads=1):
    """The AttentionBlock's entry point: the pair K7a/K7b for a call that
    autograd records at T > 1024 with T % 512 == 0, else ``qkv_attention``
    (module docstring)."""
    t = qkv.shape[1]
    if (t > _FLASH_SEQ_THRESHOLD and t % _FLASH_KV_BLOCK == 0
            and _recorded(qkv)):
        return flash_attention_vjp(qkv, num_heads)
    return qkv_attention(qkv, num_heads)
