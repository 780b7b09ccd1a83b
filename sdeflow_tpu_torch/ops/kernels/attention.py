"""K6, K4, K7a and K7b: the attention core as CUDA kernels.

qkv (B, T, 3C) -> (B, T, C): per head, softmax attention with q and k each
scaled by ch^-1/4 and the softmax in fp32; head h owns the interleaved
channel slice [q_h k_h v_h] of width 3·ch of each row. Port of
sdeflow_tpu/ops/pallas/attention.py.

- ``qkv_attention`` (:258-288) goes through its ``torch.autograd.Function``
  (ops/kernels/common.py): on CUDA tensors it launches ``csrc/attention.cu``
  (K6, the single-block ``_attention_pallas`` :225-255, T ≤ 1024; opt-in
  there under ``SDEFLOW_PALLAS_NN=1``; on the tensor cores in 3xTF32, each
  (sample, head) whole in shared memory up to T = 64 and flash_fwd.cuh's
  tiles above) or, above T = 1024,
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
  K7b (``_attention_flash_bwd`` :436-452), one pass from the saved lse and
  Δ = rowsum(dO∘O) whose dQ sums arrive by atomics (so two runs agree to
  rounding, not bit for bit); its jvp is ``attention_flash_jvp``. K6, K4,
  K7a and K7b form every product on the tensor cores in 3xTF32 (fp32 split
  into two TF32 halves, three products), close enough to fp32 that the
  tolerances against the plain fp32 versions stand. On CPU tensors the
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

Float32 (float64 in the plain versions, for the autograd checks) and head
widths up to 128; anything else raises on CUDA.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from sdeflow_tpu_torch.ops.kernels import common

_P, _I = ctypes.c_void_p, ctypes.c_int
K6 = common.register(common.Kernel(
    "qkv_attention", "attention.cu",
    {"qkv_attention_f32": [_P, _P, ctypes.c_longlong] + [_I] * 4
     + [ctypes.c_float, _P]},
))
K4 = common.register(common.Kernel(
    "qkv_attention_flash", "flash_fwd.cu",
    {"qkv_attention_flash_f32": [_P, _P, ctypes.c_longlong] + [_I] * 4
     + [ctypes.c_float, _P]},
))
K7A = common.register(common.Kernel(
    "qkv_attention_stats", "flash_fwd.cu",
    {"qkv_attention_stats_f32": [_P, _P, _P, ctypes.c_longlong] + [_I] * 4
     + [ctypes.c_float, _P]},
))
K7B = common.register(common.Kernel(
    "qkv_attention_bwd", "attention_bwd.cu",
    {"qkv_attention_bwd_f32": [_P] * 5 + [ctypes.c_longlong] + [_I] * 4
     + [ctypes.c_float, _P]},
))

MAX_HEAD_WIDTH = 128
# tile constants of the .cu files (tests/test_torch_flash_tc.py parses the
# sources and holds these to them)
_K6_WARPS, _K6_SHORT_T, _K6_KEYS = 4, 64, 32    # attention.cu (K6)
_FWD_ROWS, _FWD_KEYS = 64, 64                    # flash_fwd.cu (K4, K7a)
_BWD_KEYS, _BWD_ROWS, _BWD_ROWS_WIDE, _BWD_WIDE_FROM = 64, 64, 32, 128
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
    if qkv.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            "attention runs in float32 only (bf16: ROADMAP Queue 1 item 8)")


def attention_math(qkv, num_heads):
    """Plain version; float32 (float64 runs the same math, for the autograd
    checks)."""
    _check_dtype(qkv)
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


def _softmax_tile(qs, kb, vb, m, l, acc):
    """One key tile of the online softmax: the running max m, normaliser l
    and accumulator acc (B, heads, T, ·) updated by the scaled keys kb and
    values vb (B, heads, blk, ch)."""
    s = qs @ kb.transpose(-1, -2)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    return (m_new, l * corr + p.sum(dim=-1, keepdim=True),
            acc * corr + p @ vb)


def _online_softmax(qkv, num_heads, kv_block, remat):
    """(out (B, T, C), lse (B, heads, T)) by the online softmax over key
    tiles of kv_block rows (the last one shorter when T is ragged); with
    remat each tile runs under a checkpoint, as ``jax.checkpoint`` does."""
    _check_dtype(qkv)
    q, k, v = _split_heads(qkv, num_heads)
    scale = _scale(qkv, num_heads)
    qs = q * scale
    b, h, t, ch = q.shape
    m = qs.new_full((b, h, t, 1), -math.inf)
    l = qs.new_zeros((b, h, t, 1))
    acc = qs.new_zeros((b, h, t, ch))
    for j in range(0, t, kv_block):
        args = (qs, k[:, :, j:j + kv_block] * scale, v[:, :, j:j + kv_block],
                m, l, acc)
        m, l, acc = (checkpoint(_softmax_tile, *args, use_reentrant=False)
                     if remat else _softmax_tile(*args))
    return _merge(acc / l), (m + torch.log(l)).squeeze(-1)


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
    ``attention_jvp`` when T % kv_block ≠ 0 (kv_block: 512 unless given)."""
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
    online softmax over key tiles of min(512, T) rows (any T)."""
    return _online_softmax(qkv, num_heads, min(_FLASH_KV_BLOCK,
                                               qkv.shape[1]), remat=False)


def attention_flash_bwd_math(qkv, dout, lse, delta, num_heads):
    """Plain version of K7b (``_flash_bwd_kernel`` :371-433): over key tiles
    of min(128, T) rows, p = exp(s − lse), dV = pᵀ·dO,
    dS = p∘(dO·vᵀ − Δ), dK = dSᵀ·q·s·s and dQ += dS·k·s·s, written as the
    interleaved [dq_h dk_h dv_h] of (B, T, 3C)."""
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


def flash_fwd_smem_bytes(ch):
    """Dynamic shared memory of one block of flash_fwd.cu (K4, K7a): the
    block's 64 scaled Q rows split into big and small halves (rows of W+4
    floats) and a two-stage ring of 64-row K tiles (W+4) and V tiles (W+8),
    float32. 204,800 bytes at W = 128."""
    w = _padded_width(ch)
    return 4 * (2 * _FWD_ROWS * (w + _PAD_QK)
                + _STAGES * _FWD_KEYS * (2 * w + _PAD_QK + _PAD_V))


def smem_bytes(t, ch):
    """Dynamic shared memory of one block of attention.cu (K6): above
    T = 64, flash_fwd.cuh's K6 variant: the block's 64 raw scaled Q rows
    (W+4 floats) and a two-stage ring of 32-row K (W+4) and V (W+8) tiles,
    102,400 bytes at W = 128; up to T = 64, per unit (sample, head) packed
    into the block (4 warps of 16 query rows: 4 units at T ≤ 16, 2 at
    T ≤ 32, else 1), T rounded up to 16 rows of Q and K (w + 4 floats) and
    of V (w + 8), w = ch rounded up to 8."""
    if t > _K6_SHORT_T:
        w = _padded_width(ch)
        return 4 * (_FWD_ROWS * (w + _PAD_QK)
                    + _STAGES * _K6_KEYS * (2 * w + _PAD_QK + _PAD_V))
    tp, w = -(-t // 16) * 16, -(-ch // 8) * 8
    units = _K6_WARPS // (tp // 16)
    return 4 * units * tp * (2 * (w + _PAD_QK) + w + _PAD_V)


def bwd_query_rows(ch):
    """Query rows per tile of attention_bwd.cu (K7b): 64, and 32 at the
    padded width 128, where a 64-row tile's score, dP, dK and dV
    accumulators would not fit the 255 registers of a thread."""
    wide = _padded_width(ch) >= _BWD_WIDE_FROM
    return _BWD_ROWS_WIDE if wide else _BWD_ROWS


def bwd_smem_bytes(ch):
    """Dynamic shared memory of one block of attention_bwd.cu (K7b): the
    block's 64 keys' scaled K and V rows (W+4 floats) and a two-stage ring
    of query tiles (Q and dO rows of W+4, lse and Δ), float32; the dSᵀ tile
    (64 keys × rows+8) reuses its stage's Q and dO rows. 105,472 bytes at
    W = 64 (two blocks per SM), 135,680 at W = 128."""
    w, rows = _padded_width(ch), bwd_query_rows(ch)
    return 4 * (2 * _BWD_KEYS * (w + _PAD_QK)
                + _STAGES * (2 * rows * (w + _PAD_QK) + 2 * rows))


def _checked(qkv, num_heads, what):
    """(contiguous qkv, B, T, ch) after the checks every launch makes."""
    if qkv.dtype != torch.float32:
        raise NotImplementedError(
            f"{what} kernel is float32 only (bf16: ROADMAP Queue 1 item 8)")
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
    if t > _FLASH_SEQ_THRESHOLD:
        K4.launch("qkv_attention_flash_f32", *args, flash_fwd_smem_bytes(ch),
                  _scale(qkv, num_heads))
    else:
        K6.launch("qkv_attention_f32", *args, smem_bytes(t, ch),
                  _scale(qkv, num_heads))
    return out


def _launch_stats(qkv, num_heads):
    """K7a: (out, lse) as ``attention_flash_stats_math``."""
    qkv, b, t, ch = _checked(qkv, num_heads, "qkv_attention_stats")
    out = qkv.new_empty(b, t, num_heads * ch)
    lse = qkv.new_empty(b, num_heads, t)
    K7A.launch("qkv_attention_stats_f32", common.ptr(qkv), common.ptr(out),
               common.ptr(lse), b, t, num_heads, ch,
               flash_fwd_smem_bytes(ch), _scale(qkv, num_heads))
    return out, lse


def _launch_bwd(qkv, dout, lse, delta, num_heads):
    """K7b: dqkv as ``attention_flash_bwd_math``."""
    qkv, b, t, ch = _checked(qkv, num_heads, "qkv_attention_bwd")
    want = {"dout": (b, t, num_heads * ch), "lse": (b, num_heads, t),
            "delta": (b, num_heads, t)}
    for name, a in zip(want, (dout, lse, delta)):
        if a.dtype != torch.float32 or tuple(a.shape) != want[name]:
            raise ValueError(f"{name}: {a.dtype} {tuple(a.shape)}, want "
                             f"float32 {want[name]}")
    dout, lse, delta = (a.contiguous() for a in (dout, lse, delta))
    dqkv = torch.zeros_like(qkv)  # the kernel adds dQ into its q slots
    K7B.launch("qkv_attention_bwd_f32", *map(common.ptr, (
        qkv, dout, lse, delta, dqkv)), b, t, num_heads, ch,
        bwd_smem_bytes(ch), _scale(qkv, num_heads))
    return dqkv


def _checkpointed(qkv, num_heads):
    """True where ``attention_reference`` runs the checkpointed tiled math
    (``attention_flash_math`` with T % 512 == 0 above T = 1024)."""
    t = qkv.shape[1]
    return t > _FLASH_SEQ_THRESHOLD and t % _FLASH_KV_BLOCK == 0


QKVAttention = common.kernel_function(
    "QKVAttention", attention_reference, _launch, attention_tangent, 1,
    _checkpointed)


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
        # Δ = rowsum(dO∘O) per (sample, head, row), left to PyTorch as the
        # JAX package leaves it to XLA (:477-484)
        delta = (_heads(dout, h) * _heads(out, h)).sum(dim=-1)
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
