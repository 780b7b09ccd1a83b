"""K3: the whole AttentionBlock as one CUDA kernel on the tensor cores.

GroupNorm (fp32 statistics, eps 1e-5) → qkv projection C→3C → per-head
softmax attention (q and k each scaled by ch^-1/4, heads laid out as
interleaved [q_h k_h v_h] channel slices) → output projection → residual.

Replaces the Pallas kernel ``_attn_block_pallas`` (sdeflow_tpu/ops/pallas/
attnblock.py:75-265). ``fused_attention_block`` goes through its
``torch.autograd.Function``: it launches ``csrc/attnblock.cu`` on CUDA
tensors and runs the plain version ``attn_block_math`` on CPU tensors, and
differentiates the plain version in both cases (ops/kernels/common.py;
forward mode through the closed form ``attn_block_jvp``). The kernel
forms its four products on the tensor cores in 3xTF32 (close enough to
fp32 that the fp32 tolerances stand) and covers float32, T ≤ 256, heads
1–8 and the shapes ``block_plan`` takes; anything else raises on CUDA
(T > 256 is queued in ROADMAP).

bf16 x (the score net's bf16 compute; the GroupNorm's parameters, the
weights and the biases stay fp32) follows the JAX package's bf16 semantics
(sdeflow_tpu/ops/pallas/attnblock.py:40-72): the weights cast to h's dtype,
the qk scale rounded to bf16, the scores and the softmax in fp32, the
weights cast to v's dtype, the residual in x's dtype (``attn_block_math``
with the bf16 branches of ``gn_math`` and ``attention_math``); the tangent
``attn_block_jvp`` is the fp32 closed form on the widened x and dx, rounded
to bf16. On CUDA it launches ``attn_block_bf16`` (the kernel body's
rounding points, ops/pallas/attnblock.py:88-185, on bf16 tensor cores;
csrc/attnblock.cu says where it rounds), with the weights cast to bf16 and
transposed once per call; it holds the whole block in shared memory only
(``block_plan(..., torch.bfloat16)``), and raises where that does not fit.
Which route an ``"auto"`` AttentionBlock takes depends on the fp32 plan
alone, so it is the same in both dtypes.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sdeflow_tpu_torch.ops.kernels import common
from sdeflow_tpu_torch.ops.kernels.attention import (
    attention_jvp, attention_math)
from sdeflow_tpu_torch.ops.kernels.groupnorm import gn_math, gn_parts

_P, _I = ctypes.c_void_p, ctypes.c_int
K3 = common.register(common.Kernel(
    "fused_attention_block", "attnblock.cu",
    {"attn_block_f32": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
     "attn_block_bf16": [_P] * 8 + [_I] * 7 + [ctypes.c_float, _P]},
))

MAX_T = 256
MAX_HEADS = 8
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
# constants of attnblock.cu (tests/test_torch_attn_tc.py parses the source
# and holds these to them)
_PASS_ROWS, _KC, _NC, _STAGES, _PAD_A, _PAD_V, _PAD_W = 64, 64, 64, 2, 4, 8, 8
_TWO_BLOCKS = 233472 // 2 - 1024  # a block's bytes when two share an SM


def attn_block_math(x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj, groups,
                    heads=1):
    """Plain version. x (B, T, C); wqkv (C, 3C) and wproj (C, C) as
    (in, out); returns (B, T, C) in x's dtype, the weights cast to it."""
    h = gn_math(x.transpose(1, 2), gn_scale, gn_bias, groups,
                False).transpose(1, 2)
    dt = h.dtype
    qkv = h @ wqkv.to(dt) + bqkv.to(dt)
    out = attention_math(qkv, heads)
    return x + (out @ wproj.to(dt) + bproj.to(dt))


def attn_block_jvp(x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj, groups,
                   heads, dx, dgn_scale, dgn_bias, dwqkv, dbqkv, dwproj,
                   dbproj):
    """Tangent of ``attn_block_math`` (None: no tangent), composed of the
    GroupNorm's and the attention core's closed forms; the terms of absent
    tangents (the weights', under the SSM loss's JVP in the input) are
    skipped. For bf16 x, the fp32 closed form on the widened x and dx,
    rounded to bf16."""
    if x.dtype == torch.bfloat16:
        return attn_block_jvp(
            x.float(), gn_scale, gn_bias, wqkv, bqkv, wproj, bproj, groups,
            heads, None if dx is None else dx.float(), dgn_scale, dgn_bias,
            dwqkv, dbqkv, dwproj, dbproj).to(x.dtype)
    add = common.add
    h, dh = gn_parts(x.transpose(1, 2), gn_scale, gn_bias, groups,
                     None if dx is None else dx.transpose(1, 2), dgn_scale,
                     dgn_bias)
    h = h.transpose(1, 2)
    qkv = h @ wqkv + bqkv
    dqkv = None if dh is None else dh.transpose(1, 2) @ wqkv
    if dwqkv is not None:
        dqkv = add(dqkv, h @ dwqkv)
    dqkv = add(dqkv, dbqkv)
    dy = dx
    if dqkv is not None:
        dy = add(dy, attention_jvp(qkv, heads, dqkv) @ wproj)
    if dwproj is not None:
        dy = add(dy, attention_math(qkv, heads) @ dwproj)
    dy = add(dy, dbproj)
    if dy is None:
        return torch.zeros_like(x)
    return dy if dy.shape == x.shape else dy.expand_as(x).contiguous()


def _round_up(x, m):
    return -(-x // m) * m


def _rows_and_widths(t, c, heads, samples):
    """(rows of a block, h/O row floats, qkv row floats) in attnblock.cu:
    samples·T rounded up to 16; C rounded up to 8, plus 4; and with w the
    head width rounded up to 8, q and k in heads·2·w + 4 floats and v in
    heads·w rounded up to 16, + 8."""
    w = _round_up(c // heads, 8)
    return (samples * _round_up(t, 16), _round_up(c, 8) + _PAD_A,
            2 * heads * w + _PAD_A + _round_up(heads * w, 16) + _PAD_V)


def _smem_bytes_bf16(t, c, groups, heads, samples):
    """attnblock.cu bf::smem_bytes: fp32 (mean, rstd) per (sample, group),
    channel sums, the GroupNorm's scale and bias, the output bias and the
    padded qkv bias (rounded up to 4 floats); then in bf16 the weight ring
    (2 stages of 64 columns × 72), x/h/O in rows of C (rounded up to 16) +
    8, q and k in rows of heads·2·w + 8 and vᵀ in rows of T (rounded up to
    16) + 8, w the head width rounded up to 16."""
    tp, w = _round_up(t, 16), _round_up(c // heads, 16)
    m = samples * tp
    floats = _round_up(2 * samples * groups + samples * c + 3 * c
                       + 3 * heads * w, 4)
    return 4 * floats + 2 * (_STAGES * _NC * (_KC + _PAD_W)
                             + m * (_round_up(c, 16) + 8)
                             + m * (2 * heads * w + 8)
                             + samples * heads * w * (tp + 8))


def smem_bytes(t, c, groups, heads, samples, mode, dtype=torch.float32):
    """Dynamic shared memory of one block (must match attnblock.cu): h/O
    unless mode 2, qkv in mode 0, the weight ring (2 stages of 64 × 72),
    (mean, rstd) per (sample, group) and, unless mode 2, the GroupNorm's
    scale and bias, the padded qkv bias and the output bias, float32; bf16
    (mode 0 only): ``_smem_bytes_bf16``."""
    if dtype == torch.bfloat16:
        if mode:
            raise ValueError("the bf16 kernel has mode 0 only")
        return _smem_bytes_bf16(t, c, groups, heads, samples)
    m, lda, ldq = _rows_and_widths(t, c, heads, samples)
    vectors = 3 * c + 3 * heads * _round_up(c // heads, 8)
    return 4 * ((m * lda if mode < 2 else 0) + (m * ldq if mode < 1 else 0)
                + _STAGES * _KC * (_NC + _PAD_W) + 2 * samples * groups
                + (vectors if mode < 2 else 0))


def scratch_floats(t, c, heads, samples, mode):
    """Device-memory scratch per block: qkv from mode 1, h/O and the
    GroupNorm's channel sums in mode 2."""
    m, lda, ldq = _rows_and_widths(t, c, heads, samples)
    return (m * ldq if mode >= 1 else 0) + (m * lda + c if mode >= 2 else 0)


def _cuda_core_working_set_fits(t, c, groups):
    """The shapes of the fp32 CUDA-core design this kernel replaced: its
    working set (h, K with rows of C+1, V, a chunk of at least 8 Q rows,
    one score row per warp of 8, statistics) within one block. K3 keeps
    taking exactly these, so that no "auto" AttentionBlock changes route;
    every one of them has a plan below (tests/test_torch_attn_tc.py)."""
    tq = t
    while 4 * (3 * t * c + t + tq * c + 8 * t + c + 2 * groups) > _SMEM_LIMIT:
        if tq <= 8:
            return False
        tq = (tq + 1) // 2
    return True


def block_plan(t, c, groups, heads, dtype=torch.float32):
    """(samples per block, mode) for K3, or None where K3 does not take the
    shape: all in shared memory, with the most samples up to 64 rows that
    let two blocks share an SM (2 at T = 16 and C = 128 in fp32: on the
    H100 that ran faster than 4 to a block, one block per SM; 4 in bf16),
    else the most that fit one block; then, in fp32 only, one sample with
    qkv in device-memory scratch (mode 1), then with h there too (mode 2).
    The plan in x's dtype decides the route (``AttentionBlock``): a bf16
    block without one runs unfused."""
    if (t > MAX_T or not 1 <= heads <= MAX_HEADS or c % heads
            or not _cuda_core_working_set_fits(t, c, groups)):
        return None
    for limit in (_TWO_BLOCKS, _SMEM_LIMIT):
        for samples in range(max(1, _PASS_ROWS // _round_up(t, 16)), 0, -1):
            if smem_bytes(t, c, groups, heads, samples, 0, dtype) <= limit:
                return samples, 0
    if dtype == torch.bfloat16:
        return None
    for mode in (1, 2):
        if smem_bytes(t, c, groups, heads, 1, mode) <= _SMEM_LIMIT:
            return 1, mode
    return None


def _launch(x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj, groups, heads):
    args = (x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj)
    b, t, c = x.shape
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or any(a.dtype != torch.float32 for a in args[1:])):
        raise NotImplementedError(
            "fused_attention_block kernel takes float32 or bfloat16 x with "
            "float32 parameters")
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
    plan = block_plan(t, c, groups, heads, x.dtype)
    if plan is None:
        raise NotImplementedError(
            f"(T={t}, C={c}, groups={groups}, {x.dtype}) is beyond the "
            "shapes K3 takes (ROADMAP Queue 2, K3 gaps)")
    samples, mode = plan
    if x.dtype == torch.bfloat16:
        return _launch_bf16(x, args[1:], groups, heads, samples)
    x = x.contiguous()
    out = torch.empty_like(x)
    ws = [a.contiguous() for a in args[1:]]
    blocks = -(-b // samples)
    scratch = (x.new_empty(blocks * scratch_floats(t, c, heads, samples, mode))
               if mode else None)
    K3.launch("attn_block_f32", common.ptr(x), *map(common.ptr, ws),
              common.ptr(out), ctypes.c_void_p(
                  None if scratch is None else scratch.data_ptr()),
              b, t, c, groups, heads, samples, mode,
              smem_bytes(t, c, groups, heads, samples, mode),
              1.0 / math.sqrt(math.sqrt(c // heads)))
    return out


def _launch_bf16(x, params, groups, heads, samples):
    """``attn_block_bf16``: the weights cast to bf16 and transposed (one
    copy each), the qk scale rounded to bf16."""
    gn_scale, gn_bias, wqkv, bqkv, wproj, bproj = (
        a.contiguous() for a in params)
    b, t, c = x.shape
    x = x.contiguous()
    out = torch.empty_like(x)
    wq = torch.empty(3 * c, c, dtype=x.dtype, device=x.device)
    wq.copy_(wqkv.t())
    wp = torch.empty(c, c, dtype=x.dtype, device=x.device)
    wp.copy_(wproj.t())
    scale = float(torch.tensor(1.0 / math.sqrt(math.sqrt(c // heads)),
                               dtype=torch.bfloat16))
    K3.launch("attn_block_bf16", *map(common.ptr, (
        x, gn_scale, gn_bias, wq, bqkv, wp, bproj, out)),
        b, t, c, groups, heads, samples,
        smem_bytes(t, c, groups, heads, samples, 0, x.dtype), scale)
    return out


AttnBlock = common.kernel_function("AttnBlock", attn_block_math, _launch,
                                   attn_block_jvp, 7)


def fused_attention_block(x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj,
                          groups, heads=1):
    """x: (B, T, C) -> (B, T, C); the whole 1-8-head AttentionBlock."""
    return AttnBlock.apply(x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj,
                           groups, heads)
