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
rounding points, ops/pallas/attnblock.py:88-185, on Hopper's ``wgmma``;
csrc/attnblock.cu says where it rounds and how it is laid out) as one
kernel: it reads the fp32 weights as the model holds them and rounds them
itself. Its plan (``block_plan(..., torch.bfloat16)``, a ``Bf16Plan``)
holds every shape the previous bf16 design held (the whole block in one
block's shared memory) and the T = 256 multi-head blocks that the fp32
plan holds with qkv in scratch; the widest C at small T, which fp32 holds
only with h in scratch too, has none. ``AttentionBlock`` takes the route
from the plan in x's dtype: a block without one runs unfused.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from sdeflow_tpu_torch.ops.kernels import common
from sdeflow_tpu_torch.ops.kernels.attention import (
    attention_jvp, attention_math)
from sdeflow_tpu_torch.ops.kernels.groupnorm import gn_math, gn_parts

_P, _I = ctypes.c_void_p, ctypes.c_int
K3 = common.register(common.Kernel(
    "fused_attention_block", "attnblock.cu",
    {"attn_block_f32": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
     "attn_block_bf16": [_P] * 8 + [_I] * 11 + [ctypes.c_float, _P]},
))

MAX_T = 256
MAX_HEADS = 8
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
# constants of attnblock.cu (tests/test_torch_attn_tc.py parses the source
# and holds these to them)
_PASS_ROWS, _KC, _NC, _STAGES, _PAD_A, _PAD_V, _PAD_W = 64, 64, 64, 2, 4, 8, 8
_TWO_BLOCKS = 233472 // 2 - 1024  # a block's bytes when two share an SM
# constants of the bf16 body (bf:: in attnblock.cu, held to it by
# tests/test_torch_attn_bf16_plan.py): the rows of a product, the pad of
# the x, h and O rows, the rows of a streamed weight piece, the columns of
# a product with Wproj
_BF_TILE, _BF_PAD_X, _BF_SLOT_ROWS, _BF_PROJ_N = 64, 8, 64, 64


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


class Bf16Plan(NamedTuple):
    """The bf16 kernel's launch plan: samples a unit (packed into one
    64-row tile at T ≤ 64; 1 above), the chunk of a head's width (16 or 64),
    warpgroups a block, whether the weights stay in shared memory for the
    whole block, and the x buffers a warpgroup (2: the next unit's x
    arrives while this one computes)."""
    samples: int
    chunk: int
    warpgroups: int
    resident: int
    x_buffers: int


def _bf16_dims(t, c, heads, samples, chunk):
    """attnblock.cu bf::Dims: (padded head width w, 64-row tiles a unit,
    rows a unit, keys of the score product)."""
    w = _round_up(c // heads, chunk)
    tiles = 1 if t <= 64 else -(-t // _BF_TILE)
    rows = _round_up(samples * t if t <= 64 else t, 16)
    if t > 64:
        keys = _BF_TILE * tiles
    else:
        keys = 64 if chunk == 16 or rows > 32 else 32 if rows > 16 else 16
    return w, tiles, rows, keys


def _bf16_max_warpgroups(keys):
    """bf::max_groups: the score accumulator's registers bound the
    warpgroups a block."""
    return 2 if keys <= 128 else 1


@functools.lru_cache(maxsize=None)
def _smem_bytes_bf16(t, c, groups, heads, plan):
    """attnblock.cu bf::Dims::smem: 1,024 bytes to align the base; where
    resident, W^T of Wqkv (heads·3·w rows) and of Wproj (C rounded up to
    64 rows) in 64-column blocks of 128-byte rows, bf16; the fp32 vectors
    (GroupNorm scale and bias, both padded biases) rounded up to 1,024;
    then per warpgroup, rounded up to 1,024: K (a unit's rows of w
    channels in 64-column blocks), V (the same, chunk 64) or Vᵀ (w rows of
    the keys in blocks of 64, chunk 16), the streamed weight piece (unless
    resident), the x buffers, h and, where heads > 1, O (rows of C rounded
    up to 16, + 8, bf16), and the GroupNorm's (scale, shift) per (sample,
    channel) in fp32."""
    w, _, rows, _ = _bf16_dims(t, c, heads, plan.samples, plan.chunk)
    ldx = _round_up(c, 16) + _BF_PAD_X
    nq, np_ = heads * 3 * w, _round_up(c, _BF_PROJ_N)
    arena = _round_up(
        128 * rows * -(-w // 64)
        + (2 * rows * w if plan.chunk == 64 else 128 * w * -(-rows // 64))
        + (0 if plan.resident else _BF_SLOT_ROWS * 128)
        + (plan.x_buffers + 1 + (heads > 1)) * 2 * rows * ldx
        + 8 * plan.samples * _round_up(c, 16), 1024)
    weights = 128 * -(-c // 64) * (nq + np_) if plan.resident else 0
    vectors = _round_up(4 * (2 * c + np_ + nq), 1024)
    return 1024 + weights + vectors + plan.warpgroups * arena


@functools.lru_cache(maxsize=None)
def _block_plan_bf16(t, c, groups, heads):
    """The first plan that fits one block: weights resident, then
    streamed; a chunk of 64 (heads wider than 32), then 16; the most
    samples a unit; two x buffers, then one; the most warpgroups."""
    chunks = (16,) if c // heads <= 32 else (64, 16)
    for resident in (1, 0):
        for chunk in chunks:
            for samples in range(max(1, 64 // t) if t <= 64 else 1, 0, -1):
                keys = _bf16_dims(t, c, heads, samples, chunk)[3]
                if _smem_bytes_bf16(t, c, groups, heads, Bf16Plan(
                        samples, chunk, 1, resident, 1)) > _SMEM_LIMIT:
                    continue  # nor does any larger plan of these samples
                for x_buffers in (2, 1):
                    for wgs in range(_bf16_max_warpgroups(keys), 0, -1):
                        plan = Bf16Plan(samples, chunk, wgs, resident,
                                        x_buffers)
                        if (_smem_bytes_bf16(t, c, groups, heads, plan)
                                <= _SMEM_LIMIT):
                            return plan
    return None


def smem_bytes(t, c, groups, heads, samples, mode):
    """Dynamic shared memory of one float32 block (must match
    attnblock.cu): h/O unless mode 2, qkv in mode 0, the weight ring (2
    stages of 64 × 72), (mean, rstd) per (sample, group) and, unless mode
    2, the GroupNorm's scale and bias, the padded qkv bias and the output
    bias, float32 (bf16: ``_smem_bytes_bf16``)."""
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
    """K3's launch plan, or None where K3 does not take the shape. float32:
    (samples per block, mode), all in shared memory, with the most samples
    up to 64 rows that let two blocks share an SM (2 at T = 16 and C = 128:
    on the H100 that ran faster than 4 to a block, one block per SM), else
    the most that fit one block; then one sample with qkv in device-memory
    scratch (mode 1), then with h there too (mode 2). bfloat16: a
    ``Bf16Plan`` (``_block_plan_bf16``). Both take only shapes within
    ``MAX_T``, ``MAX_HEADS`` and the CUDA-core design's working set. The
    plan in x's dtype decides the route (``AttentionBlock``): a block
    without one runs unfused."""
    if (t > MAX_T or not 1 <= heads <= MAX_HEADS or c % heads
            or not _cuda_core_working_set_fits(t, c, groups)):
        return None
    if dtype == torch.bfloat16:
        return _block_plan_bf16(t, c, groups, heads)
    for limit in (_TWO_BLOCKS, _SMEM_LIMIT):
        for samples in range(max(1, _PASS_ROWS // _round_up(t, 16)), 0, -1):
            if smem_bytes(t, c, groups, heads, samples, 0) <= limit:
                return samples, 0
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
    if x.dtype == torch.bfloat16:
        return _launch_bf16(x, args[1:], groups, heads, plan)
    samples, mode = plan
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


def _launch_bf16(x, params, groups, heads, plan):
    """``attn_block_bf16``, one kernel: the fp32 parameters as they are,
    the qk scale rounded to bf16."""
    gn_scale, gn_bias, wqkv, bqkv, wproj, bproj = (
        a.contiguous() for a in params)
    b, t, c = x.shape
    x = x.contiguous()
    out = torch.empty_like(x)
    K3.launch("attn_block_bf16", *map(common.ptr, (
        x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj, out)),
        b, t, c, groups, heads, *plan,
        _smem_bytes_bf16(t, c, groups, heads, plan), _bf16_scale(c // heads))
    return out


@functools.lru_cache(maxsize=None)
def _bf16_scale(ch):
    """ch^-1/4 rounded to bf16."""
    return float(torch.tensor(1.0 / math.sqrt(math.sqrt(ch)),
                              dtype=torch.bfloat16))


AttnBlock = common.kernel_function("AttnBlock", attn_block_math, _launch,
                                   attn_block_jvp, 7)


def fused_attention_block(x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj,
                          groups, heads=1):
    """x: (B, T, C) -> (B, T, C); the whole 1-8-head AttentionBlock."""
    return AttnBlock.apply(x, gn_scale, gn_bias, wqkv, bqkv, wproj, bproj,
                           groups, heads)
