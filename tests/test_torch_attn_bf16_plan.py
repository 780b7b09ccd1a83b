"""K3's bf16 launch plan (``attnblock.block_plan(..., torch.bfloat16)``)
on the CPU, where the kernel cannot run.

(a) The bf16 body's ``constexpr int`` constants of csrc/attnblock.cu
against their mirrors in ops/kernels/attnblock.py, and its shared memory
(``bf::Dims::smem``) recomputed from the parsed constants against
``_smem_bytes_bf16`` for every plan of a set of shapes.
(b) Every (T, C, groups, heads) that the previous bf16 design took (the
whole block in shared memory, weights streamed through a ring; its budget
frozen below as ``_previous_plan``) still has a plan, within one block and
within the warpgroups a block may hold, so that no bf16 "auto"
AttentionBlock moves from the fused route to the unfused one; one T per
case, C up to where neither fits.
(c) The T = 256, 8-head blocks with 32 groups, which fp32 holds with qkv
in scratch, have a bf16 plan.
The C entry's own check of the same numbers is held on a card by
tests/test_torch_kernels_cuda_attn_bf16_plan.py.
"""

import pytest
import torch

from sdeflow_tpu_torch.ops.kernels import attnblock as K3
from test_torch_attn_tc import SMEM_LIMIT, _constants, _up

BF = torch.bfloat16


def _previous_plan(t, c, groups, heads):
    """Samples per block of the previous bf16 design, or None: x/h/O in
    rows of C (rounded up to 16) + 8, q and k in rows of heads·2·w + 8, vᵀ
    in rows of T (rounded up to 16) + 8 (w the head width rounded up to
    16), a ring of 2 × 64 × 72 bf16 and fp32 statistics and vectors; two
    blocks an SM if they fit, else one."""
    if (t > 256 or not 1 <= heads <= 8 or c % heads
            or not K3._cuda_core_working_set_fits(t, c, groups)):
        return None
    tp, w = _up(t, 16), _up(c // heads, 16)

    def smem(samples):
        m = samples * tp
        floats = _up(2 * samples * groups + samples * c + 3 * c
                     + 3 * heads * w, 4)
        return 4 * floats + 2 * (2 * 64 * 72 + m * (_up(c, 16) + 8)
                                 + m * (2 * heads * w + 8)
                                 + samples * heads * w * (tp + 8))
    for limit in (233_472 // 2 - 1024, SMEM_LIMIT):
        for samples in range(max(1, 64 // tp), 0, -1):
            if smem(samples) <= limit:
                return samples
    return None


def _smem_from_source(t, c, groups, heads, plan):
    """bf::Dims::smem from the constants parsed from attnblock.cu."""
    k = _constants("attnblock.cu")
    tile, pad, slot = k["kTileRows"], k["kPadX"], k["kSlotRows"]
    w = _up(c // heads, plan.chunk)
    rows = _up(plan.samples * t if t <= 64 else t, 16)
    cp = _up(c, 16)
    row_bytes = 2 * rows * (cp + pad)
    k_bytes = 128 * rows * -(-w // 64)
    v_bytes = (2 * rows * w if plan.chunk == 64
               else 128 * w * -(-rows // tile))
    arena = _up(k_bytes + v_bytes + (0 if plan.resident else slot * 128)
                + (plan.x_buffers + 1 + (heads > 1)) * row_bytes
                + 8 * plan.samples * cp, 1024)
    nq, np_ = heads * 3 * w, _up(c, k["kProjN"])
    weights = 128 * -(-c // 64) * (nq + np_) if plan.resident else 0
    return (1024 + weights + _up(4 * (2 * c + np_ + nq), 1024)
            + plan.warpgroups * arena)


def test_bf16_constants_and_shared_memory_match_the_source():
    k = _constants("attnblock.cu")
    assert (k["kTileRows"], k["kPadX"], k["kSlotRows"], k["kProjN"]) == (
        K3._BF_TILE, K3._BF_PAD_X, K3._BF_SLOT_ROWS, K3._BF_PROJ_N)
    shapes = [(64, 64, 32, 1), (16, 128, 32, 1), (64, 64, 32, 4),
              (256, 64, 32, 8), (256, 32, 32, 8), (17, 32, 32, 4),
              (7, 24, 24, 3), (1, 1232, 28, 1), (128, 144, 144, 1),
              (256, 71, 71, 1), (33, 449, 1, 1), (100, 96, 32, 3)]
    for shape in shapes:
        plan = K3.block_plan(*shape, BF)
        assert plan is not None, shape
        for variant in {plan, plan._replace(warpgroups=1),
                        plan._replace(x_buffers=1),
                        plan._replace(resident=1 - plan.resident)}:
            assert (K3._smem_bytes_bf16(*shape, variant)
                    == _smem_from_source(*shape, variant)), (shape, variant)


@pytest.mark.parametrize("t", [1, 4, 15, 16, 17, 32, 33, 48, 64, 65, 128,
                               200])
def test_bf16_plan_keeps_every_shape_the_previous_design_took(t):
    seen = 0
    for c in range(1, 1300):
        took_any = False
        for heads in [h for h in range(1, K3.MAX_HEADS + 1) if c % h == 0]:
            small = max(g for g in range(1, 33) if c % g == 0)
            for groups in {1, small, c}:
                if _previous_plan(t, c, groups, heads) is None:
                    continue
                took_any = True
                plan = K3.block_plan(t, c, groups, heads, BF)
                assert plan is not None, (t, c, groups, heads)
                keys = K3._bf16_dims(t, c, heads, plan.samples, plan.chunk)[3]
                assert plan.warpgroups <= K3._bf16_max_warpgroups(keys)
                assert (K3._smem_bytes_bf16(t, c, groups, heads, plan)
                        <= SMEM_LIMIT)
                seen += 1
        if not took_any and c > 64:
            break  # wider C was not taken either
    assert seen > 100


@pytest.mark.parametrize("c", [32, 64])
def test_bf16_plan_takes_the_t256_multihead_blocks(c):
    assert K3.block_plan(256, c, 32, 8) is not None  # fp32: qkv in scratch
    plan = K3.block_plan(256, c, 32, 8, BF)
    assert plan is not None and plan.chunk == 16  # head width 4 or 8
    assert K3._smem_bytes_bf16(256, c, 32, 8, plan) <= SMEM_LIMIT
