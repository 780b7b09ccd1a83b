"""K6 bf16's short path (T ≤ 64) on the CPU: the Python mirror of its plan
(``attention.short_bf16_plan``: units packed a tile, tiles, head width,
shared memory) held to the source's constants and to the plan's rules at
every T from 1 to 64, head widths 8, 10, 16, 30, 64 and 128 and 1 to 8
heads, at the batches of the paths and off them; every shape the previous
short path took keeps a plan. The card tests
(``test_torch_kernels_cuda_k6_bf16_short.py``) hold the mirror to the
compiled ``qkv_attention_bf16_plan``."""

import pytest
import torch

from sdeflow_tpu_torch.ops.kernels import attention as A
from test_torch_flash_tc import _constants

BF = torch.bfloat16
SMEM_MAX, SM_SMEM = 232_448, 233_472  # a block's, an SM's (1 KB a block)
BATCHES = (1, 7, 128, 1024, 5000)
SMS = (132, 114)  # the H100 SXM's SMs, and a smaller part's


def test_short_plan_constants_and_refusals():
    """The mirror's constants are the source's; T past 64, T = 0 and head
    widths past 128 have no short plan."""
    k6 = _constants("attention.cu")
    assert (k6["kShortRows"], k6["kShortStages"], k6["kShortT"]) == (
        A._K6_SHORT_ROWS, A._K6_SHORT_STAGES, A._K6_SHORT_T)
    assert k6["kShortThreads"] == 128  # one warpgroup a block
    for t, ch in [(0, 64), (65, 64), (64, 129), (1, 0)]:
        with pytest.raises(ValueError):
            A.short_bf16_plan(8, t, 1, ch, SMS[0])


@pytest.mark.parametrize("ch", [8, 10, 16, 30, 64, 128])
def test_short_plan_rules(ch):
    """Every (B, T, heads): a tile holds whole units in its 64 rows, the
    tiles cover every unit once, a tile packs as many units as fit unless
    that would leave an SM without a tile, and the shared memory holds two
    64-row slots of Q, K and V at W, with four blocks an SM at W = 64 and
    two at W = 128."""
    w = 64 if ch <= 64 else 128
    smem = 1024 + A._K6_SHORT_STAGES * 3 * 2 * A._K6_SHORT_ROWS * w
    assert smem <= SMEM_MAX and (SM_SMEM // (smem + 1024)) >= (
        4 if w == 64 else 2)
    for sms in SMS:
        for t in range(1, A._K6_SHORT_T + 1):
            fit = A._K6_SHORT_ROWS // t
            for heads in range(1, 9):
                for b in BATCHES:
                    units = b * heads
                    p = A.short_bf16_plan(b, t, heads, ch, sms)
                    assert (p.width, p.smem) == (w, smem)
                    assert p.smem == A.smem_bytes(t, ch, BF)
                    assert 1 <= p.samples <= fit
                    assert p.samples * t <= A._K6_SHORT_ROWS
                    assert (p.tiles - 1) * p.samples < units <= (
                        p.tiles * p.samples)
                    if units // sms >= fit:
                        assert p.samples == fit
                    else:
                        assert p.samples == max(1, units // sms)
                        assert p.tiles >= min(units, sms)


@pytest.mark.parametrize("b,t,heads,ch,samples,tiles", [
    (1024, 64, 1, 64, 1, 1024), (1024, 16, 1, 128, 4, 256),
    (128, 64, 1, 64, 1, 128), (128, 16, 1, 128, 1, 128),
    (1024, 64, 4, 16, 1, 4096), (1024, 13, 1, 10, 4, 256),
    (1024, 17, 1, 30, 3, 342), (4096, 1, 1, 8, 31, 133)])
def test_short_plan_at_the_paths_and_edges(b, t, heads, ch, samples, tiles):
    """grf16's unfused request (B = 1024) and SSM step (B = 128); four
    heads of 16; T = 13 and 17 (4 and 3 units, 52 and 51 rows); T = 1;
    on an H100 SXM's 132 SMs."""
    p = A.short_bf16_plan(b, t, heads, ch, SMS[0])
    assert (p.samples, p.tiles) == (samples, tiles)
