"""K6 bf16's short path (T ≤ 64, attention.cu
``qkv_attention_bf16_kernel_short``: persistent warpgroups on wgmma, units
packed into 64-row tiles) against its plain twin on a card, at the paths'
shapes and at the edges of its plan: T = 1, 13, 17, 33, 63 and 64, head
widths not a multiple of 8 (element copies) and above 64 (W = 128),
several heads, a misaligned qkv, and the SSM step's B = 128 (one unit a
tile). Every case is marked ``cuda`` and skips without a CUDA device; run
with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py

Gates, as ``chip_smoke.py`` phase 23: within 2e-2·max |plain| of the
plain bf16 twin (``attention_math``: the JAX math version's rounding
points, the kernel the JAX body's), no farther from the fp32 plain version
on the widened inputs than 1.5× the twin's own distance plus 1e-3·max, and
equal bit for bit on a second run (each sum in one warpgroup's registers,
in one order)."""

import pytest
import torch

from sdeflow_tpu_torch.ops.kernels import attention as A
from test_torch_kernels_cuda import dev  # noqa: F401
from test_torch_kernels_cuda_attention_bf16 import (
    _entries, _gates, _launched_bf16, _qkv)

pytestmark = pytest.mark.cuda
BF = torch.bfloat16


def _same(a, b):
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def _check(dev, qkv, heads):
    b, t, c3 = qkv.shape
    before = _entries(A.K6)
    with torch.no_grad():
        out = A._launch(qkv, heads)
        again = A._launch(qkv, heads)
        torch.cuda.synchronize()
        after = _entries(A.K6)
        assert after["qkv_attention_bf16"] == before["qkv_attention_bf16"] + 2
        assert out.dtype == BF and out.shape == (b, t, c3 // 3)
        assert _same(out, again)
        _gates(out, A.attention_math(qkv, heads),
               A.attention_math(qkv.float(), heads), "K6 bf16 short")


# (B, T, C, heads): the request's and the SSM step's shapes, four heads of
# 16; T = 1 (64 units a tile), 13 (4 units, 52 rows, ch 10: element
# copies), 17 (3 units, ch 30), 33 (ch 64, two heads), 63 (ch 72: W = 128),
# 64 at ch 128 and ch 8; a last tile with fewer units (B·heads not a
# multiple of the units a tile)
SHAPES = [(1024, 64, 64, 1), (1024, 16, 128, 1), (128, 64, 64, 1),
          (128, 16, 128, 1), (1024, 64, 64, 4), (300, 1, 24, 1),
          (500, 13, 20, 2), (700, 17, 90, 3), (600, 33, 128, 2),
          (300, 63, 72, 1), (200, 64, 128, 1), (333, 64, 64, 8)]


@pytest.mark.parametrize("b,t,c,heads", SHAPES)
def test_k6_bf16_short_matches_plain(dev, b, t, c, heads):
    _check(dev, _qkv(dev, b, t, 3 * c, 11), heads)


def test_k6_bf16_short_takes_a_misaligned_qkv(dev):
    """qkv 2 bytes past a 16-byte boundary: element copies, 16-byte
    stores."""
    b, t, c = 257, 16, 64
    buf = _qkv(dev, 1, 1, b * t * 3 * c + 1, 12)
    qkv = buf.view(-1)[1:].view(b, t, 3 * c)
    assert qkv.data_ptr() % 16 != 0
    _check(dev, qkv, 1)


def test_k6_bf16_short_plan_mirror(dev):
    """short_bf16_plan with the card's SM count against the compiled plan;
    the grid is as many blocks as the SMs hold, at most one a tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, t, c, heads in SHAPES + [(1, 1, 8, 1), (4096, 8, 16, 2)]:
        ch = c // heads
        want = A.short_bf16_plan(b, t, heads, ch, sms)
        got = A.kernel_short_bf16_plan(b, t, heads, ch)
        samples, tiles, grid, per_sm, smem = got
        assert (samples, tiles, smem) == (want.samples, want.tiles,
                                          want.smem), (b, t, c, heads)
        assert per_sm >= (4 if want.width == 64 else 2)
        assert grid == min(tiles, sms * per_sm)
