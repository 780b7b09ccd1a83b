"""K6's bf16 body above T = 64 (``qkv_attention_bf16_kernel_tiled``) and
K7b's two bf16 kernels (dK/dV and dQ) against their plain twins on a card,
at the edges of their layouts: ragged T, head widths 8 to 128 (padded to
32, 64 or 128), one to four heads, and qkv rows that are not 16-byte
aligned (the element-copy path). Every case is marked ``cuda`` and skips
without a CUDA device; run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py

The gates are those of tests/test_torch_kernels_cuda_attention_bf16.py
(its ``_gates``). K7b writes every element of dqkv once from sums kept in
registers, so two runs on the same inputs agree bit for bit.
"""

import pytest
import torch

from sdeflow_tpu_torch.ops.kernels import attention as A
from test_torch_kernels_cuda import dev  # noqa: F401
from test_torch_kernels_cuda_attention_bf16 import (
    BF, BWD_TOL, _entries, _gates, _launched_bf16, _qkv)

pytestmark = pytest.mark.cuda


def _misaligned(x):
    """x's values in a contiguous tensor whose data starts 2 bytes past a
    16-byte boundary, so that the kernels take their element copies."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = buf[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16 == 2
    return out


# (B, T, C, heads, misaligned): T just past the short path (65), ragged
# (127, 1000) and whole (1024); head widths 8, 24, 40, 64, 128
K6_TILED = [(3, 65, 24, 3, False), (2, 127, 48, 2, False),
            (2, 1000, 160, 4, False), (4, 1024, 128, 1, False),
            (2, 1000, 64, 1, True), (2, 1024, 256, 2, False)]


@pytest.mark.parametrize("b,t,c,heads,misaligned", K6_TILED)
def test_k6_bf16_tiled_matches_plain(dev, b, t, c, heads, misaligned):
    qkv = _qkv(dev, b, t, 3 * c, 5)
    if misaligned:
        qkv = _misaligned(qkv)
    before = _entries(A.K6)
    with torch.no_grad():
        out = A.qkv_attention(qkv, heads)
        torch.cuda.synchronize()
        _launched_bf16(A.K6, before, "qkv_attention_bf16")
        assert out.dtype == BF and out.shape == (b, t, c)
        _gates(out, A.attention_math(qkv, heads),
               A.attention_math(qkv.float(), heads), "K6 tiled")


# (B, T, C, heads, misaligned): T ragged (1000), 2048 and 4096; head widths
# 8, 24, 40, 64 and 128
K7B_EDGES = [(2, 1000, 64, 1, False), (1, 2048, 128, 1, False),
             (2, 4096, 64, 1, False), (2, 1000, 96, 4, False),
             (1, 2048, 80, 2, False), (2, 2048, 64, 1, True),
             (1, 4096, 8, 1, False)]


@pytest.mark.parametrize("b,t,c,heads,misaligned", K7B_EDGES)
def test_k7b_bf16_matches_plain_and_repeats(dev, b, t, c, heads,
                                            misaligned):
    qkv = _qkv(dev, b, t, 3 * c, 6)
    dout = _qkv(dev, b, t, c, 7, 1.0)
    if misaligned:
        qkv, dout = _misaligned(qkv), _misaligned(dout)
    with torch.no_grad():
        out_p, lse32 = A.attention_flash_stats_math(qkv.float(), heads)
        delta = (A._heads(dout, heads).float()
                 * A._heads(out_p.to(BF), heads).float()).sum(-1)
        before = _entries(A.K7B)
        dqkv = A._launch_bwd(qkv, dout, lse32, delta, heads)
        torch.cuda.synchronize()
        _launched_bf16(A.K7B, before, "qkv_attention_bwd_bf16")
        assert dqkv.dtype == BF and dqkv.shape == qkv.shape
        _gates(dqkv, A.attention_flash_bwd_math(qkv, dout, lse32, delta,
                                                heads),
               A.attention_flash_bwd_math(qkv.float(), dout.float(), lse32,
                                          delta, heads), "K7b", BWD_TOL)
        again = A._launch_bwd(qkv, dout, lse32, delta, heads)
        torch.cuda.synchronize()
        assert torch.equal(dqkv.view(torch.int16), again.view(torch.int16))
