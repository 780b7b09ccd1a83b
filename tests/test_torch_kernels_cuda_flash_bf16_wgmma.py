"""K4's and K7a's bf16 body on wgmma (``csrc/flash_fwd.cu``:
``flash_fwd_bf16_kernel`` and ``flash_fwd_stats_bf16_kernel``) against
their plain twins on a card, at the edges of its layout: T past one key
tile (1025), ragged (1537, 4097) and whole (2048, 4096); head widths 8, 30,
64, 100 and 128 (padded to 64 or 128); one to four heads; qkv rows that are
not 16-byte aligned (the element copies); K and V copied by the TMA (head
widths 64 and 128, aligned) and by every thread's cp.async (the others);
blocks of one and of two consumer warpgroups on either side of the grid
size that picks them (``attention.flash_fwd_bf16_rows``). Every launch
also holds the Python mirror of the rows per block to the C chooser: the
entry refuses a shared memory size that is not its block's. Every case is
marked ``cuda`` and skips without a CUDA device; run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py

The gates are those of tests/test_torch_kernels_cuda_attention_bf16.py
(its ``_gates``); K7a's lse within 1e-5 of the fp32 plain version's (the
same fp32 scores, summed in another order; ``chip_smoke.py`` phase 23's
bound). K4 and K7a are one body compiled under two symbols, so K4's out
equals K7a's bit for bit, and each repeats bit for bit from run to run.
"""

import pytest
import torch

from sdeflow_tpu_torch.ops.kernels import attention as A
from test_torch_kernels_cuda import dev  # noqa: F401
from test_torch_kernels_cuda_attention_bf16 import (
    BF, _entries, _gates, _launched_bf16, _qkv)
from test_torch_kernels_cuda_attention_bf16_tiled import _misaligned

pytestmark = pytest.mark.cuda
LSE_TOL = 1e-5


def _bits(x):
    return x.view(torch.int16) if x.dtype == BF else x.view(torch.int32)


def _stats(qkv, heads):
    """K7a twice on the same input: (out, lse), held equal bit for bit."""
    before = _entries(A.K7A)
    out, lse = A._launch_stats(qkv, heads)
    torch.cuda.synchronize()
    _launched_bf16(A.K7A, before, "qkv_attention_stats_bf16")
    again, lse_again = A._launch_stats(qkv, heads)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(again)), "K7a out repeats"
    assert torch.equal(_bits(lse), _bits(lse_again)), "K7a lse repeats"
    assert out.dtype == BF and lse.dtype == torch.float32
    return out, lse


def _hold_k7a(qkv, heads, out, lse):
    _gates(out, A.attention_flash_stats_math(qkv, heads)[0],
           A.attention_flash_stats_math(qkv.float(), heads)[0], "K7a")
    lse32 = A.attention_flash_stats_math(qkv.float(), heads)[1]
    err = (lse - lse32).abs().max().item()
    assert err <= LSE_TOL, err


# (B, T, C, heads, misaligned) and the rows per block that the grid picks:
# head widths 64, 30 (4 heads), 128, 100 (2 heads), 8; the batch-16
# request's shape and width 128 on two warpgroups; misaligned rows on
# either block; 264 blocks of 128 rows (two warpgroups) and 253 (one)
K4_K7A = [(2, 1025, 64, 1, False, 64), (1, 1537, 120, 4, False, 64),
          (2, 2048, 128, 1, False, 64), (1, 4096, 200, 2, False, 64),
          (2, 4096, 8, 1, False, 64), (16, 4096, 64, 1, False, 128),
          (9, 4096, 128, 1, False, 128), (3, 4097, 192, 3, True, 128),
          (2, 2048, 64, 1, True, 64), (2, 1537, 100, 1, True, 64),
          (24, 1408, 64, 1, False, 128), (23, 1408, 64, 1, False, 64)]


@pytest.mark.parametrize("b,t,c,heads,misaligned,rows", K4_K7A)
def test_k4_k7a_bf16_match_plain_and_agree_bit_for_bit(
        dev, b, t, c, heads, misaligned, rows):
    assert A.flash_fwd_bf16_rows(b, t, heads) == rows
    qkv = _qkv(dev, b, t, 3 * c, 8)
    if misaligned:
        qkv = _misaligned(qkv)
    with torch.no_grad():
        before = _entries(A.K4)
        out = A._launch(qkv, heads)
        torch.cuda.synchronize()
        _launched_bf16(A.K4, before, "qkv_attention_flash_bf16")
        again = A._launch(qkv, heads)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(again)), "K4 repeats"
        assert out.dtype == BF and out.shape == (b, t, c)
        _gates(out, A.attention_flash_math(qkv, heads),
               A.attention_flash_math(qkv.float(), heads), "K4")
        out7, lse = _stats(qkv, heads)
        assert torch.equal(_bits(out), _bits(out7)), "K4 out == K7a out"
        _hold_k7a(qkv, heads, out7, lse)


# K7a below K4's range (the pair takes any T): one key, one tile and a
# ragged second, the ragged T of chip_smoke.py phase 23
@pytest.mark.parametrize("b,t,c,heads", [(1, 1, 64, 1), (2, 65, 60, 2),
                                         (2, 1000, 64, 1)])
def test_k7a_bf16_short_sequences(dev, b, t, c, heads):
    qkv = _qkv(dev, b, t, 3 * c, 9)
    with torch.no_grad():
        out, lse = _stats(qkv, heads)
        _hold_k7a(qkv, heads, out, lse)
