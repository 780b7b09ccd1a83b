"""The bf16 entries of K6, K4, K7a and K7b against their plain twins on a
card, at the edges of their layouts (``chip_smoke.py`` phase 23 holds them
at the paths' shapes). Every case is marked ``cuda`` and skips without a
CUDA device; run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py

Each output is held to two gates, as phase 23: within 2e-2·max |plain| of
the plain bf16 twin (two bf16 ulps: the kernels round where the JAX kernel
bodies do, the twins of K6 and K4 where the JAX math versions do), and no
farther from the fp32 plain version on the widened bf16 inputs than 1.5×
the plain bf16 twin's own distance from it, plus 1e-3·max (the rule of
tests/test_torch_bf16.py). K7a's lse within 1e-4 of the fp32 plain
version's (the same fp32 scores, summed in another order); K7b's dqkv
within 1e-2·max |plain| of ``attention_flash_bwd_math`` in bf16 (fp32 math
rounded once on both sides: at most about one bf16 ulp apart), and the
second gate against the same math unrounded. TF32 off throughout. Each
launch must land on the bf16 entry and on no float32 one.
"""

import numpy as np
import pytest
import torch

from sdeflow_tpu_torch.ops.kernels import attention as A
from test_torch_kernels_cuda import dev  # noqa: F401

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
PLAIN_TOL, LSE_TOL, BWD_TOL = 2e-2, 1e-4, 1e-2


def _qkv(dev, b, t, c, seed, scale=1.5):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(b, t, c, generator=g)).to(BF).to(dev)


def _gates(out, plain, fp32, what, tol=PLAIN_TOL):
    """Both gates; returns the two distances relative to max |plain|."""
    out, plain = out.float(), plain.float()
    assert torch.isfinite(out).all(), what
    scale = plain.abs().max().item()
    err = (out - plain).abs().max().item()
    assert err <= tol * scale, (what, err / scale)
    mine = (out - fp32).abs().max().item()
    theirs = (plain - fp32).abs().max().item()
    assert mine <= 1.5 * theirs + 1e-3 * fp32.abs().max().item(), (
        what, mine, theirs)
    return err / scale, mine / scale


def _entries(kernel):
    return dict(kernel.entry_launches)


def _launched_bf16(kernel, before, entry):
    after = _entries(kernel)
    assert after[entry] == before[entry] + 1, (entry, before, after)
    assert all(after[k] == before[k] for k in after if k != entry), after


# (B, T, C, heads): grf16's two unfused shapes (heads 1 and 4), the DSM
# step's T = 1024 level, a ragged T with head width 10 (element loads) at
# T <= 16 and T <= 64, head width 48 (padded to 64) and 10 on the tiled
# body past T = 64
K6_CASES = [(1024, 64, 64, 1), (1024, 64, 64, 4), (1024, 16, 128, 1),
            (8, 1024, 128, 1), (5, 13, 20, 2), (3, 50, 30, 3),
            (4, 100, 96, 2), (2, 300, 30, 3)]


@pytest.mark.parametrize("b,t,c,heads", K6_CASES)
def test_k6_bf16_matches_plain(dev, b, t, c, heads):
    qkv = _qkv(dev, b, t, 3 * c, 1)
    before = _entries(A.K6)
    with torch.no_grad():
        out = A.qkv_attention(qkv, heads)
        torch.cuda.synchronize()
        _launched_bf16(A.K6, before, "qkv_attention_bf16")
        assert out.dtype == BF and out.shape == (b, t, c)
        _gates(out, A.attention_math(qkv, heads),
               A.attention_math(qkv.float(), heads), "K6")


# K4 above T = 1024: head widths 64 and 30 (element loads, padded to 32)
@pytest.mark.parametrize("b,t,c,heads", [(2, 2048, 64, 1),
                                         (2, 1536, 60, 2)])
def test_k4_bf16_matches_plain(dev, b, t, c, heads):
    qkv = _qkv(dev, b, t, 3 * c, 2)
    before = _entries(A.K4)
    with torch.no_grad():
        out = A.qkv_attention(qkv, heads)
        torch.cuda.synchronize()
        _launched_bf16(A.K4, before, "qkv_attention_flash_bf16")
        _gates(out, A.attention_flash_math(qkv, heads),
               A.attention_flash_math(qkv.float(), heads), "K4")


# K7a/K7b: a ragged T, head width 128, head width 20 (element loads) with
# two heads, head width 96 (padded to 128)
@pytest.mark.parametrize("b,t,c,heads", [(2, 1000, 64, 1), (2, 2048, 128, 1),
                                         (2, 512, 40, 2), (1, 256, 96, 1)])
def test_k7_bf16_matches_plain(dev, b, t, c, heads):
    qkv = _qkv(dev, b, t, 3 * c, 3)
    dout = _qkv(dev, b, t, c, 4, 1.0)
    before = (_entries(A.K7A), _entries(A.K7B))
    with torch.no_grad():
        out, lse = A._launch_stats(qkv, heads)
        torch.cuda.synchronize()
        _launched_bf16(A.K7A, before[0], "qkv_attention_stats_bf16")
        assert out.dtype == BF and lse.dtype == torch.float32
        out_p, lse_p = A.attention_flash_stats_math(qkv, heads)
        out32, lse32 = A.attention_flash_stats_math(qkv.float(), heads)
        _gates(out, out_p, out32, "K7a")
        assert (lse - lse32).abs().max().item() <= LSE_TOL
        delta = (A._heads(dout, heads).float()
                 * A._heads(out_p, heads).float()).sum(-1)
        dqkv = A._launch_bwd(qkv, dout, lse32, delta, heads)
        torch.cuda.synchronize()
        _launched_bf16(A.K7B, before[1], "qkv_attention_bwd_bf16")
        assert dqkv.dtype == BF
        _gates(dqkv, A.attention_flash_bwd_math(qkv, dout, lse32, delta,
                                                heads),
               A.attention_flash_bwd_math(qkv.float(), dout.float(), lse32,
                                          delta, heads), "K7b", BWD_TOL)


def test_float16_raises_on_cuda(dev):
    qkv = torch.zeros(1, 64, 24, device=dev, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float16"):
        A.qkv_attention(qkv, 1)
