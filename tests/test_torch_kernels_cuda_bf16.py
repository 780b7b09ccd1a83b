"""The bf16 variant of K3 against its plain twin on a card, at the edges of
its launch plan (``chip_smoke.py`` phase 21 holds it at grf16's shapes;
K5 and K5b bf16: tests/test_torch_kernels_cuda_groupnorm_bf16.py). Every
case is marked ``cuda`` and skips without a CUDA device; run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py

Tolerance, as phase 21: within 2e-2·max |plain| (bf16 rounds at other
places in the kernel than in the plain version), and no farther from the
fp32 plain version on the widened inputs than 1.5× the plain twin's own
distance plus 1e-3·max; one launch a call, equal bit for bit on a second
run.
"""

import numpy as np
import pytest
import torch

from sdeflow_tpu_torch.models.common import group_count
from sdeflow_tpu_torch.ops.kernels.attnblock import (
    K3, attn_block_math, block_plan, fused_attention_block)
from test_torch_kernels_cuda import _rand, dev  # noqa: F401

pytestmark = pytest.mark.cuda
BF = torch.bfloat16


def _rel(a, ref):
    return ((a.to(ref.dtype) - ref).abs().max() / ref.abs().max()).item()


# grf16's two shapes at the request's and the SSM step's batch; 4 heads
# (head width 16: chunk 16, V^T); B not a multiple of the 4 samples a unit
# takes at T = 16; a ragged T with head width 8 (packed 3 samples a unit,
# the select mask); C = 24 (element loads of x: C % 8 != 0) with 3 heads;
# T = 256 with 2 heads (4 row tiles, 256 keys) and with 8 heads of widths
# 4 and 8 (groups 32), which the previous bf16 design took only unfused
K3_CASES = [(1024, 64, 64, 1), (1024, 16, 128, 1), (128, 16, 128, 1),
            (16, 64, 64, 4), (5, 16, 128, 1), (3, 17, 32, 4),
            (3, 7, 24, 3), (2, 256, 64, 2), (4, 256, 32, 8), (4, 256, 64, 8)]


@pytest.mark.parametrize("b,t,c,heads", K3_CASES)
def test_attention_block_bf16_kernel_matches_plain(dev, monkeypatch, b, t,
                                                   c, heads):
    rng = np.random.default_rng(1)
    args = [(2.0 * _rand(rng, b, t, c) + 0.5).to(BF),
            1.0 + 0.1 * _rand(rng, c), 0.1 * _rand(rng, c),
            _rand(rng, c, 3 * c) / c**0.5, 0.1 * _rand(rng, 3 * c),
            _rand(rng, c, c) / c**0.5, 0.1 * _rand(rng, c)]
    args = [a.to(dev) for a in args]
    groups = group_count(c)
    assert block_plan(t, c, groups, heads, BF) is not None
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    with torch.no_grad():
        before = K3.launches
        out = fused_attention_block(*args, groups, heads)
        again = fused_attention_block(*args, groups, heads)
        torch.cuda.synchronize()
        assert K3.launches == before + 2 and out.dtype == BF
        ref = attn_block_math(*args, groups, heads).float()
        ref32 = attn_block_math(args[0].float(), *args[1:], groups, heads)
    assert (ref - args[0].float()).abs().max() > 0.1
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    assert _rel(out, ref) <= 2e-2
    mine = (out.float() - ref32).abs().max()
    theirs = (ref - ref32).abs().max()
    assert mine <= 1.5 * theirs + 1e-3 * ref32.abs().max()


