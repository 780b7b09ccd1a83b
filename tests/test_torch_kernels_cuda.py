"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1 rtol/atol 1e-6 (the kernel rounds each product like the plain
version; only FMA-free reordering could differ); K3 rtol/atol 1e-5 (fp32
sums in another order; TF32 is off for the plain version's matmuls).
"""

import numpy as np
import pytest
import torch

from sdeflow_tpu_torch.models.common import group_count
from sdeflow_tpu_torch.ops.kernels.attnblock import (
    K3, attn_block_math, fused_attention_block)
from sdeflow_tpu_torch.ops.kernels.circulant import K1, circ_math, circulant_apply

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(1024, 256), (1000, 256), (1024, 1024),
                                   (3, 5), (2, 1)])
def test_circulant_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(0)
    y, w = _rand(rng, *shape).to(dev), _rand(rng, *shape).to(dev)
    sb = (1.0 + _rand(rng, shape[0], 1).abs()).to(dev)
    with torch.no_grad():
        before = K1.launches
        out = circulant_apply(sb, y, w)
        torch.cuda.synchronize()
        assert K1.launches == before + 1
        torch.testing.assert_close(out, circ_math(sb, y, w), rtol=1e-6,
                                   atol=1e-6)
        # a number for sqrt_beta broadcasts like the plain version
        torch.testing.assert_close(circulant_apply(2.5, y, w),
                                   circ_math(2.5, y, w), rtol=1e-6, atol=1e-6)


def test_kernels_refuse_autograd(dev):
    y = torch.ones(2, 8, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        circulant_apply(1.0, y, y)


def _block_args(rng, b, t, c, dev):
    args = [2.0 * _rand(rng, b, t, c) + 0.5, 1.0 + 0.1 * _rand(rng, c),
            0.1 * _rand(rng, c), _rand(rng, c, 3 * c) / c**0.5,
            0.1 * _rand(rng, 3 * c), _rand(rng, c, c) / c**0.5,
            0.1 * _rand(rng, c)]
    return [a.to(dev) for a in args]


@pytest.mark.parametrize("b,t,c,heads", [
    (1024, 64, 64, 1), (1024, 16, 128, 1), (1024, 64, 64, 4),
    (16, 64, 64, 8), (8, 256, 64, 2), (5, 7, 24, 3)])
def test_attention_block_kernel_matches_plain(dev, b, t, c, heads):
    args = _block_args(np.random.default_rng(1), b, t, c, dev)
    groups = group_count(c)
    with torch.no_grad():
        before = K3.launches
        out = fused_attention_block(*args, groups, heads)
        torch.cuda.synchronize()
        assert K3.launches == before + 1
        ref = attn_block_math(*args, groups, heads)
    assert (ref - args[0]).abs().max() > 0.1  # not the identity
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_attention_block_kernel_rejects_what_it_does_not_cover(dev):
    args = _block_args(np.random.default_rng(2), 2, 512, 32, dev)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="T <="):
        fused_attention_block(*args, 32, 1)
    args = [a.to(torch.bfloat16) for a in
            _block_args(np.random.default_rng(2), 2, 16, 32, dev)]
    with torch.no_grad(), pytest.raises(NotImplementedError, match="float32"):
        fused_attention_block(*args, 32, 1)
