"""Kernel K3 (fused AttentionBlock): the port's plain version against the
JAX package's, at the grf16 U-Net's two block shapes (the CUDA kernel
against the plain version on a card is in test_torch_kernels_cuda.py).

Every weight is random and non-zero (the U-Net's zero-init proj_out would
reduce the block to the identity). Tolerance: atol 1e-5 in float32 (sums
in another order; the softmax keeps errors at that scale)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdeflow_tpu.ops.pallas.attnblock import _attn_block_math, _attn_block_pallas
from sdeflow_tpu.ops.pallas.common import force_interpret
from sdeflow_tpu_torch.ops.kernels import attnblock
from sdeflow_tpu_torch.ops.kernels.attnblock import (
    attn_block_math, fused_attention_block)

torch.set_num_threads(1)
ATOL = 1e-5


def _inputs(b, t, c, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = 2.0 * f(b, t, c) + 0.5
    args = (x, 1.0 + 0.1 * f(c), 0.1 * f(c), f(c, 3 * c) / np.sqrt(c),
            0.1 * f(3 * c), f(c, c) / np.sqrt(c), 0.1 * f(c))
    return tuple(a.astype(np.float32) for a in args)


@pytest.mark.parametrize("t,c", [(64, 64), (16, 128)])
@pytest.mark.parametrize("heads", [1, 4])
def test_plain_matches_jax_math(t, c, heads):
    args = _inputs(3, t, c)
    groups = 32
    ref = np.asarray(_attn_block_math(*map(jnp.asarray, args), groups, heads))
    out = attn_block_math(*map(torch.from_numpy, args), groups, heads).numpy()
    assert np.abs(out - args[0]).max() > 0.1  # the block is not the identity
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_plain_matches_interpreted_pallas_kernel():
    args = _inputs(2, 16, 32, seed=1)
    with force_interpret():
        ref = np.asarray(_attn_block_pallas(*map(jnp.asarray, args), 8, 2))
    out = fused_attention_block(*map(torch.from_numpy, args), 8, 2).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_query_chunking_fits_shared_memory():
    # grf16's shapes run all on chip, 1 sample of 64 rows per block at
    # T = 64 and 2 samples at T = 16, two blocks to an SM; T = 256 at
    # C = 64 puts qkv in scratch
    assert attnblock.block_plan(64, 64, 32, 1) == (1, 0)
    assert attnblock.block_plan(16, 128, 32, 1) == (2, 0)
    assert attnblock.smem_bytes(16, 128, 32, 1, 2, 0) <= attnblock._TWO_BLOCKS
    assert attnblock.block_plan(64, 64, 32, 4) == (1, 0)
    samples, mode = attnblock.block_plan(256, 64, 32, 1)
    assert (samples, mode) == (1, 1)
    assert (attnblock.smem_bytes(256, 64, 32, 1, samples, mode)
            <= attnblock._SMEM_LIMIT)
    assert attnblock.block_plan(256, 256, 32, 1) is None
