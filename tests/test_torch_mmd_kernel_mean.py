"""The Gaussian-kernel mean of the sample-quality metrics against the JAX
package's and against float64 numpy, with and without centring, in blocks
that do and do not divide N (a case of tests/test_torch_mmd.py, which
holds the samples, the float64 formula and the tolerances: rtol 1e-4 plus
atol 1e-9, float32 sums of up to 40,000 terms in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdeflow_tpu.eval.mmd import compute_kernel_mean as jax_kernel_mean
from sdeflow_tpu_torch.eval import compute_kernel_mean
from test_torch_mmd import ATOL, RTOL, _kernel_mean64, _pair

@pytest.mark.parametrize("block", [7, 1024])
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("d", [2, 16, 256])
def test_kernel_mean_matches_jax(d, centered, block):
    x, y = _pair(d)
    ref = float(jax_kernel_mean(jnp.asarray(x), jnp.asarray(y), block=block,
                                centered=centered))
    out = float(compute_kernel_mean(torch.from_numpy(x), torch.from_numpy(y),
                                    block=block, centered=centered))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, _kernel_mean64(x, y, centered),
                               rtol=RTOL, atol=ATOL)
