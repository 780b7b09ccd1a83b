"""Kernel K1 (circulant stencil): the port's plain version against the JAX
package's (the CUDA kernel against the plain version on a card is in
test_torch_kernels_cuda.py).

Tolerance: atol 1e-6 (float32; the plain versions round the same products
in the same order, so only the last bit may differ)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdeflow_tpu.ops.pallas.circulant import _circ_math, circulant_apply as jax_circ
from sdeflow_tpu.ops.pallas.common import force_interpret
from sdeflow_tpu_torch.ops.gapply import circulant_sigma_apply
from sdeflow_tpu_torch.ops.kernels import common
from sdeflow_tpu_torch.ops.kernels.circulant import K1, circ_math, circulant_apply

torch.set_num_threads(1)
ATOL = 1e-6


def _inputs(b, d, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, d)).astype(np.float32)
    w = rng.standard_normal((b, d)).astype(np.float32)
    sb = (1.0 + rng.random((b, 1))).astype(np.float32)
    return sb, y, w


def test_plain_matches_jax_math_and_interpret_kernel():
    sb, y, w = _inputs(300, 256)
    ref = np.asarray(_circ_math(jnp.asarray(sb), jnp.asarray(y), jnp.asarray(w)))
    with force_interpret():
        ref_kernel = np.asarray(jax_circ(jnp.asarray(sb), jnp.asarray(y),
                                         jnp.asarray(w)))
    out = circ_math(*map(torch.from_numpy, (sb, y, w))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(out, ref_kernel, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sqrt_beta", [1.3, "column", "row"])
def test_cpu_wrapper_runs_plain_version(sqrt_beta):
    sb, y, w = _inputs(5, 7, seed=1)
    yt, wt = torch.from_numpy(y), torch.from_numpy(w)
    arg = {1.3: 1.3, "column": torch.from_numpy(sb),
           "row": torch.from_numpy(sb[:, 0])}[sqrt_beta]
    col = np.full((5, 1), 1.3, np.float32) if sqrt_beta == 1.3 else sb
    before = K1.launches
    out = circulant_apply(arg, yt, wt)
    assert K1.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(
        out.numpy(), circulant_sigma_apply(torch.from_numpy(col), yt, wt).numpy(),
        rtol=0, atol=ATOL)


def test_cpu_plain_version_differentiates():
    sb, y, w = (torch.from_numpy(a) for a in _inputs(3, 8, seed=2))
    y.requires_grad_()
    assert common.use_kernel(sb, y, w) is False
    circulant_apply(sb, y, w).sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()
