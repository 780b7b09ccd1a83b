"""The sample-quality metrics: the port's Gaussian-kernel means (their
cases in tests/test_torch_mmd_kernel_mean.py), MMD² and sliced
Wasserstein distance against the JAX package's on the same numpy samples
and against float64 numpy formulas, the blow-up filter against
the JAX package's, and the centered MMD form at the train-to-test floor
of d = 256, where the naive form cannot resolve MMD².

Tolerances: MMD² and kernel means rtol 1e-4 plus atol 1e-9 (float32 sums
of up to 40,000 terms in another order), SWD rtol 1e-5; against float64
the same."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.eval.diagnostics import filter_blowups as jax_filter
from sdeflow_tpu.eval.mmd import compute_mmd as jax_mmd
from sdeflow_tpu.eval.mmd import sliced_wasserstein as jax_swd
from sdeflow_tpu_torch.eval import (
    compute_kernel_mean, compute_mmd, filter_blowups, sliced_wasserstein)

torch.set_num_threads(1)
N, L = 200, 128  # N is not a multiple of the block of 7
RTOL, ATOL = 1e-4, 1e-9


def _pair(d, seed=0, n=N):
    rng = np.random.default_rng(seed + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (1.1 * rng.standard_normal((n, d)) + 0.1).astype(np.float32)
    return x, y


def _kernel_mean64(x, y, centered):
    x, y = x.astype(np.float64), y.astype(np.float64)
    d = x.shape[1]
    sq = np.maximum((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
                    - 2.0 * x @ y.T, 0.0)
    return (np.expm1 if centered else np.exp)(-sq / d**2).mean()


def _mmd64(x, y):
    return (_kernel_mean64(x, x, True) + _kernel_mean64(y, y, True)
            - 2.0 * _kernel_mean64(x, y, True))


def _swd64(x, y, dirs, p=2):
    dirs = dirs.astype(np.float64)
    dirs = dirs / np.linalg.norm(dirs, axis=0, keepdims=True)
    px = np.sort(x.astype(np.float64) @ dirs, axis=0)
    py = np.sort(y.astype(np.float64) @ dirs, axis=0)
    return np.mean(np.abs(px - py) ** p) ** (1.0 / p)


def _jax_dirs(key, d):
    """The directions jax's sliced_wasserstein draws from `key`."""
    return np.array(jax.random.normal(key, (d, L), dtype=jnp.float32))


@pytest.mark.parametrize("d", [2, 16, 256])
def test_mmd_matches_jax_and_float64(d):
    x, y = _pair(d)
    ref = float(jax_mmd(jnp.asarray(x), jnp.asarray(y)))
    out = float(compute_mmd(torch.from_numpy(x), torch.from_numpy(y),
                            block=64))
    assert out > 0
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, _mmd64(x, y), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [2, 16, 256])
def test_sliced_wasserstein_matches_jax_and_float64(d):
    x, y = _pair(d)
    key = jax.random.PRNGKey(d)
    ref = float(jax_swd(key, jnp.asarray(x), jnp.asarray(y)))
    dirs = _jax_dirs(key, d)
    out = float(sliced_wasserstein(None, torch.from_numpy(x),
                                   torch.from_numpy(y),
                                   dirs=torch.from_numpy(dirs)))
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    np.testing.assert_allclose(out, _swd64(x, y, dirs), rtol=1e-5)


def test_sliced_wasserstein_draws_its_directions_and_needs_equal_counts():
    x, y = (torch.from_numpy(a) for a in _pair(16))
    a, b = (float(sliced_wasserstein(torch.Generator().manual_seed(0), x, y))
            for _ in range(2))
    assert a == b and a > 0
    c = float(sliced_wasserstein(torch.Generator().manual_seed(1), x, y))
    assert c != a
    with pytest.raises(ValueError, match="equal sample counts"):
        sliced_wasserstein(torch.Generator(), x, y[:-1])


def test_filter_blowups_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((12, 5)).astype(np.float32)
    x[1, 2] = np.nan
    x[4, 0] = np.inf
    x[5, 4] = -np.inf
    x[7, 3] = 1.5e3
    x[9, 1] = -2e3
    x[10, 0] = 999.0  # kept: |x| <= 1e3
    ref, ref_n = jax_filter(x)
    for inp in (x, torch.from_numpy(x)):
        out, n = filter_blowups(inp)
        assert isinstance(out, np.ndarray) and n == ref_n == 5
        np.testing.assert_array_equal(out, ref)


def test_centered_mmd_resolves_the_floor_where_naive_does_not():
    """Two draws of one Gaussian at d = 256, N = 1,000: MMD² ≈ 1.5e-5, the
    size of the train-to-test floor. The centered form lands within 1e-4 of
    float64; the naive k̄xx + k̄yy − 2k̄xy of uncentered means is rounded to
    multiples of ulp(1) and misses by more than 1e-3."""
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((1000, 256)).astype(np.float32)
            for _ in range(2))
    ref = _mmd64(x, y)
    assert 1e-5 < ref < 3e-5
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    centered = float(compute_mmd(tx, ty))
    naive = float(compute_kernel_mean(tx, tx) + compute_kernel_mean(ty, ty)
                  - 2.0 * compute_kernel_mean(tx, ty))
    assert abs(centered - ref) / ref < 1e-4
    assert abs(naive - ref) / ref > 1e-3


def test_metrics_leave_the_float32_matmul_precision_as_they_found_it():
    saved = torch.get_float32_matmul_precision()
    x, y = (torch.from_numpy(a) for a in _pair(16))
    try:
        torch.set_float32_matmul_precision("high")  # TF32 allowed
        compute_mmd(x, y)
        sliced_wasserstein(torch.Generator().manual_seed(0), x, y)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
