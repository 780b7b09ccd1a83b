"""The synthetic samplers and the KDE sampler by distribution against the
JAX package's draws: Gaussian (the JAX matrix A handed over) by its means
and covariances within 4 standard errors, Cauchy by its quartiles,
GaussianCauchy's one scalar Cauchy draw per batch (and that scalar's law),
the swiss roll's radii and the KDE mixture's draws by a two-sample
Kolmogorov–Smirnov test; names, stds and the driver's samplers per arm."""

import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

import jax
import jax.numpy as jnp

from sdeflow_tpu.data import synthetic as jax_synth
from sdeflow_tpu.ops.kde import gaussian_kde_sample as jax_kde_sample
from sdeflow_tpu_torch import configs
from sdeflow_tpu_torch.data import (
    Cauchy, Gaussian, GaussianCauchy, SwissRoll)
from sdeflow_tpu_torch.experiments.driver import (
    arm_config, make_sampler, resolve_std_norm)
from sdeflow_tpu_torch.ops.kde import gaussian_kde_sample

torch.set_num_threads(1)
N = 40_000


def _g(seed):
    return torch.Generator().manual_seed(seed)


def _with_jax_matrix(ours, ref):
    ours.A = torch.from_numpy(np.array(ref.A))
    ours.std = torch.from_numpy(np.array(ref.std))
    return ours


@pytest.mark.parametrize("normalized", [False, True])
def test_gaussian_moments_match_jax(normalized):
    d = 4
    ref = jax_synth.Gaussian(jax.random.PRNGKey(0), d, True, normalized)
    ours = _with_jax_matrix(Gaussian(_g(0), d, True, normalized), ref)
    assert ours.name == ref.name
    x = ours.sample(_g(1), N).numpy().astype(np.float64)
    y = np.asarray(ref.sample(jax.random.PRNGKey(1), N), np.float64)
    cov = np.cov(y.T)
    se_mean = np.sqrt(np.diag(cov) / N)
    assert np.all(np.abs(x.mean(0) - y.mean(0)) < 4 * np.sqrt(2) * se_mean)
    # var(x_i x_j) for a Gaussian: C_ii C_jj + C_ij²
    se_cov = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov**2) / N)
    assert np.all(np.abs(np.cov(x.T) - cov) < 4 * np.sqrt(2) * se_cov)
    np.testing.assert_allclose(ours.get_std().numpy(), np.asarray(ref.std),
                               rtol=1e-6)


def test_cauchy_quartiles_match_jax():
    d = 4
    ref = jax_synth.Cauchy(jax.random.PRNGKey(0), d, correlation=True)
    ours = _with_jax_matrix(Cauchy(_g(0), d, correlation=True), ref)
    assert ours.name == ref.name == "cauchy4cor"
    x = ours.sample(_g(2), N).numpy()
    y = np.asarray(ref.sample(jax.random.PRNGKey(2), N))
    qx, qy = (np.quantile(a, [0.25, 0.5, 0.75], axis=0) for a in (x, y))
    iqr = qy[2] - qy[0]
    # a quartile's standard error is ~1.4·IQR/√N for a Cauchy law
    assert np.all(np.abs(qx - qy) < 4 * np.sqrt(2) * 1.4 * iqr / np.sqrt(N))


def test_gaussian_cauchy_shares_one_scalar_per_batch():
    ours = GaussianCauchy(_g(0), 2)
    ref = jax_synth.GaussianCauchy(jax.random.PRNGKey(0), 2)
    assert ours.name == ref.name == "gaussianCauchy2cor"
    x = ours.sample(_g(3), 64)
    g = _g(3)
    eps = ours.gaussian.sample(g, 64)
    scalar = torch.empty((1, 1)).cauchy_(generator=g)
    torch.testing.assert_close(x, eps * scalar / 50, rtol=1e-6, atol=0)
    # the scalar's law: one Cauchy draw per batch, against JAX's keys
    ours_s, ref_s = [], []
    for i in range(2000):
        g = _g(100 + i)
        gauss = ours.gaussian.sample(_g(100 + i), 1)
        ours_s.append(float(ours.sample(g, 1)[0, 0] * 50 / gauss[0, 0]))
        _, key_c = jax.random.split(jax.random.PRNGKey(i))
        ref_s.append(float(jax.random.cauchy(key_c, (1, 1))[0, 0]))
    assert ks_2samp(ours_s, ref_s).pvalue > 1e-3


def test_swissroll_radii_match_jax():
    ours = SwissRoll(device="cpu")
    x = ours.sample(_g(4), 20_000).numpy()
    y = np.asarray(jax_synth.SwissRoll().sample(jax.random.PRNGKey(4),
                                               20_000))
    assert ours.name == "swiss" and x.shape == (20_000, 2)
    assert ks_2samp(np.linalg.norm(x, axis=1),
                    np.linalg.norm(y, axis=1)).pvalue > 1e-3


def test_kde_draws_match_jax():
    centers = np.random.default_rng(5).gamma(2.0, 1.0, 300).astype(np.float32)
    ours = gaussian_kde_sample(_g(6), torch.from_numpy(centers), 0.2,
                               20_000).numpy()
    ref = np.asarray(jax_kde_sample(jax.random.PRNGKey(6),
                                    jnp.asarray(centers), 0.2, 20_000))
    assert ks_2samp(ours, ref).pvalue > 1e-3


@pytest.mark.parametrize("preset,cls", [
    ("swissroll", SwissRoll), ("gaussian", Gaussian),
    ("gaussianCauchy", GaussianCauchy), ("cauchy", Cauchy)])
def test_driver_samplers_per_arm(preset, cls):
    """make_sampler builds the preset's sampler; the SGM arm takes the
    config's normalization, the MSGM arm and swissroll none; the std that
    de-normalizes the metrics is the sampler's where normalized."""
    cfg = configs.get_preset(preset)
    d = cfg.data.dims[0]
    for is_msgm in (False, True):
        arm = arm_config(cfg, is_msgm)
        want = cfg.data.normalized and not is_msgm and preset != "swissroll"
        assert arm.data.normalized is want
        s = make_sampler(arm, d, "cpu", _g(7))
        assert isinstance(s, cls)
        assert s.name.endswith("_norm") is want
        std = resolve_std_norm(s, want, d, "cpu")
        if want:
            assert torch.equal(std, s.get_std())
        else:
            assert torch.equal(std, torch.ones(d))
        assert s.sample(_g(8), 3).shape == (3, d)
