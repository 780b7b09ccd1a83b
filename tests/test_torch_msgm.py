"""The circulant MSGM SDE and its reverse: the port against the JAX package
at fixed inputs, and the latent prior by distribution.

Tolerances (float32): rtol 1e-6 on the sorted log radii and atol 1e-5 on
the drifts and diffusion actions (β up to 80 multiplies the rounding of
products taken in another order); the latent radius law by a two-sample
Kolmogorov–Smirnov distance below 0.03 at 20k draws each."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu.sde.reverse import PluginReverseSDE as JaxReverse
from sdeflow_tpu_torch.sde.base import _tcol, beta_linear
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE

torch.set_num_threads(1)
KW = dict(beta_min=0.4, beta_max=80.0, T=1.0, t_epsilon=4e-3,
          num_steps_forward=64, dense_tensor=False, norm_sampler="ecdf",
          norm_map="log")


def _data(n=2000, d=256, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.exp(0.3 * rng.standard_normal((n, 1)))
    return (scale * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def sdes():
    y0 = _data()
    jsde = JaxMSGM.create(jax.random.PRNGKey(0), jnp.asarray(y0),
                          estimate_norm_constant=False, **KW)
    tsde = MSGMSde.create(torch.from_numpy(y0), **KW)
    return jsde, tsde


def test_create_sorted_log_radii(sdes):
    jsde, tsde = sdes
    assert tsde.dim == 256 and tsde.circulant and tsde.name == jsde.name
    r = tsde.r_T.numpy()
    assert np.all(np.diff(r) >= 0)
    np.testing.assert_allclose(r, np.asarray(jsde.r_T), rtol=1e-6, atol=0)


@pytest.mark.parametrize("t", [0.3, "batch"])
def test_drift_and_diffusion_match_jax(sdes, t):
    jsde, tsde = sdes
    rng = np.random.default_rng(1)
    y = rng.standard_normal((5, 256)).astype(np.float32)
    w = rng.standard_normal((5, 256)).astype(np.float32)
    tt = rng.random(5).astype(np.float32) if t == "batch" else t
    jt = jnp.asarray(tt)
    ttt = torch.from_numpy(tt) if t == "batch" else tt
    yt, wt = torch.from_numpy(y), torch.from_numpy(w)
    pairs = [
        (tsde.f(ttt, yt), jsde.f(jt, jnp.asarray(y))),
        (tsde.div_sigma(ttt, yt), jsde.div_sigma(jt, jnp.asarray(y))),
        (tsde.sigma_apply(ttt, yt, wt),
         jsde.sigma_apply(jt, jnp.asarray(y), jnp.asarray(w))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    assert not tsde.f_strato(ttt, yt).any()


def test_reverse_flow_matches_jax(sdes):
    jsde, tsde = sdes
    rng = np.random.default_rng(2)
    y = rng.standard_normal((4, 256)).astype(np.float32)
    w = rng.standard_normal((4, 256)).astype(np.float32)
    jgen = JaxReverse.create(
        jsde, lambda p, yy, tt: -p["s"] * yy * tt[:, None] + jnp.sin(yy),
        {"s": jnp.asarray(0.7)})
    tgen = PluginReverseSDE.create(
        tsde, lambda yy, tt: -0.7 * yy * tt[:, None] + torch.sin(yy))
    yt, wt, jy = torch.from_numpy(y), torch.from_numpy(w), jnp.asarray(y)
    for t in (0.25, 0.9):
        for lmbd in (0.0, 0.5):
            pairs = [
                (tgen.mu_strato(t, yt, lmbd), jgen.mu_strato(t, jy, lmbd)),
                (tgen.mu(t, yt, lmbd), jgen.mu(t, jy, lmbd)),
                (tgen.sigma_apply(t, yt, wt, lmbd),
                 jgen.sigma_apply(t, jy, jnp.asarray(w), lmbd)),
            ]
            for a, b in pairs:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError):
        PluginReverseSDE.create(tsde, lambda yy, tt: yy, parameterization="eps")


def test_ecdf_radius_for_given_uniforms(sdes):
    jsde, tsde = sdes
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (1000,)))
    ref = np.asarray(jsde.gen_radial_distribution(key, 1000))
    out = tsde.radii_from_uniform(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=0)


def _ks(a, b):
    grid = np.sort(np.concatenate([a, b]))
    fa = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    fb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return np.abs(fa - fb).max()


def test_latent_radius_law_by_distribution(sdes):
    jsde, tsde = sdes
    n = 20000
    g = torch.Generator().manual_seed(4)
    x = tsde.latent_sample(g, n, 256)
    assert x.shape == (n, 256)
    jx = np.asarray(jsde.latent_sample(jax.random.PRNGKey(4), n, 256))
    r, jr = x.norm(dim=1).numpy(), np.linalg.norm(jx, axis=1)
    assert _ks(r, jr) < 0.03
    # the radii follow the data's norms; the directions are isotropic
    data_r = np.linalg.norm(_data(), axis=1)
    assert _ks(r, data_r) < 0.05
    assert abs(float((x / x.norm(dim=1, keepdim=True)).mean())) < 2e-3


def test_schedule_helpers():
    assert beta_linear(0.5, 0.4, 80.0) == pytest.approx(40.2)
    y = torch.zeros(3, 4)
    assert _tcol(0.5, y) == 0.5
    assert _tcol(torch.tensor([1.0, 2.0, 3.0]), y).shape == (3, 1)
    assert _tcol(torch.tensor(2.0), y).ndim == 0
    with pytest.raises(NotImplementedError):
        MSGMSde.create(torch.ones(3, 4), dense_tensor=True)
