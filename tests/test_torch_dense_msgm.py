"""The MSGM SDE with a dense G and the KDE radial prior against the JAX
package: G is drawn by the JAX SDE and handed to the port's with
``dataclasses.replace`` (the two RNGs differ), then the drift, the
diffusion action, the Itô tensor's invariant, the COO indices and the
forward solve with JAX's normals replayed (unprojected and with
``project_training_norms``) are compared at rtol 1e-5 (atol 1e-5 of the
largest value); ``make_dense_G``'s own properties on the port's draws; the
name rule; the KDE radii by a two-sample Kolmogorov–Smirnov test against
JAX's draws."""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

import jax
import jax.numpy as jnp

from sdeflow_tpu.ops import gapply as jax_gapply
from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu_torch.ops import gapply
from sdeflow_tpu_torch.ops.integrators import integrate_select
from sdeflow_tpu_torch.sde.forward import ForwardFlow
from sdeflow_tpu_torch.sde.msgm import MSGMSde

torch.set_num_threads(1)
D, STEPS, RTOL = 6, 8, 1e-5
KW = dict(beta_min=0.1, beta_max=2.0, T=1.0, t_epsilon=1e-3,
          num_steps_forward=STEPS, norm_map="log",
          estimate_norm_constant=False)


def _data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.exp(0.3 * rng.standard_normal((n, 1)))
    return (scale * rng.standard_normal((n, D))).astype(np.float32)


def _pair(project=False, **kw):
    """The JAX SDE with its dense G and the port's with the same G."""
    y0 = _data()
    kw = dict(KW, **kw)
    jsde = JaxMSGM.create(jax.random.PRNGKey(3), jnp.asarray(y0),
                          project_training_norms=project, **kw)
    tsde = MSGMSde.create(torch.from_numpy(y0),
                          generator=torch.Generator().manual_seed(3), **kw)
    tsde = dataclasses.replace(tsde, G=torch.from_numpy(np.array(jsde.G)),
                               L_G=torch.from_numpy(np.array(jsde.L_G)),
                               project_training_norms=project)
    return jsde, tsde


def _close(out, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("n", [2, 5, 16])
def test_make_dense_G_invariants(n):
    G, L_G = gapply.make_dense_G(torch.Generator().manual_seed(n), n)
    assert G.shape == (n, n, n) and L_G.shape == (n, n)
    torch.testing.assert_close(G, -G.permute(1, 0, 2), rtol=0, atol=0)
    torch.testing.assert_close(torch.trace(L_G), torch.tensor(-0.5 * n))
    torch.testing.assert_close(L_G, gapply.dense_ito_tensor(G))
    # L_G is negative semi-definite: ½Σ_k G_k G_k = −½Σ_k G_kᵀ G_k
    assert torch.linalg.eigvalsh(0.5 * (L_G + L_G.T)).max() <= 1e-6
    sde = MSGMSde.create(torch.randn(64, n), generator=torch.Generator(),
                         **KW)
    assert not sde.circulant and sde.ijk() is None
    torch.testing.assert_close(sde.beta_G(), torch.tensor(1.0))


@pytest.mark.parametrize("t", [0.3, "batch"])
def test_dense_drift_and_diffusion_match_jax(t):
    jsde, tsde = _pair()
    rng = np.random.default_rng(1)
    y = rng.standard_normal((5, D)).astype(np.float32)
    w = rng.standard_normal((5, D)).astype(np.float32)
    tt = rng.random(5).astype(np.float32) if t == "batch" else t
    jt, jy, jw = jnp.asarray(tt), jnp.asarray(y), jnp.asarray(w)
    ttt = torch.from_numpy(tt) if t == "batch" else tt
    yt, wt = torch.from_numpy(y), torch.from_numpy(w)
    _close(tsde.f(ttt, yt), jsde.f(jt, jy))
    _close(tsde.div_sigma(ttt, yt), jsde.div_sigma(jt, jy))
    _close(tsde.sigma_apply(ttt, yt, wt), jsde.sigma_apply(jt, jy, jw))
    _close(tsde.beta_G(), jsde.beta_G())
    assert tsde.ijk() is None and jsde.ijk() is None
    # the diffusion is skew in w for fixed y: yᵀ(g·w) = 0, so ‖y‖ is kept
    assert tsde.sigma_apply(ttt, yt, yt).mul(yt).sum(1).abs().max() < 1e-4


@pytest.mark.parametrize("project", [False, True])
def test_dense_forward_solve_matches_jax_with_replayed_normals(project):
    """sample (the training loss's forward perturbation) with the normals of
    JAX's key splits (sde/base.py:100-137): the generic RK4 stages, some
    samples below one grid step; with project_training_norms every state
    keeps ‖y0‖."""
    jsde, tsde = _pair(project)
    y0 = _data(6, 7)
    t = np.array([0.05, 0.3, 0.5, 0.99, 1.0, 0.11], np.float32)
    key = jax.random.PRNGKey(5)
    key_traj, key_one = jax.random.split(key)
    noise = np.stack([jax.random.normal(jax.random.fold_in(key_traj, i),
                                        y0.shape) for i in range(STEPS)])
    noise_one = np.array(jax.random.normal(key_one, y0.shape))
    ref = jax.jit(jsde.sample)(key, jnp.asarray(t), jnp.asarray(y0))
    out = tsde.sample(None, torch.from_numpy(t), torch.from_numpy(y0),
                      noise=torch.from_numpy(noise),
                      noise_one=torch.from_numpy(noise_one))
    _close(out, ref)
    norms = out.norm(dim=1) / torch.from_numpy(y0).norm(dim=1)
    if project:
        torch.testing.assert_close(norms, torch.ones(6), rtol=1e-6, atol=0)
    else:
        assert (norms - 1).abs().max() > 1e-7


def test_fused_rk4_overrides_yield_none_for_dense_G():
    """K1 and K2 never see a dense G: the fused step and solve return None
    and integrate_select falls back to the per-step loop."""
    _, tsde = _pair()
    flow = ForwardFlow(base_sde=tsde, T=tsde.T)
    x = torch.randn(3, D)
    z = torch.randn(STEPS, 3, D)
    sel = torch.tensor([0, 3, STEPS])
    assert tsde.fused_forward_rk4_step(0.0, x, 0.1, z[0]) is None
    assert tsde.fused_forward_rk4_solve_select(x, z, 0.1, sel) is None
    out = integrate_select(flow, x, None, STEPS, sel, noise=z)
    torch.testing.assert_close(out[0], x[0])
    y = x
    for i in range(STEPS):
        y = flow.rk4_step(i / STEPS, y, 1 / STEPS, (1 / STEPS) ** 0.5 * z[i])
    torch.testing.assert_close(out[2], y[2])


@pytest.mark.parametrize("dense,sampler,norm_map", [
    (True, "ecdf", None), (True, "kde", "log"), (False, "kde", None),
    (False, "ecdf", "log")])
def test_name_rule_matches_jax(dense, sampler, norm_map):
    y0 = _data(64)
    kw = dict(dense_tensor=dense, norm_sampler=sampler, norm_map=norm_map,
              estimate_norm_constant=False)
    ref = JaxMSGM.create(jax.random.PRNGKey(0), jnp.asarray(y0), **kw).name
    ours = MSGMSde.create(torch.from_numpy(y0),
                          generator=torch.Generator(), **kw).name
    assert ours == ref


@pytest.mark.parametrize("norm_map", [None, "log"])
def test_kde_radii_by_distribution_against_jax(norm_map):
    """The KDE radial prior: centre plus bandwidth·ε, negative radii clamped
    to 0 without the log map; radii near zero so the clamp is exercised."""
    rng = np.random.default_rng(2)
    y0 = (np.abs(rng.standard_normal((400, 1))) * 0.05
          * rng.standard_normal((400, D))).astype(np.float32)
    kw = dict(dense_tensor=False, norm_sampler="kde", norm_map=norm_map)
    jsde = JaxMSGM.create(jax.random.PRNGKey(0), jnp.asarray(y0), **kw)
    tsde = MSGMSde.create(torch.from_numpy(y0), **kw)
    n = 20_000
    ours = tsde.gen_radial_distribution(torch.Generator().manual_seed(1),
                                        n)[:, 0].numpy()
    ref = np.asarray(jsde.gen_radial_distribution(jax.random.PRNGKey(1),
                                                  n))[:, 0]
    assert ours.min() >= 0.0
    if norm_map is None:  # the clamp: an atom at 0 in both
        assert (ours == 0).mean() == pytest.approx((ref == 0).mean(),
                                                   abs=0.01)
    assert ks_2samp(ours, ref).pvalue > 1e-3


def test_circulant_coo_matches_jax():
    I, J, K, V = gapply.circulant_ijk(7)
    for a, b in zip((I, J, K, V), jax_gapply.circulant_ijk(7)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    G = gapply.circulant_dense(7)
    np.testing.assert_array_equal(G.numpy(),
                                  np.asarray(jax_gapply.circulant_dense(7)))
    y, w = torch.randn(4, 7), torch.randn(4, 7)
    torch.testing.assert_close(gapply.dense_sigma_apply(G, 1.3, y, w),
                               gapply.circulant_sigma_apply(1.3, y, w))
    sde = MSGMSde.create(torch.randn(32, 7), dense_tensor=False)
    for a, b in zip(sde.ijk(), (I, J, K, V)):
        assert torch.equal(a, b)
