"""The exact PF-ODE likelihood of the port (eval/nll.py) and MSGM's
normalized latent density against the JAX package's
(sdeflow_tpu/eval/nll.py, sdeflow_tpu/sde/msgm.py:277-314), and the twins
of the analytic oracles of tests/test_ode.py.

Parity: ``log_latent_pdf_exact`` on the same circulant MSGM (the same r_T
and bandwidth from the same data), both norm maps; ``exact_logp`` with the
exact divergence and with the Hutchinson estimate (JAX's own probes,
``sample_v(key, (n_probes, B, d))``, injected) on the VP-SGM with the
exact score of Gaussian data N(0, Σ0) in d = 3 and on the circulant MSGM at
d = 16 with a nonlinear score, to 1e-5 relative (float32 both sides); the
dopri solve on the Gaussian oracle against JAX within the solver's
tolerance. The slice as a whole: the NLL of a grf16_dbg VorticityUNet with
flax weights carried across by ``load_flax_params`` on the MSGM at d = 256
against JAX on the same points and probes, to 1e-4 of |log p| (the score
net's own parity is 1e-4 absolute; log p sums 256 dimensions).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.eval.nll import exact_logp as jax_exact_logp
from sdeflow_tpu.eval.nll import nll_summary as jax_nll_summary
from sdeflow_tpu.ops.hutchinson import sample_v as jax_sample_v
from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu.sde.reverse import PluginReverseSDE as JaxReverse
from sdeflow_tpu.sde.sgm import SGMSde as JaxSGM
from sdeflow_tpu_torch.configs import get_preset
from sdeflow_tpu_torch.eval import nll
from sdeflow_tpu_torch.eval.nll import (
    exact_logp, nll_bits_per_dim, nll_summary)
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde

torch.set_num_threads(1)
D, DM = 3, 16
EIGVALS = np.array([0.5, 1.0, 2.0], np.float32)
Q = np.linalg.qr(np.random.default_rng(7).standard_normal((D, D)))[0].astype(
    np.float32)
COV0 = (Q @ np.diag(EIGVALS) @ Q.T).astype(np.float64)


def _gauss_score(sde, as_arr, sqrt, t, y):
    t = t.reshape(-1, 1)
    inv = 1.0 / (sde.mean_weight(t) ** 2 * as_arr(EIGVALS)[None, :]
                 + sde.var(t))
    q = as_arr(Q)
    return sqrt(sde.beta(t)) * (-((y @ q) * inv) @ q.T)


def _gauss_pair():
    kw = dict(t_epsilon=1e-4, num_steps_forward=16)
    jsde, tsde = JaxSGM.create(**kw), SGMSde.create(**kw, device="cpu")
    return (JaxReverse.create(jsde, lambda p, y, t: _gauss_score(
                jsde, jnp.asarray, jnp.sqrt, t, y), {}),
            PluginReverseSDE.create(tsde, lambda y, t: _gauss_score(
                tsde, torch.as_tensor, torch.sqrt, t, y)))


def _msgm_pair(d=DM, norm_map="log", score=None):
    tc = get_preset("grf16").train
    kw = dict(beta_min=tc.beta_min, beta_max=tc.beta_max, T=tc.T0,
              t_epsilon=tc.t_eps, num_steps_forward=tc.num_steps_forward,
              dense_tensor=False, norm_map=norm_map)
    rng = np.random.default_rng(0)
    y0 = (np.exp(0.2 * rng.standard_normal((256, 1)))
          * (3.0 + rng.standard_normal((256, d)))).astype(np.float32)
    jsde = JaxMSGM.create(jax.random.PRNGKey(1), jnp.asarray(y0),
                          estimate_norm_constant=False, **kw)
    tsde = MSGMSde.create(torch.from_numpy(y0), **kw)
    if score is None:
        score = (lambda p, y, t: (-jnp.tanh(y) * (1.0 + t.reshape(-1, 1))
                                  + 0.1 * jnp.roll(y, 1, axis=-1)), {},
                 lambda y, t: (-torch.tanh(y) * (1.0 + t.reshape(-1, 1))
                               + 0.1 * torch.roll(y, 1, dims=-1)))
    jscore, jparams, tscore = score
    return (JaxReverse.create(jsde, jscore, jparams),
            PluginReverseSDE.create(tsde, tscore), y0)


def _data(n, d, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (n, d))).astype(np.float32)


def _close(out, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("norm_map", ["log", None])
def test_log_latent_pdf_exact_matches_jax(norm_map):
    jgen, tgen, y0 = _msgm_pair(norm_map=norm_map)
    np.testing.assert_allclose(tgen.base_sde.r_T.numpy(),
                               np.asarray(jgen.base_sde.r_T), rtol=1e-6)
    np.testing.assert_allclose(float(tgen.base_sde.kde_bandwidth),
                               float(jgen.base_sde.kde_bandwidth), rtol=1e-6)
    y = np.concatenate([y0[:8], _data(8, DM, 1, scale=3.0)])
    ref = jgen.base_sde.log_latent_pdf_exact(jnp.asarray(y))
    _close(tgen.base_sde.log_latent_pdf_exact(torch.from_numpy(y)), ref)
    # SGM has none: its Gaussian latent density is already normalized
    assert not hasattr(SGMSde, "log_latent_pdf_exact")


def _probes(key, n, shape):
    return np.array(jax_sample_v(key, (n, *shape)))


@pytest.mark.parametrize("divergence", ["exact", "hutchinson"])
@pytest.mark.parametrize("arm", ["sgm", "msgm"])
def test_exact_logp_matches_jax(arm, divergence, monkeypatch):
    if arm == "sgm":
        jgen, tgen = _gauss_pair()
        x = _data(8, D, 2)
    else:
        jgen, tgen, y0 = _msgm_pair()
        x = y0[:8]
    key = jax.random.PRNGKey(4)
    n_probes = 2
    kw = dict(num_steps=6, divergence=divergence, method="rk4")
    ref_logp, ref_y = jax.jit(lambda xx: jax_exact_logp(
        jgen, xx, key, n_probes=n_probes, return_latent=True, **kw))(
        jnp.asarray(x))
    probes = (torch.from_numpy(_probes(key, n_probes, x.shape))
              if divergence == "hutchinson" else None)
    monkeypatch.setattr(nll, "JVP_ROWS", 3 * x.shape[0])  # chunks of 3
    logp, y_T = exact_logp(tgen, torch.from_numpy(x), probes=probes,
                           return_latent=True, **kw)
    _close(y_T, ref_y)
    _close(logp, ref_logp)
    if arm == "msgm":  # the reference-faithful prior, too
        ref = jax.jit(lambda xx: jax_exact_logp(
            jgen, xx, key, n_probes=n_probes, prior="model", **kw))(
            jnp.asarray(x))
        _close(exact_logp(tgen, torch.from_numpy(x), probes=probes,
                          prior="model", **kw), ref)


def _log_gauss(x):
    inv = np.linalg.inv(COV0)
    _, logdet = np.linalg.slogdet(COV0)
    quad = np.einsum("bi,ij,bj->b", x, inv, x)
    return -0.5 * (quad + logdet + D * np.log(2 * np.pi))


def _gauss_data(n, seed):
    return (np.random.default_rng(seed).standard_normal((n, D))
            @ np.linalg.cholesky(COV0).T).astype(np.float32)


def test_exact_logp_matches_the_gaussian_closed_form():
    """tests/test_ode.py:99-120: the exact divergence at 128 RK4 steps
    reproduces log N(x; 0, Σ0); Hutchinson (16 probes, 16 steps) is
    unbiased around it; bits per dimension are −log p/(d·log 2)."""
    _, tgen = _gauss_pair()
    x = torch.from_numpy(_gauss_data(64, 5))
    truth = _log_gauss(x.numpy().astype(np.float64))
    logp = exact_logp(tgen, x, num_steps=128, divergence="exact")
    np.testing.assert_allclose(logp.numpy(), truth, atol=2e-3, rtol=0)
    est = exact_logp(tgen, x, torch.Generator().manual_seed(6),
                     num_steps=16, n_probes=16)
    np.testing.assert_allclose(est.numpy(), truth, atol=0.6)
    bpd = nll_bits_per_dim(tgen, x, num_steps=64, divergence="exact")
    ref = exact_logp(tgen, x, num_steps=64, divergence="exact")
    np.testing.assert_allclose(bpd.numpy(), -ref.numpy() / (D * math.log(2)),
                               rtol=1e-6)


def test_dopri_logp_matches_jax_and_the_closed_form():
    """tests/test_ode.py:261-276: the adaptive solve of the augmented
    (y, ℓ) state to 5e-4 of the truth; against JAX's odeint on the same
    pytree within 10·(atol + rtol·|log p|) at tolerance 1e-3 (finer, its
    error estimates reach float32 rounding, see test_torch_ode.py)."""
    jgen, tgen = _gauss_pair()
    x = _gauss_data(32, 7)
    truth = _log_gauss(x.astype(np.float64))
    stats = {}
    lp, y_T = exact_logp(tgen, torch.from_numpy(x), method="dopri",
                         divergence="exact", return_latent=True, stats=stats)
    np.testing.assert_allclose(lp.numpy(), truth, atol=5e-4, rtol=0)
    assert stats["nfe"] == 2 + 6 * (stats["accepted"] + stats["rejected"])
    tol = 1e-3
    ref = jax.jit(lambda xx: jax_exact_logp(
        jgen, xx, method="dopri", divergence="exact", rtol=tol,
        atol=tol))(jnp.asarray(x))
    out = exact_logp(tgen, torch.from_numpy(x), method="dopri",
                     divergence="exact", rtol=tol, atol=tol)
    ref = np.asarray(ref)
    assert np.all(np.abs(out.numpy() - ref)
                  <= 10 * (tol + tol * np.abs(ref)))


def test_exact_divergence_chunks_agree(monkeypatch):
    """The basis tangents in chunks of any size (k·B rows a JVP) give one
    divergence: k = 1, 5 and all 16 at once."""
    _, tgen, y0 = _msgm_pair()
    x = torch.from_numpy(y0[:4])
    runs = []
    for rows in (4, 20, 64):
        monkeypatch.setattr(nll, "JVP_ROWS", rows)
        runs.append(exact_logp(tgen, x, num_steps=3, divergence="exact"))
    for r in runs[1:]:
        torch.testing.assert_close(r, runs[0], rtol=1e-6, atol=1e-5)


def test_nll_summary_matches_jax_and_drops_non_finite():
    jgen, tgen, y0 = _msgm_pair()
    x = y0[:12]
    key = jax.random.PRNGKey(8)
    ref = jax_nll_summary(jgen, jnp.asarray(x), key, num_steps=4,
                          max_points=10)
    probes = torch.from_numpy(_probes(key, 1, (10, DM)))
    out = nll_summary(tgen, torch.from_numpy(x), None, num_steps=4,
                      max_points=10, probes=probes)
    assert out["n"] == ref["n"] == 10 and out["steps"] == 4
    np.testing.assert_allclose(out["mean"], ref["mean"], rtol=1e-5)
    np.testing.assert_allclose(out["stderr"], ref["stderr"], rtol=1e-3)
    # a diverged arm: no finite value, None mean (strict JSON)
    bad = PluginReverseSDE.create(tgen.base_sde,
                                  lambda y, t: torch.full_like(y, np.nan))
    out = nll_summary(bad, torch.from_numpy(x), None, num_steps=2,
                      probes=torch.ones(1, 12, DM))
    assert out == dict(mean=None, stderr=None, n=0, steps=2)
    with pytest.raises(ValueError, match="generator or probes"):
        exact_logp(tgen, torch.from_numpy(x), num_steps=2)


def test_grf16_dbg_unet_nll_matches_jax():
    from test_torch_ode import _unet_pair

    jscore, params, tnet = _unet_pair()
    jgen, tgen, y0 = _msgm_pair(256, score=(jscore, params, tnet))
    x = y0[:2]
    key = jax.random.PRNGKey(9)
    # Euler: one net evaluation a step, so XLA compiles one JVP of the
    # U-Net, not RK4's four (36 s of compile on the CPU)
    kw = dict(num_steps=2, method="euler")
    ref = jax.jit(lambda xx: jax_exact_logp(jgen, xx, key, **kw))(
        jnp.asarray(x))
    probes = torch.from_numpy(_probes(key, 1, x.shape))
    with torch.no_grad():
        out = exact_logp(tgen, torch.from_numpy(x), probes=probes, **kw)
    ref = np.asarray(ref)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=0)
