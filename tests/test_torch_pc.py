"""Predictor–corrector sampling: the Langevin corrector of the port against
the JAX package's, and the twins of tests/test_pc.py.

Parity: ``corrector_drift``, ``corrector_noise`` and ``mu_ode`` of the
SGM and the circulant MSGM reverse SDE (grf16's schedules, d = 256) on the
same states, and ``integrate_sde`` with 4 EM steps and 1 or 2 corrector
steps from JAX's latent draw, with the normals JAX draws (predictor:
``normal(fold_in(key, i))``; corrector step j after step i:
``normal(fold_in(fold_in(key, steps + 1 + i), j))``) injected. The score is
one closed-form nonlinear function written in both packages, so that the
comparison is of the SDE algebra and the corrector and not of a network's
sums. Tolerances: drifts rtol 1e-5 (with an atol of 1e-6·max for entries
that cancel); solves 1e-5·max |x| (float32, β up to 80); MSGM norms rtol
1e-5.

Twins of tests/test_pc.py:68-246 on the port: the corrector as an MCMC
kernel for the analytic marginal of VP-SGM on N(0, Σ0) data (with the JAX
tests' own tolerances), PC against a coarse predictor, the disjoint
corrector stream, MSGM's tangent directions and kept norms, the serving
program, the CLI's --corrector-steps, --snr and --compute-dtype, and the
zero-score guard."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.ops.integrators import integrate_sde as jax_integrate
from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu.sde.reverse import PluginReverseSDE as JaxReverse
from sdeflow_tpu.sde.sgm import SGMSde as JaxSGM
from sdeflow_tpu_torch import run
from sdeflow_tpu_torch.configs import get_preset
from sdeflow_tpu_torch.ops.integrators import (
    integrate_sde, langevin_corrector)
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde
from sdeflow_tpu_torch.serving import make_sampler_fn

torch.set_num_threads(1)
B, D, STEPS = 6, 256, 4


def _jax_score(params, y, t):
    return (-jnp.tanh(y) * (1.0 + t.reshape(-1, 1))
            + 0.1 * jnp.roll(y, 1, axis=-1))


def _score(y, t):
    return (-torch.tanh(y) * (1.0 + t.reshape(-1, 1))
            + 0.1 * torch.roll(y, 1, dims=-1))


@pytest.fixture(scope="module")
def arms():
    """{"sgm": (jax gen, torch gen), "msgm": ...} with grf16's schedules."""
    tc = get_preset("grf16").train
    sgm_kw = dict(beta_min=tc.beta_min_sgm, beta_max=tc.beta_max_sgm,
                  T=tc.T0, t_epsilon=tc.t_eps,
                  num_steps_forward=tc.num_steps_forward)
    msgm_kw = dict(beta_min=tc.beta_min, beta_max=tc.beta_max, T=tc.T0,
                   t_epsilon=tc.t_eps, num_steps_forward=tc.num_steps_forward,
                   dense_tensor=False, norm_sampler=tc.norm_sampler,
                   norm_map=tc.norm_map)
    rng = np.random.default_rng(0)
    y0 = (np.exp(0.2 * rng.standard_normal((512, 1)))
          * rng.standard_normal((512, D))).astype(np.float32)
    jmsgm = JaxMSGM.create(jax.random.PRNGKey(1), jnp.asarray(y0),
                           estimate_norm_constant=False, **msgm_kw)
    tmsgm = MSGMSde.create(torch.from_numpy(y0), **msgm_kw)
    return {
        "sgm": (JaxReverse.create(JaxSGM.create(**sgm_kw), _jax_score, {}),
                PluginReverseSDE.create(SGMSde.create(**sgm_kw,
                                                      device="cpu"),
                                        _score)),
        "msgm": (JaxReverse.create(jmsgm, _jax_score, {}),
                 PluginReverseSDE.create(tmsgm, _score)),
    }


def _close(out, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("arm", ["sgm", "msgm"])
def test_corrector_drift_noise_and_mu_ode_match_jax(arms, arm):
    jgen, tgen = arms[arm]
    rng = np.random.default_rng(2)
    y = (4.0 * rng.standard_normal((B, D))).astype(np.float32)
    z = rng.standard_normal((B, D)).astype(np.float32)
    ty, tz = torch.from_numpy(y), torch.from_numpy(z)
    # t = 0.9999: s = T − t below t_epsilon, clamped for the corrector
    for t in (0.3, 0.75, 0.9999):
        jt = jnp.asarray(t, jnp.float32)
        _close(tgen.corrector_drift(t, ty), jgen.corrector_drift(jt, y))
        _close(tgen.corrector_noise(t, ty, tz),
               jgen.corrector_noise(jt, y, z))
        _close(tgen.mu_ode(t, ty), jgen.mu_ode(jt, y))


def _jax_draws(key, x0, corrector_steps):
    """The normals JAX's integrate_sde draws from `key`: (predictor,
    corrector) of shapes (STEPS, B, D) and (STEPS, corrector_steps, B,
    D)."""
    pred = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), x0.shape)) for i in range(STEPS)])
    corr = np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.fold_in(key, STEPS + 1 + i), j),
        x0.shape)) for j in range(corrector_steps)]) for i in range(STEPS)])
    return torch.from_numpy(pred), torch.from_numpy(corr)


@pytest.mark.parametrize("corrector_steps", [1, 2])
@pytest.mark.parametrize("arm", ["sgm", "msgm"])
def test_integrate_sde_with_corrector_matches_jax(arms, arm,
                                                  corrector_steps):
    jgen, tgen = arms[arm]
    corr = bool(jgen.base_sde.norm_correction)
    k_lat, key = jax.random.split(jax.random.PRNGKey(5))
    x0 = jgen.latent_sample(k_lat, B, D)
    ref = np.asarray(jax.jit(lambda x: jax_integrate(
        jgen, x, key, STEPS, method="em", norm_correction=corr,
        corrector_steps=corrector_steps))(x0))
    pred, cnoise = _jax_draws(key, x0, corrector_steps)
    tx0 = torch.from_numpy(np.array(x0))
    out = integrate_sde(tgen, tx0, None, STEPS, method="em",
                        norm_correction=corr, noise=pred,
                        corrector_steps=corrector_steps,
                        corrector_noise=cnoise).numpy()
    assert np.isfinite(ref).all() and np.abs(ref - np.asarray(x0)).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    if corr:
        np.testing.assert_allclose(np.linalg.norm(out, axis=-1),
                                   np.linalg.norm(np.asarray(x0), axis=-1),
                                   rtol=1e-5)


# -- twins of tests/test_pc.py: the analytic VP-SGM oracle --------------------

ND = 3
EIGVALS = torch.tensor([0.5, 1.0, 2.0])


def _analytic_gen():
    """A PluginReverseSDE whose a is the exact g·score of the forward
    marginals of N(0, Σ0) data, Σ0 = q diag(EIGVALS) qᵀ."""
    sde = SGMSde.create(t_epsilon=1e-4, num_steps_forward=16, device="cpu")
    q, _ = np.linalg.qr(np.random.default_rng(7).standard_normal((ND, ND)))
    q = torch.from_numpy(q.astype(np.float32))

    def a(y, t):
        t = t.reshape(-1, 1)
        inv = 1.0 / (sde.mean_weight(t) ** 2 * EIGVALS[None, :]
                     + sde.var(t))
        return torch.sqrt(sde.beta(t)) * (-((y @ q) * inv) @ q.T)

    return PluginReverseSDE.create(sde, a), q @ torch.diag(EIGVALS) @ q.T


def _marginal_cov(sde, cov0, s):
    s = torch.tensor(s)
    return sde.mean_weight(s) ** 2 * cov0 + sde.var(s) * torch.eye(ND)


def _cov(x):
    return torch.from_numpy(np.cov(x.numpy().T)).float()


def test_corrector_converges_to_frozen_marginal():
    gen, cov0 = _analytic_gen()
    s = 0.5
    g = torch.Generator().manual_seed(0)
    x = 3.0 * torch.randn(20_000, ND, generator=g) + 1.5  # wrong init
    x, eps = langevin_corrector(gen, x, g, gen.T - s, 400)
    assert torch.isfinite(x).all() and (eps > 0).all()
    np.testing.assert_allclose(x.mean(0).numpy(), np.zeros(ND), atol=0.08)
    np.testing.assert_allclose(_cov(x).numpy(),
                               _marginal_cov(gen.base_sde, cov0, s).numpy(),
                               atol=0.12)


def test_corrector_leaves_marginal_invariant():
    gen, cov0 = _analytic_gen()
    s = 0.3
    cov_s = _marginal_cov(gen.base_sde, cov0, s)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(20_000, ND, generator=g) @ torch.linalg.cholesky(cov_s).T
    x2, _ = langevin_corrector(gen, x, g, gen.T - s, 50)
    np.testing.assert_allclose(_cov(x2).numpy(), cov_s.numpy(), atol=0.1)


def test_pc_beats_coarse_predictor():
    gen, cov0 = _analytic_gen()
    g = torch.Generator().manual_seed(2)
    x0 = gen.latent_sample(g, 20_000, ND)

    def cov_err(x):
        return float(torch.linalg.norm(_cov(x) - cov0))

    x_p = integrate_sde(gen, x0, torch.Generator().manual_seed(3), 6,
                        method="em")
    x_pc = integrate_sde(gen, x0, torch.Generator().manual_seed(4), 6,
                         method="em", corrector_steps=10)
    e_p, e_pc = cov_err(x_p), cov_err(x_pc)
    assert e_pc < 0.5 * e_p, (e_p, e_pc)
    np.testing.assert_allclose(_cov(x_pc).numpy(), cov0.numpy(), atol=0.25)


def test_pc_distinct_noise_from_predictor_only():
    """The corrector's normals come from streams folded off the generator,
    which they do not advance: the predictor's draws are the same with
    and without correctors."""
    gen, _ = _analytic_gen()
    x0 = gen.latent_sample(torch.Generator().manual_seed(5), 128, ND)
    runs = {}
    for c in (None, 0, 2):
        g = torch.Generator().manual_seed(6)
        kw = {} if c is None else {"corrector_steps": c}
        runs[c] = (integrate_sde(gen, x0, g, 8, method="em", **kw),
                   g.get_state())
    assert torch.equal(runs[None][0], runs[0][0])
    assert not torch.allclose(runs[None][0], runs[2][0])
    assert torch.equal(runs[None][1], runs[2][1])


def test_msgm_corrector_directions_tangent(arms):
    """g·a and g·z are orthogonal to y (G skew-symmetric); the drift adds
    the radial ∇·Σ = 2f."""
    _, tgen = arms["msgm"]
    rng = np.random.default_rng(3)
    y = torch.from_numpy((4.0 * rng.standard_normal((64, D))).astype(
        np.float32))
    z = torch.from_numpy(rng.standard_normal((64, D)).astype(np.float32))
    t = 0.4
    gz = tgen.corrector_noise(t, y, z)
    scale = (y.norm(dim=-1) * gz.norm(dim=-1)).max().item()
    assert (y * gz).sum(-1).abs().max().item() <= 1e-5 * scale
    s = max(tgen.T - t, tgen.base_sde.t_epsilon)
    ga = tgen.ga(s, y)
    scale = (y.norm(dim=-1) * ga.norm(dim=-1)).max().item()
    assert (y * ga).sum(-1).abs().max().item() <= 1e-5 * scale
    div = tgen.base_sde.div_sigma(s, y)
    torch.testing.assert_close(tgen.corrector_drift(t, y) - ga, div,
                               rtol=1e-6, atol=1e-6 * div.abs().max().item())


def test_msgm_pc_norm_preserved(arms):
    _, tgen = arms["msgm"]
    g = torch.Generator().manual_seed(7)
    lat = tgen.latent_sample(g, 128, D)
    out = integrate_sde(tgen, lat, g, 8, method="rk4", norm_correction=True,
                        corrector_steps=3)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.norm(dim=-1), lat.norm(dim=-1),
                               rtol=1e-5, atol=0)


def test_serving_pc_sampler():
    gen, _ = _analytic_gen()
    fn = make_sampler_fn(gen, 512, ND, 8, method="em", corrector_steps=4,
                         device="cpu")
    x = fn(torch.Generator().manual_seed(8))
    assert x.shape == (512, ND) and torch.isfinite(x).all()


def test_run_cli_corrector_plumbing(monkeypatch, tmp_path):
    """--corrector-steps, --snr and --compute-dtype land in the config."""
    captured = {}

    class _FakeDriver:
        def __init__(self, cfg, make_plots=True, device="cuda"):
            captured["cfg"] = cfg

        def run(self, just_load=False):
            return {}

    monkeypatch.setattr("sdeflow_tpu_torch.experiments.driver."
                        "ExperimentDriver", _FakeDriver)
    run.main(["--preset", "grf16_dbg", "--cpu", "--corrector-steps", "3",
              "--snr", "0.2", "--compute-dtype", "bfloat16", "--no-plots",
              "--results-dir", str(tmp_path / "r")])
    cfg = captured["cfg"]
    assert cfg.sweep.corrector_steps == 3
    assert cfg.sweep.snr == pytest.approx(0.2)
    assert cfg.train.compute_dtype == "bfloat16"


def test_corrector_finite_on_zero_score():
    """A zero drift takes no Langevin step (ε = 0), not an infinite one."""
    sde = SGMSde.create(num_steps_forward=4, device="cpu")
    gen = PluginReverseSDE.create(sde, lambda y, t: torch.zeros_like(y))
    g = torch.Generator().manual_seed(9)
    x = torch.randn(64, 2, generator=g)
    out, eps = langevin_corrector(gen, x, g, 0.5, 3)
    assert torch.equal(out, x) and torch.equal(eps, torch.zeros(3))
