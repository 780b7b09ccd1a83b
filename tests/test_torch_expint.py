"""The DPM-Solver exponential integrators of the port (ops/expint.py)
against the JAX package's (sdeflow_tpu/ops/expint.py), and the twins of the
analytic oracles of tests/test_expint.py.

Parity: the three time grids, ``interp`` against ``jnp.interp`` (inside,
outside and on the knots), and all six methods on the VP-SGM of grf16's SGM
arm whose drift is the exact √β·score of Gaussian data N(M0, diag(V0))
(tests/test_expint.py:25-41), from latents made with numpy, to 1e-5
relative; the stochastic methods with JAX's own normals
(``normal(fold_in(key, i))``) injected. Oracle twins: every deterministic
method carries N(0, I) to the data law, the karras grid keeps its ρ-root
affine, the stochastic ones too with their generator, and NFE accounting.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.ops.expint import _grid as jax_grid
from sdeflow_tpu.ops.expint import integrate_dpm as jax_dpm
from sdeflow_tpu.sde.reverse import PluginReverseSDE as JaxReverse
from sdeflow_tpu.sde.sgm import SGMSde as JaxSGM
from sdeflow_tpu_torch.configs import get_preset
from sdeflow_tpu_torch.ops.expint import _grid, integrate_dpm, interp, nfe
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde
from sdeflow_tpu_torch.serving import make_sampler_fn

torch.set_num_threads(1)
M0 = np.array([1.5, -0.5], np.float32)
V0 = np.array([0.6, 1.8], np.float32)
METHODS = ["dpm1", "dpm2", "dpm2m", "dpm3m", "sdpm1", "sdpm2m"]


def _a_exact(sde, lib_sqrt, as_arr, y, t):
    tc = t.reshape(-1, 1)
    alpha = sde.mean_weight(tc)
    var = alpha**2 * as_arr(V0) + sde.var(tc)
    return lib_sqrt(sde.beta(tc)) * (-(y - alpha * as_arr(M0)) / var)


@pytest.fixture(scope="module")
def gens():
    tc = get_preset("grf16").train
    kw = dict(beta_min=tc.beta_min_sgm, beta_max=tc.beta_max_sgm, T=tc.T0,
              t_epsilon=tc.t_eps, num_steps_forward=16)
    jsde, tsde = JaxSGM.create(**kw), SGMSde.create(**kw, device="cpu")
    return (JaxReverse.create(jsde, lambda p, y, t: _a_exact(
                jsde, jnp.sqrt, jnp.asarray, y, t), {}),
            PluginReverseSDE.create(tsde, lambda y, t: _a_exact(
                tsde, torch.sqrt, torch.as_tensor, y, t)))


def _x0(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 2)).astype(
        np.float32)


@pytest.mark.parametrize("grid", ["logsnr", "time", "karras"])
def test_grids_match_jax(gens, grid):
    jgen, tgen = gens
    for n in (1, 8, 33):
        ref = np.asarray(jax_grid(jgen.base_sde, n, jnp.float32, grid=grid))
        out = _grid(tgen.base_sde, n, torch.float32, grid=grid).numpy()
        assert out.shape == ref.shape == (n + 1,)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=0)
        assert np.all(np.diff(out) < 0)
        assert out[0] == np.float32(tgen.base_sde.T)
        assert out[-1] == np.float32(tgen.base_sde.t_epsilon)


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(1)
    xp = np.sort(rng.standard_normal(50)).astype(np.float32)
    xp[10] = xp[11]  # a repeated knot
    fp = rng.standard_normal(50).astype(np.float32)
    x = np.concatenate([rng.uniform(-4, 4, 200), xp, [xp[0] - 1.0,
                        xp[-1] + 1.0]]).astype(np.float32)
    ref = np.asarray(jnp.interp(x, xp, fp))
    out = interp(*(torch.from_numpy(a) for a in (x, xp, fp))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _jax_normals(key, steps, shape):
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), shape)) for i in range(steps)])


@pytest.mark.parametrize("method", METHODS)
def test_dpm_methods_match_jax(gens, method):
    jgen, tgen = gens
    x0 = _x0(64, seed=2)
    key = jax.random.PRNGKey(3)
    steps = 10
    ref = jax.jit(lambda z: jax_dpm(
        jgen, z, steps, method=method, keep_all=True, include_t0=True,
        key=key if method.startswith("sdpm") else None))(jnp.asarray(x0))
    noise = (torch.from_numpy(_jax_normals(key, steps, x0.shape))
             if method.startswith("sdpm") else None)
    out = integrate_dpm(tgen, torch.from_numpy(x0), steps, method=method,
                        keep_all=True, include_t0=True, noise=noise)
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (steps + 1, 64, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    for grid in ("time", "karras"):
        if method != "dpm2m":
            break
        ref = jax.jit(lambda z: jax_dpm(jgen, z, steps, grid=grid))(
            jnp.asarray(x0))
        out = integrate_dpm(tgen, torch.from_numpy(x0), steps, grid=grid)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(ref)).max())


def test_dpm_transports_latents_to_the_data_law(gens):
    """tests/test_expint.py:50-62, 107-122, 148-179: each method carries
    N(0, I) to N(M0, diag(V0))."""
    _, tgen = gens
    x0 = torch.from_numpy(_x0(20_000, seed=4))
    g = torch.Generator().manual_seed(5)
    for method, steps, grid in (("dpm1", 64, "logsnr"), ("dpm2", 16, "logsnr"),
                                ("dpm2m", 16, "logsnr"),
                                ("dpm3m", 16, "logsnr"),
                                ("dpm2m", 32, "karras"),
                                ("sdpm1", 16, "logsnr"),
                                ("sdpm2m", 8, "logsnr")):
        x = integrate_dpm(tgen, x0, steps, method=method, grid=grid,
                          generator=g).numpy()
        assert np.isfinite(x).all()
        np.testing.assert_allclose(x.mean(0), M0, atol=0.08,
                                   err_msg=method)
        np.testing.assert_allclose(x.var(0), V0, rtol=0.12, err_msg=method)


def test_karras_grid_follows_the_rho_schedule(gens):
    """tests/test_expint.py:144-164: σ_edm^{1/7} affine in the index."""
    sde = gens[1].base_sde
    s = _grid(sde, 32, torch.float32, grid="karras")
    sig = torch.sqrt(sde.var(s)) / sde.mean_weight(s)
    root = (sig ** (1.0 / 7.0)).numpy()
    np.testing.assert_allclose(np.diff(root, 2), 0.0, atol=2e-3)
    assert (s - _grid(sde, 32, torch.float32)).abs().max() > 1e-3


def test_stochastic_draws_rules_and_nfe(gens):
    _, tgen = gens
    x0 = torch.from_numpy(_x0(128, seed=7))
    a, b, c = (integrate_dpm(tgen, x0, 8, method="sdpm1",
                             generator=torch.Generator().manual_seed(s))
               for s in (8, 8, 9))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError, match="stochastic"):
        integrate_dpm(tgen, x0, 8, method="sdpm2m")
    with pytest.raises(ValueError, match="unknown dpm method"):
        integrate_dpm(tgen, x0, 8, method="dpm4")
    with pytest.raises(ValueError, match="unknown dpm grid"):
        integrate_dpm(tgen, x0, 4, grid="quadratic")
    y0 = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    msgm = PluginReverseSDE.create(MSGMSde.create(y0, dense_tensor=False),
                                   lambda y, t: -y)
    with pytest.raises(ValueError, match="closed-form Gaussian"):
        integrate_dpm(msgm, y0, 4)
    assert [nfe(m, 16) for m in METHODS] == [16, 32, 16, 16, 16, 16]


def test_serving_dpm_dispatch(gens):
    """A non-dpm method name under "dpm" runs dpm2m; the deterministic
    methods ignore the generator but for the latent draw."""
    _, tgen = gens
    x0 = torch.from_numpy(_x0(16, seed=11))
    fn = make_sampler_fn(tgen, 16, 2, 12, method="rk4", sampler="dpm",
                         dpm_grid="karras", device="cpu")
    torch.testing.assert_close(
        fn(torch.Generator().manual_seed(1), x0=x0),
        integrate_dpm(tgen, x0, 12, method="dpm2m", grid="karras"),
        rtol=0, atol=0)
    sfn = make_sampler_fn(tgen, 16, 2, 12, method="sdpm2m", sampler="dpm",
                          device="cpu")
    noise = torch.randn(12, 16, 2, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(
        sfn(None, x0=x0, noise=noise),
        integrate_dpm(tgen, x0, 12, method="sdpm2m", noise=noise),
        rtol=0, atol=0)
