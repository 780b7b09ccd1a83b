"""The slice as a whole: lorenz63_unet1d_dbg (UNet1D at full width, the
circulant MSGM SDE) on a 64-wide Lorenz-63 fixture written by
tools/l63_fixture.py, its MSGM arm built by both drivers (``_build_arm``
in JAX, ``build_msgm_arm`` here from the same prior samples) on the same
flax weights: the SSM loss with JAX's t, forward normals and probe v
injected, and a norm-corrected RK4 request from JAX's latents and normals
(rtol 1e-4 of the largest value, float32); ``run.main`` with --cpu and
--data-root to the end with finite metrics under the loaders' names;
``make_sampler`` on every file-backed datatype of its preset, with the
sweep's complexity, against JAX's; and ``resolve_std_norm``'s capability
check."""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu import configs as jax_configs
from sdeflow_tpu.data import filebacked as jfb
from sdeflow_tpu.experiments import driver as jax_driver
from sdeflow_tpu.ops.hutchinson import sample_v as jax_sample_v
from sdeflow_tpu.ops.integrators import integrate_sde as jax_integrate
from sdeflow_tpu_torch import configs, run
from sdeflow_tpu_torch.data import filebacked as tfb
from sdeflow_tpu_torch.experiments import driver
from sdeflow_tpu_torch.models import UNet1D
from sdeflow_tpu_torch.models.convert import load_flax_params
from sdeflow_tpu_torch.serving import make_sampler_fn
from test_torch_filebacked import (
    write_eof, write_era5, write_l96, write_ncar, write_piv, write_pod,
    write_weather)
from tools.l63_fixture import ensure_fixture

torch.set_num_threads(1)
RTOL = 1e-4
PRESET = "lorenz63_unet1d_dbg"
D, B, N_INIT, STEPS_BACK = 64, 4, 256, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref):
    ref = np.asarray(ref)
    assert np.isfinite(out).all() and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.fixture
def roots(tmp_path):
    """Both packages' data roots at a fresh directory, restored after."""
    root = tmp_path / "MSGM-data"
    root.mkdir()
    prev = jfb.get_data_root(), tfb.get_data_root()
    jfb.set_data_root(str(root))
    tfb.set_data_root(str(root))
    yield root
    jfb.set_data_root(prev[0])
    tfb.set_data_root(prev[1])


class _Rows:
    """A sampler handing out fixed rows (JAX's prior samples)."""

    def __init__(self, x):
        self.x = torch.from_numpy(np.array(x))

    def sample(self, generator, n):
        assert n == self.x.shape[0]
        return self.x


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    """The MSGM arm of lorenz63_unet1d_dbg at d = 64 in both packages, and
    a batch of data."""
    root = str(tmp_path_factory.mktemp("l63"))
    ensure_fixture(root, window_len=D, n_windows=300, stride=7)
    prev = jfb.get_data_root()
    jfb.set_data_root(root)
    try:
        jcfg = jax_configs.get_preset(PRESET)
        jarm = replace(jcfg, data=replace(jcfg.data, normalized=False))
        jsampler = jax_driver.make_sampler(jarm, 1000, jax.random.PRNGKey(0))
    finally:
        jfb.set_data_root(prev)
    assert jsampler.npdata.shape[1] == D
    key = jax.random.PRNGKey(3)
    _, jgen = jax_driver.ExperimentDriver(jcfg, make_plots=False)._build_arm(
        key, jsampler, D, True, "NormalizeLogRadius", N_INIT, False)
    # the JAX _build_arm's prior samples (its key_data)
    x_init = jsampler.sample(jax.random.split(key, 3)[1], N_INIT)
    model, gen = driver.build_msgm_arm(
        configs.get_preset(PRESET), torch.Generator().manual_seed(0), D,
        num_samples_init=N_INIT, device="cpu", sampler=_Rows(x_init))
    load_flax_params(model, jgen.a_params)
    assert isinstance(model, UNet1D)
    assert gen.base_sde.name == jgen.base_sde.name == "MSGM_sparseTenslogNorm"
    np.testing.assert_allclose(gen.base_sde.r_T.numpy(),  # norms, float32
                               np.asarray(jgen.base_sde.r_T), rtol=1e-6)
    x = np.array(jsampler.sample(jax.random.PRNGKey(4), B))
    return jgen, gen, x


def test_msgm_ssm_loss_matches_jax(arm):
    jgen, gen, x = arm
    steps = gen.base_sde.num_steps_forward
    key = jax.random.PRNGKey(12)
    ref = jax.jit(jgen.ssm)(key, jnp.asarray(x))
    key_txy, key_v = jax.random.split(key)
    key_t, key_y = jax.random.split(key_txy)
    key_traj, key_one = jax.random.split(key_y)
    noise = np.stack([jax.random.normal(jax.random.fold_in(key_traj, i),
                                        x.shape) for i in range(steps)])
    out = gen.ssm(None, torch.from_numpy(x), t=_t(jgen.sample_t(key_t, B)),
                  noise=_t(noise),
                  noise_one=_t(jax.random.normal(key_one, x.shape)),
                  v=_t(jax_sample_v(key_v, x.shape, jgen.vtype)))
    assert out.shape == (B,)
    _close(out.detach().numpy(), ref)


def test_msgm_rk4_request_matches_jax(arm):
    jgen, gen, _ = arm
    assert gen.base_sde.norm_correction and jgen.base_sde.norm_correction
    k_lat, k_solve = jax.random.split(jax.random.PRNGKey(5))
    x0 = jgen.latent_sample(k_lat, B, D)
    ref = jax.jit(lambda x: jax_integrate(
        jgen, x, k_solve, STEPS_BACK, method="rk4", norm_correction=True,
        keep_all=True))(x0)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(k_solve, i), (B, D))) for i in range(STEPS_BACK)])
    fn = make_sampler_fn(gen, B, D, STEPS_BACK, method="rk4",
                         norm_correction=True, keep_all=True, device="cpu")
    with torch.no_grad():
        out = fn(None, x0=_t(x0), noise=_t(noise)).numpy()
    _close(out, ref)
    np.testing.assert_allclose(np.linalg.norm(out[-1], axis=1),
                               np.linalg.norm(np.asarray(x0), axis=1),
                               rtol=1e-5)


def test_cli_runs_the_preset_on_the_cpu(tmp_path, roots, monkeypatch,
                                        capsys):
    monkeypatch.chdir(tmp_path)
    ensure_fixture(str(tmp_path / "l63"), window_len=D, n_windows=300,
                   stride=7)
    res = run.main(["--preset", PRESET, "--cpu", "--no-plots", "--eval-mmd",
                    "--data-root", str(tmp_path / "l63"), "--iterations", "2",
                    "--num-samples", "6", "--steps-backward", "2",
                    "--results-dir", str(tmp_path / "res")])
    assert tfb.get_data_root() == str(tmp_path / "l63")
    assert "sqrt-MMD MSGM" in capsys.readouterr().out
    for k in driver.METRICS:  # two complexitys: dbg's ntrain_maxs
        assert res[k].shape == (1, 2, 1, 1, 1) and np.isfinite(res[k]).all()
    files = os.listdir(tmp_path / "res")
    assert {"L63_1000", "L63_1000_norm"} <= set(files)
    assert any("_Unet1D_NormalizeLogRadius" in f
               for f in os.listdir(tmp_path / "res" / "L63_1000"))


# (preset, fixture writer, dim, complexity)
SAMPLERS = [
    ("piv_small", lambda r: write_piv(r, False), 16, 2**10),
    ("lorenz96", write_l96, 8, 40),
    ("pod", write_pod, 16, 3900),
    ("era5vorttemp", lambda r: write_era5(r, jfb.ERA5.DEFAULT_CITIES), 16,
     np.inf),
    ("eof_pressure", write_eof, 8, np.inf),
    ("weather_station", write_weather, 30, np.inf),
    ("ncar", write_ncar, 90, np.inf),
]


@pytest.mark.parametrize("preset,write,dim,complexity", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_make_sampler_matches_jax(roots, preset, write, dim, complexity):
    write(roots)
    ref = jax_driver.make_sampler(jax_configs.get_preset(preset), dim,
                                  jax.random.PRNGKey(0), complexity)
    ours = driver.make_sampler(configs.get_preset(preset), dim, "cpu", None,
                               complexity)
    assert type(ours).__name__ == type(ref).__name__
    assert ours.name == ref.name
    np.testing.assert_array_equal(ours.npdata.numpy(), np.asarray(ref.npdata))
    np.testing.assert_array_equal(ours.npdatatest.numpy(),
                                  np.asarray(ref.npdatatest))


def test_resolve_std_norm_checks_the_capability(roots):
    """A loader's std when the arm is normalized and the loader computed
    one; ones for a loader that standardizes inside (ncar) and for an
    unnormalized arm."""
    ensure_fixture(str(roots), window_len=16, n_windows=200, stride=3)
    write_ncar(roots)
    l63 = tfb.Lorenz63(16, normalized=True, device="cpu")
    ncar = tfb.NCARWeatherStation(10, device="cpu")
    jl63 = jfb.Lorenz63(16, normalized=True)
    got = driver.resolve_std_norm(l63, True, 16, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_driver.resolve_std_norm(jl63, True, 16)))
    assert not hasattr(ncar, "std")
    for s, norm in ((ncar, True), (l63, False)):
        assert torch.equal(driver.resolve_std_norm(s, norm, s.dim, "cpu"),
                           torch.ones(s.dim))
