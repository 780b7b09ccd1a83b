"""The slice end to end: grf16-style MSGM sampling (circulant G at d=256,
log-map ecdf prior, VorticityUNet score net, norm-corrected RK4) and the
SGM arm's (the VP SDE, no premodule, no norm correction) through the
port's make_sampler_fn against the JAX package's integrate_sde, the last
state and the whole trajectory (keep_all, with and without x0); and the
kept trajectory against the states of the solve stacked one by one.

The net is the small U-Net (base 8, mults (1, 2), one res block, attention
at 8×8) with every weight random and non-zero, carried over by
models/convert.py. x0 comes from JAX's latent_sample; the per-step normal
draws replay JAX's jax.random.normal(fold_in(k, i)). Tolerance: rtol 1e-4
(four RK4 steps of the U-Net in float32, β up to 80)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.models.vorticity import VorticityUNet as JaxVorticityUNet
from sdeflow_tpu.ops.integrators import em_step as jax_em, heun_step as jax_heun
from sdeflow_tpu.ops.integrators import integrate_sde as jax_integrate
from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu.sde.reverse import PluginReverseSDE as JaxReverse
from sdeflow_tpu.sde.sgm import SGMSde as JaxSGM
from sdeflow_tpu_torch.configs import get_preset
from sdeflow_tpu_torch.models.convert import load_flax_params
from sdeflow_tpu_torch.models.vorticity import VorticityUNet
from sdeflow_tpu_torch.ops.integrators import (
    _norm_project, em_step, heun_step, integrate_sde, rk4_step)
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde
from sdeflow_tpu_torch.serving import make_sampler_fn

torch.set_num_threads(1)
RTOL = 1e-4
B, D, STEPS = 6, 256, 4
ARCH = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), premodule="NormalizeLogRadius",
            in_space=16, flatten_order="F")


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(v, rng)
        elif k == "kernel":
            out[k] = (rng.standard_normal(v.shape)
                      / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
        else:
            base = 1.0 if k == "scale" else 0.0
            out[k] = (base + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """The same grf16-style MSGM generator in both packages."""
    tc = get_preset("grf16").train
    kw = dict(beta_min=tc.beta_min, beta_max=tc.beta_max, T=tc.T0,
              t_epsilon=tc.t_eps, num_steps_forward=tc.num_steps_forward,
              dense_tensor=tc.dense_tensor, norm_sampler=tc.norm_sampler,
              norm_map=tc.norm_map)
    rng = np.random.default_rng(0)
    y0 = (np.exp(0.2 * rng.standard_normal((512, 1)))
          * rng.standard_normal((512, D))).astype(np.float32)
    jnet = JaxVorticityUNet(**ARCH)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, D)), jnp.zeros((2,)))
    params = _randomize(shapes["params"], rng)
    # a gentler score (|a| ~ 1) keeps four steps of size 0.25 from
    # amplifying float32 rounding beyond the tolerance
    out_conv = params["core"]["conv_out"]
    out_conv["kernel"] = out_conv["kernel"] * np.float32(0.1)
    jsde = JaxMSGM.create(jax.random.PRNGKey(1), jnp.asarray(y0),
                          estimate_norm_constant=False, **kw)
    jgen = JaxReverse.create(jsde, jnet.apply, {"params": params})
    tnet = load_flax_params(VorticityUNet(**ARCH), params)
    tgen = PluginReverseSDE.create(MSGMSde.create(torch.from_numpy(y0), **kw),
                                   tnet)
    return jgen, tgen


@pytest.fixture(scope="module")
def sgm_pair():
    """The SGM arm's generator (grf16's SGM schedule, the small U-Net
    without a premodule) in both packages."""
    tc = get_preset("grf16").train
    kw = dict(beta_min=tc.beta_min_sgm, beta_max=tc.beta_max_sgm, T=tc.T0,
              t_epsilon=tc.t_eps, num_steps_forward=tc.num_steps_forward)
    rng = np.random.default_rng(1)
    arch = dict(ARCH, premodule=None)
    jnet = JaxVorticityUNet(**arch)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, D)), jnp.zeros((2,)))
    params = _randomize(shapes["params"], rng)
    out_conv = params["core"]["conv_out"]
    out_conv["kernel"] = out_conv["kernel"] * np.float32(0.1)
    jgen = JaxReverse.create(JaxSGM.create(**kw), jnet.apply,
                             {"params": params})
    tnet = load_flax_params(VorticityUNet(**arch), params)
    return jgen, PluginReverseSDE.create(SGMSde.create(**kw, device="cpu"),
                                         tnet)


def _solve_pair(jgen, tgen, keep_all=False, include_t0=False):
    """JAX's integrate_sde and the port's sampler from JAX's latent draw
    and normals, each with its base SDE's own norm_correction; returns
    (x0, port, JAX) as numpy arrays."""
    corr = bool(jgen.base_sde.norm_correction)
    assert tgen.base_sde.norm_correction is corr
    k_lat, k_solve = jax.random.split(jax.random.PRNGKey(5))
    x0 = jgen.latent_sample(k_lat, B, D)
    ref = np.asarray(jax.jit(lambda x: jax_integrate(
        jgen, x, k_solve, STEPS, method="rk4", norm_correction=corr,
        keep_all=keep_all, include_t0=include_t0))(x0))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(k_solve, i), (B, D))) for i in range(STEPS)])
    fn = make_sampler_fn(tgen, B, D, STEPS, method="rk4",
                         norm_correction=corr, keep_all=keep_all,
                         include_t0=include_t0, device="cpu")
    out = fn(None, x0=torch.from_numpy(np.array(x0)),
             noise=torch.from_numpy(noise)).numpy()
    return np.asarray(x0), out, ref


def test_sgm_sampler_matches_jax_integrate_sde(sgm_pair):
    x0, out, ref = _solve_pair(*sgm_pair)
    assert np.isfinite(out).all() and out.shape == (B, D)
    assert not np.allclose(np.linalg.norm(out, axis=1),
                           np.linalg.norm(x0, axis=1), rtol=1e-2)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=RTOL)


@pytest.fixture(scope="module")
def msgm_solve(pair):
    """The MSGM pair's whole trajectory (x0 kept) in both packages, from
    one JAX compile."""
    return _solve_pair(*pair, keep_all=True, include_t0=True)


def test_sampler_trajectory_matches_jax(msgm_solve):
    x0, out, ref = msgm_solve
    assert out.shape == (STEPS + 1, B, D)
    np.testing.assert_array_equal(out[0], x0)
    np.testing.assert_allclose(np.linalg.norm(out, axis=2),
                               np.broadcast_to(np.linalg.norm(x0, axis=1),
                                               out.shape[:2]), rtol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("include_t0", [False, True])
def test_kept_trajectory_equals_the_stacked_states(pair, include_t0):
    """integrate_sde's preallocated trajectory holds the very states that
    the solve's steps give, stacked one by one."""
    _, tgen = pair
    g = torch.Generator().manual_seed(2)
    x0 = tgen.latent_sample(g, B, D)
    noise = torch.randn(STEPS, B, D, generator=g)
    with torch.no_grad():
        traj = integrate_sde(tgen, x0, None, STEPS, norm_correction=True,
                             keep_all=True, include_t0=include_t0,
                             noise=noise)
        x, states, delta = x0, [x0] if include_t0 else [], 1.0 / STEPS
        norm0 = x0.norm(dim=-1, keepdim=True)
        for i in range(STEPS):
            x = _norm_project(rk4_step(tgen, i * delta, x, delta,
                                       delta ** 0.5 * noise[i]), norm0)
            states.append(x)
    assert torch.equal(traj, torch.stack(states))


def test_sampler_matches_jax_integrate_sde(pair, msgm_solve):
    jgen, tgen = pair
    k_lat, k_solve = jax.random.split(jax.random.PRNGKey(5))
    x0 = jgen.latent_sample(k_lat, B, D)
    ref = msgm_solve[2][-1]  # JAX's integrate_sde, its last state
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(k_solve, i), (B, D))) for i in range(STEPS)])
    fn = make_sampler_fn(tgen, B, D, STEPS, method="rk4",
                         norm_correction=True, device="cpu")
    out = fn(None, x0=torch.from_numpy(np.array(x0)),
             noise=torch.from_numpy(noise)).numpy()
    assert np.isfinite(out).all() and out.shape == (B, D)
    assert np.abs(out - np.asarray(x0)).max() > 0.1  # the solve moved
    np.testing.assert_allclose(np.linalg.norm(out, axis=1),
                               np.linalg.norm(np.asarray(x0), axis=1),
                               rtol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("name", ["em", "heun"])
def test_em_and_heun_steps_match_jax(pair, name):
    jgen, tgen = pair
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((B, D))).astype(np.float32)
    dw = (0.1 * rng.standard_normal((B, D))).astype(np.float32)
    jstep, tstep = {"em": (jax_em, em_step), "heun": (jax_heun, heun_step)}[name]
    ref = np.asarray(jax.jit(lambda xx, ww: jstep(
        jgen, jnp.float32(0.25), xx, jnp.float32(0.25), ww))(
            jnp.asarray(x), jnp.asarray(dw)))
    with torch.no_grad():
        out = tstep(tgen, 0.25, torch.from_numpy(x), 0.25,
                    torch.from_numpy(dw)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=RTOL)


def test_sampler_draws_its_own_latents_and_noise(pair):
    _, tgen = pair
    fn = make_sampler_fn(tgen, 3, D, 2, norm_correction=True, keep_all=True,
                         include_t0=True, device="cpu")
    traj = fn(torch.Generator().manual_seed(0))
    assert traj.shape == (3, 3, D) and torch.isfinite(traj).all()
    torch.testing.assert_close(traj[-1].norm(dim=1), traj[0].norm(dim=1),
                               rtol=1e-5, atol=0)
    # the PF-ODE sampler draws only its latents (ported since it raised)
    ode = make_sampler_fn(tgen, 3, D, 2, sampler="ode",
                          norm_correction=True, device="cpu")
    x = ode(torch.Generator().manual_seed(0))
    torch.testing.assert_close(x, ode(torch.Generator().manual_seed(0)),
                               rtol=0, atol=0)
    torch.testing.assert_close(x.norm(dim=1), traj[0].norm(dim=1),
                               rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="unknown sampler"):
        make_sampler_fn(tgen, 3, D, 2, sampler="pf", device="cpu")


def test_grf16_preset_and_arm_match_jax():
    from dataclasses import fields, replace

    from sdeflow_tpu.configs import get_preset as jax_preset
    from sdeflow_tpu_torch.experiments.driver import build_msgm_arm, make_model

    ours, ref = get_preset("grf16"), jax_preset("grf16")
    assert (ours.name, ours.seed) == (ref.name, ref.seed)
    for part in ("train", "sweep", "data"):
        for f in fields(getattr(ours, part)):
            assert (getattr(getattr(ours, part), f.name)
                    == getattr(getattr(ref, part), f.name)), (part, f.name)
    model, gen = build_msgm_arm(ours, torch.Generator().manual_seed(0),
                                num_samples_init=256, device="cpu")
    sde = gen.base_sde
    assert (sde.beta_min, sde.beta_max, sde.t_epsilon, sde.dim) == (
        pytest.approx(0.4), pytest.approx(80.0), pytest.approx(4e-3), 256)
    assert sde.circulant and sde.norm_map == "log" and sde.r_T.shape == (256,)
    assert model.premodule == "NormalizeLogRadius"
    assert model.flatten_order == "F"
    dit = make_model(replace(ours, train=replace(
        ours.train, nn_archi="DiT2D", dit_patch=4, dit_width=32,
        dit_depth=1)), 256, None, device="cpu")
    assert type(dit).__name__ == "DiT2D" and dit.flatten_order == "F"
    with pytest.raises(NotImplementedError, match="item 11"):
        make_model(replace(ours, train=replace(ours.train,
                                               nn_archi="Unet1D")),
                   256, None, device="cpu")
