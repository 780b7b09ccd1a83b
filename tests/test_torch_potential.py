"""The learned potential: ``potential_score`` and
``VorticityUNet(learn_potential=True)`` against the JAX package on the same
weights (twins of tests/test_models.py:123, 178), the SSM loss and its
parameter gradients on a potential net against ``jax.grad`` of JAX's
``ssm_loss`` with the same t, y and probe v, a request with JAX's noise
injected, and the checkpointed net under the SSM loss's JVP.

Every parameter is random (the zero-initialised layers too). Tolerances:
the score atol 1e-4·max |score| (a reverse pass through a few tens of
layers, sums in another order); the loss rtol 1e-4 and the gradients
within 1e-3 of the largest (the ROADMAP's training gates); the request
within 1e-4 of the largest state."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.models.unet2d import (
    UNetModel as JaxUNetModel, potential_score as jax_potential_score)
from sdeflow_tpu.models.vorticity import VorticityUNet as JaxVorticityUNet
from sdeflow_tpu.ops.hutchinson import sample_v as jax_sample_v
from sdeflow_tpu.ops.integrators import integrate_sde as jax_integrate
from sdeflow_tpu.sde import PluginReverseSDE as JaxReverse
from sdeflow_tpu.sde import SGMSde as JaxSGM
from sdeflow_tpu_torch.models.convert import (
    load_flax_params, state_dict_to_flax)
from sdeflow_tpu_torch.models.unet2d import UNetModel, potential_score
from sdeflow_tpu_torch.models.vorticity import VorticityUNet
from sdeflow_tpu_torch.ops.integrators import integrate_sde
from sdeflow_tpu_torch.sde import PluginReverseSDE, SGMSde
from test_torch_models import randomize

torch.set_num_threads(1)
B, SPACE = 3, 8
D = SPACE * SPACE
NET = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
           attention_resolutions=(2,), in_space=SPACE,
           premodule="NormalizeLogRadius", learn_potential=True)
STEPS = 3


def _params(jmodel, args, seed):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)
    return randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]),
        np.random.default_rng(seed))


@pytest.fixture(scope="module")
def vort():
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((B, D))).astype(np.float32)
    t = rng.uniform(0.05, 1.0, B).astype(np.float32)
    jmodel = JaxVorticityUNet(**NET)
    params = _params(jmodel, (jnp.asarray(x), jnp.asarray(t)), 2)
    return jmodel, params, x, t


def _torch_vort(params, **kw):
    model = VorticityUNet(**dict(NET, **kw))
    load_flax_params(model, params)
    return model


def test_potential_score_matches_jax():
    rng = np.random.default_rng(0)
    arch = dict(in_channels=1, model_channels=8, out_channels=1,
                in_space=SPACE, num_res_blocks=1, attention_resolutions=(2,),
                channel_mult=(1, 2), learn_potential=True)
    jmodel = JaxUNetModel(**arch)
    x = rng.standard_normal((2, SPACE, SPACE, 1)).astype(np.float32)
    t = np.array([0.2, 0.8], np.float32)
    params = _params(jmodel, (jnp.asarray(x), jnp.asarray(t)), 3)
    tmodel = UNetModel(**arch)
    load_flax_params(tmodel, params)  # no decoder: the trees match
    assert not hasattr(tmodel, "conv_out")
    assert tmodel.mid_res1.out_conv.bias is None
    variables = {"params": params}
    pot = jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(t))
    want = np.asarray(jax.jit(lambda xx: jax_potential_score(
        jmodel, variables, xx, jnp.asarray(t)))(jnp.asarray(x)))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    tt = torch.from_numpy(t)
    got_pot = tmodel(xt, tt)
    assert got_pot.shape == ()
    np.testing.assert_allclose(float(got_pot.detach()), float(pot),
                               rtol=1e-4)
    scale = np.abs(want).max()
    for grad_mode in (True, False):  # torch.func.grad; autograd.grad
        with torch.set_grad_enabled(grad_mode):
            got = potential_score(tmodel, xt, tt)
        assert got.shape == xt.shape
        np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1),
                                   want, atol=1e-4 * scale)


def test_vorticity_learned_potential_matches_jax(vort):
    jmodel, params, x, t = vort
    want = np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t)))
    model = _torch_vort(params)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():  # the sampler's path: a local enable_grad
        sampled = model(xt, tt)
    recorded = model(xt, tt)  # autograd records: torch.func.grad
    assert recorded.requires_grad and not sampled.requires_grad
    for got in (sampled, recorded.detach()):
        assert got.shape == (B, D)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())


def _ssm_draws(seed):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((B, D))).astype(np.float32)
    y = (x + rng.standard_normal((B, D))).astype(np.float32)
    t = rng.uniform(0.1, 0.9, B).astype(np.float32)
    return x, y, t


def _jax_ssm(jmodel, params, x, y, t, key):
    jgen = JaxReverse.create(JaxSGM.create(num_steps_forward=8),
                             jmodel.apply, {"params": params})

    def loss(p):
        g = dataclasses.replace(jgen, a_params={"params": p})
        per = g.ssm_loss(key, jnp.asarray(t), jnp.asarray(x), jnp.asarray(y))
        return per.mean(), per

    (_, per), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    v = np.array(jax_sample_v(key, (B, D), jgen.vtype))
    return np.asarray(per), grads, v


def _torch_ssm(model, x, y, t, v):
    gen = PluginReverseSDE.create(
        SGMSde.create(num_steps_forward=8, device="cpu"), model)
    model.zero_grad()
    per = gen.ssm_loss(None, torch.from_numpy(t), torch.from_numpy(x),
                       torch.from_numpy(y), v=torch.from_numpy(v))
    per.mean().backward()
    return per.detach().numpy(), {k: p.grad for k, p in
                                  model.named_parameters()}


def _close_grads(got, want):
    scale = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(
        want))
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        np.testing.assert_allclose(g, np.asarray(flat_want[path]),
                                   atol=1e-3 * scale, err_msg=str(path))


def test_ssm_loss_and_gradients_on_a_potential_net_match_jax(vort):
    jmodel, params, _, _ = vort
    x, y, t = _ssm_draws(4)
    key = jax.random.PRNGKey(9)
    want, jgrads, v = _jax_ssm(jmodel, params, x, y, t, key)
    model = _torch_vort(params)
    per, grads = _torch_ssm(model, x, y, t, v)
    np.testing.assert_allclose(per, want, rtol=1e-4)
    assert all(g is not None for g in grads.values())
    _close_grads(state_dict_to_flax(grads, model), jgrads)


def test_checkpointed_potential_net_under_the_jvp(vort):
    """use_checkpoint changes no loss or gradient under the SSM loss's
    JVP: the blocks run without remat there, with one warning."""
    _, params, _, _ = vort
    x, y, t = _ssm_draws(5)
    v = np.sign(np.random.default_rng(6).standard_normal((B, D))).astype(
        np.float32)
    plain = _torch_vort(params)
    remat = _torch_vort(params, use_checkpoint=True)
    want, wgrads = _torch_ssm(plain, x, y, t, v)
    with pytest.warns(UserWarning, match="without remat"):
        got, grads = _torch_ssm(remat, x, y, t, v)
    np.testing.assert_array_equal(got, want)
    for k, g in grads.items():
        torch.testing.assert_close(g, wgrads[k], rtol=0, atol=0)


def test_request_with_injected_noise_matches_jax(vort):
    """Three EM steps of the SGM reverse SDE on the potential net, JAX's
    per-step normals injected."""
    jmodel, params, _, _ = vort
    jgen = JaxReverse.create(JaxSGM.create(num_steps_forward=8),
                             jmodel.apply, {"params": params})
    k_lat, key = jax.random.split(jax.random.PRNGKey(3))
    x0 = jgen.latent_sample(k_lat, B, D)
    ref = np.asarray(jax.jit(lambda xx: jax_integrate(
        jgen, xx, key, STEPS, method="em"))(x0))
    noise = torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), x0.shape)) for i in range(STEPS)]))
    tgen = PluginReverseSDE.create(
        SGMSde.create(num_steps_forward=8, device="cpu"),
        _torch_vort(params))
    with torch.no_grad():
        out = integrate_sde(tgen, torch.from_numpy(np.array(x0)), None,
                            STEPS, method="em", noise=noise).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
