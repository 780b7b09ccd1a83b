"""The MLP score net, TimeMLP and the core MLP path against the JAX package:
the MLP on the same flax weights (every parameter, the output layer's too,
random and non-zero, carried by models/convert.py) in fp32 at atol 1e-5 and
in bf16 within 2e-2 of the largest output; TimeMLP with both activations
(flax's gelu is the tanh form); the SSM loss of an MLP MSGM arm with a
dense G (the JAX SDE's G handed over) with JAX's draws replayed, the loss
at rtol 1e-4 and every parameter gradient within 1e-3·max |g|; and a few
hundred port-only SGM steps on swissroll that lower the loss."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.models.common import TimeMLP as JaxTimeMLP
from sdeflow_tpu.models.common import mean_flat as jax_mean_flat
from sdeflow_tpu.models.mlp import MLP as JaxMLP
from sdeflow_tpu.ops.hutchinson import sample_v as jax_sample_v
from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu.sde.reverse import PluginReverseSDE as JaxReverse
from sdeflow_tpu_torch.data import SwissRoll
from sdeflow_tpu_torch.models.common import TimeMLP, mean_flat, zero_init_
from sdeflow_tpu_torch.models.convert import (
    load_flax_params, state_dict_to_flax)
from sdeflow_tpu_torch.models.mlp import MLP
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde
from sdeflow_tpu_torch.training import Trainer

torch.set_num_threads(1)
D, B, STEPS = 4, 16, 8


def randomize(tree, rng):
    """Random non-zero values for every leaf of a flax params tree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        scale = 1.0 / np.sqrt(shape[0]) if k == "kernel" else 0.1
        out[k] = (scale * rng.standard_normal(shape)).astype(np.float32)
    return out


def _params(jmodel, *inputs, seed=0):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, inputs))
    return randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]),
        np.random.default_rng(seed))


def _inputs(b=B, d=D, seed=1):
    rng = np.random.default_rng(seed)
    return ((2.0 * rng.standard_normal((b, d))).astype(np.float32),
            rng.random(b).astype(np.float32))


@pytest.mark.parametrize("premodule", [None, "NormalizeLogRadius"])
def test_mlp_matches_jax_fp32(premodule):
    x, t = _inputs()
    jmodel = JaxMLP(input_dim=D, premodule=premodule)
    params = _params(jmodel, x, t)
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                jnp.asarray(t))
    tmodel = load_flax_params(MLP(input_dim=D, premodule=premodule), params)
    out = tmodel(torch.from_numpy(x), torch.from_numpy(t))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)


def test_mlp_matches_jax_bf16_with_fp32_head():
    x, t = _inputs()
    jmodel = JaxMLP(input_dim=D, premodule="NormalizeLogRadius",
                    dtype=jnp.bfloat16)
    params = _params(jmodel, x, t)
    ref = np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t)))
    tmodel = load_flax_params(MLP(input_dim=D, premodule="NormalizeLogRadius",
                                  dtype=torch.bfloat16), params)
    assert tmodel.dense_out.compute_dtype == torch.float32
    out = tmodel(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
    assert out.dtype == np.float32 and ref.dtype == np.float32
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_time_mlp_matches_jax(act):
    rng = np.random.default_rng(2)
    h = rng.standard_normal((6, 8)).astype(np.float32)
    jmodel = JaxTimeMLP(emb_dim=16, act=act)
    params = _params(jmodel, h)
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(h))
    tmodel = load_flax_params(TimeMLP(8, 16, act=act), params)
    out = tmodel(torch.from_numpy(h)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)


def test_mean_flat_and_zero_init():
    a = np.random.default_rng(3).standard_normal((3, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(mean_flat(torch.from_numpy(a)).numpy(),
                               np.asarray(jax_mean_flat(jnp.asarray(a))),
                               rtol=1e-6)
    layer = zero_init_(torch.nn.Linear(3, 4))
    assert not layer.weight.any() and not layer.bias.any()


def _ssm_draws(key, x):
    """The draws of JAX's ssm(key, x) in the random-t mode
    (sde/reverse.py:258, sde/base.py:100-137), as tensors."""
    key_txy, key_v = jax.random.split(key)
    key_t, key_y = jax.random.split(key_txy)
    key_traj, key_one = jax.random.split(key_y)
    noise = [jax.random.normal(jax.random.fold_in(key_traj, i), x.shape)
             for i in range(STEPS)]
    return key_t, key_v, dict(
        noise=torch.from_numpy(np.array(np.stack(noise))),
        noise_one=torch.from_numpy(np.array(
            jax.random.normal(key_one, x.shape))),
        v=torch.from_numpy(np.array(jax_sample_v(key_v, x.shape,
                                                 "rademacher"))))


def test_ssm_loss_of_mlp_msgm_arm_matches_jax():
    """The MSGM arm of the toy presets: dense G, KDE-free ecdf prior with
    the log map, MLP with the premodule; its forward solve takes the
    generic RK4 stages."""
    rng = np.random.default_rng(4)
    y0 = (np.exp(0.3 * rng.standard_normal((256, 1)))
          * rng.standard_normal((256, D))).astype(np.float32)
    kw = dict(beta_max=2.0, num_steps_forward=STEPS, norm_map="log",
              estimate_norm_constant=False)
    jsde = JaxMSGM.create(jax.random.PRNGKey(2), jnp.asarray(y0), **kw)
    tsde = dataclasses.replace(
        MSGMSde.create(torch.from_numpy(y0), generator=torch.Generator(),
                       **kw),
        G=torch.from_numpy(np.array(jsde.G)),
        L_G=torch.from_numpy(np.array(jsde.L_G)))
    x, _ = _inputs(seed=5)
    jmodel = JaxMLP(input_dim=D, premodule="NormalizeLogRadius")
    params = _params(jmodel, x, x[:, 0], seed=6)
    jgen = JaxReverse.create(jsde, jmodel.apply, {"params": params})
    key = jax.random.PRNGKey(7)

    @jax.jit
    def ref(p):
        def mean_loss(q):
            per = jgen.replace(a_params={"params": q}).ssm(key, jnp.asarray(x))
            return per.mean(), per
        return jax.value_and_grad(mean_loss, has_aux=True)(p)

    (_, ref_per), ref_grads = ref(params)
    key_t, _, draws = _ssm_draws(key, x)
    t = torch.from_numpy(np.array(jgen.sample_t(key_t, B)))
    tmodel = load_flax_params(MLP(input_dim=D, premodule="NormalizeLogRadius"),
                              params)
    tgen = PluginReverseSDE.create(tsde, tmodel)
    per = tgen.ssm(None, torch.from_numpy(x), t=t, **draws)
    ref_per = np.asarray(ref_per)
    np.testing.assert_allclose(per.detach().numpy(), ref_per, rtol=1e-4,
                               atol=1e-4 * np.abs(ref_per).max())
    per.mean().backward()
    grads = state_dict_to_flax(
        {n: p.grad for n, p in tmodel.named_parameters()}, tmodel)
    for name, g in grads.items():
        for leaf, a in g.items():
            r = np.asarray(ref_grads[name][leaf])
            assert np.abs(a - r).max() <= 1e-3 * np.abs(r).max(), (name, leaf)


def test_port_only_swissroll_sgm_training_lowers_the_loss():
    """Three hundred SGM SSM steps of the MLP on swissroll (the JAX
    package's e2e configuration at batch 64): the mean loss of the last 50
    steps is below that of the first 50."""
    torch.manual_seed(0)
    sampler = SwissRoll(device="cpu")
    gen = PluginReverseSDE.create(
        SGMSde.create(num_steps_forward=16, device="cpu"),
        MLP(input_dim=2))
    trainer = Trainer(gen, sampler, lr=1e-3, batch_size=64,
                      print_every=10_000, log_fn=lambda s: None)
    losses = []
    step = trainer.train_step
    g = torch.Generator().manual_seed(1)

    def recorded(state, generator, x):
        state, loss = step(state, generator, x)
        losses.append(float(loss))
        return state, loss

    trainer.train_step = recorded
    trainer.run(g, 300)
    assert len(losses) == 300 and np.isfinite(losses).all()
    assert np.mean(losses[-50:]) < np.mean(losses[:50]) - 0.2
