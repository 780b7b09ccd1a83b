"""The U-Net options that no preset sets, against the JAX package's
UNetModel on the same weights (models/convert.py): class labels,
activation checkpointing, the features mode, ConditionalModel, dims 1 and
3, scale-shift norm and dropout (twins of tests/test_models.py:91, 101,
112, 135, 212).

Every parameter, the zero-initialised output layers included, is
overwritten with random values, so that every block does work. Tolerance:
atol 1e-4 in float32 (a few tens of layers, sums in another order); the
checkpointed net against the plain one: equal values, gradients within
1e-6 of the largest (the same kernels rerun)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.models.unet2d import (
    ConditionalModel as JaxConditionalModel, UNetModel as JaxUNetModel)
from sdeflow_tpu_torch.models.convert import (
    load_flax_params, state_dict_to_flax)
from sdeflow_tpu_torch.models.unet2d import (
    ConditionalModel, ResBlock, UNetModel)
from test_torch_models import randomize

torch.set_num_threads(1)
ATOL = 1e-4
TINY = dict(in_channels=1, model_channels=8, out_channels=1, in_space=8,
            num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2))


def _cf(a):
    """channels-last numpy -> channels-first torch."""
    a = np.asarray(a)
    return torch.from_numpy(np.moveaxis(a, -1, 1).copy())


def _cl(t):
    """channels-first torch -> channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _pair(seed=0, batch=2, space=8, jax_cls=None, torch_wrap=None,
          in_channels=1, labels=None, **kw):
    """(jax model, params, torch model, x channels-last, t) on random
    weights; kw are the options of both UNetModels."""
    rng = np.random.default_rng(seed)
    arch = dict(TINY, in_space=space, in_channels=in_channels, **kw)
    dims = arch.get("dims", 2)
    jmodel = JaxUNetModel(**arch)
    tmodel = UNetModel(**arch)
    if jax_cls is not None:
        jmodel, tmodel = jax_cls(core=jmodel), torch_wrap(tmodel)
    x = rng.standard_normal((batch, *(space,) * dims, 1)).astype(np.float32)
    t = rng.random(batch).astype(np.float32)
    extra = {}
    if labels is not None:
        extra["y"] = jnp.asarray(labels)
    if jax_cls is not None:
        extra["conditional"] = jnp.asarray(x)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(t), **extra)
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng)
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel, x, t


def _jax_apply(jmodel, params, x, t, **kw):
    fn = jax.jit(functools.partial(jmodel.apply, **kw))
    return fn({"params": params}, jnp.asarray(x), jnp.asarray(t))


def test_class_labels_match_jax():
    labels = np.array([0, 2, 4])
    jm, params, tm, x, t = _pair(batch=3, num_classes=5, labels=labels)
    assert tm.label_emb.weight.shape == (5, 32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                             jnp.asarray(t), y=jnp.asarray(labels))
    got = tm(_cf(x), torch.from_numpy(t), y=torch.from_numpy(labels))
    np.testing.assert_allclose(_cl(got), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="labels"):
        tm(_cf(x), torch.from_numpy(t))


def test_features_mode_matches_jax():
    jm, params, tm, x, t = _pair(batch=1)
    want = _jax_apply(jm, params, x, t, return_features=True)
    got = tm(_cf(x), torch.from_numpy(t), return_features=True)
    assert set(got) == {"down", "middle", "up", "out"}
    assert len(got["down"]) == len(want["down"]) > 0
    assert len(got["up"]) == len(want["up"]) > 0
    for part in ("down", "up"):
        for g, w in zip(got[part], want[part]):
            np.testing.assert_allclose(_cl(g), np.asarray(w), atol=ATOL)
    np.testing.assert_allclose(_cl(got["middle"]), np.asarray(want["middle"]),
                               atol=ATOL)
    np.testing.assert_allclose(_cl(got["out"]), np.asarray(want["out"]),
                               atol=ATOL)


def test_conditional_model_matches_jax():
    jm, params, tm, x, t = _pair(in_channels=2, jax_cls=JaxConditionalModel,
                                 torch_wrap=ConditionalModel)
    cond = np.flip(x, axis=1).copy()
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                             jnp.asarray(t), conditional=jnp.asarray(cond))
    got = tm(_cf(x), torch.from_numpy(t), conditional=_cf(cond))
    np.testing.assert_allclose(_cl(got), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="conditional"):
        tm(_cf(x), torch.from_numpy(t))


@pytest.mark.parametrize("dims,space", [(1, 16), (3, 7)])
def test_dims_1_and_3_match_jax(dims, space):
    # 7 is odd: the Upsample crops every spatial axis
    jm, params, tm, x, t = _pair(dims=dims, space=space)
    want = _jax_apply(jm, params, x, t)
    got = tm(_cf(x), torch.from_numpy(t))
    assert got.shape == (2, 1, *(space,) * dims)
    np.testing.assert_allclose(_cl(got), np.asarray(want), atol=ATOL)
    # the converter's inverse gives back the flax layout
    back = state_dict_to_flax(dict(tm.named_parameters()), tm)
    np.testing.assert_array_equal(back["conv_in"]["kernel"],
                                  params["conv_in"]["kernel"])


def test_scale_shift_norm_matches_jax():
    jm, params, tm, x, t = _pair(use_scale_shift_norm=True)
    assert tm.mid_res0.emb_dense.weight.shape == (2 * 16, 32)
    want = _jax_apply(jm, params, x, t)
    got = tm(_cf(x), torch.from_numpy(t))
    np.testing.assert_allclose(_cl(got), np.asarray(want), atol=ATOL)


def test_checkpointing_keeps_values_and_gradients():
    jm, params, tm, x, t = _pair()
    tr = UNetModel(**TINY, use_checkpoint=True)
    load_flax_params(tr, params)
    xt, tt = _cf(x), torch.from_numpy(t)
    want = _jax_apply(jm, params, x, t)
    np.testing.assert_allclose(_cl(tr(xt, tt)), np.asarray(want), atol=ATOL)

    def grads(model):
        model.zero_grad()
        loss = (model(xt, tt) ** 2).sum()
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in model.parameters()]

    l0, g0 = grads(tm)
    l1, g1 = grads(tr)
    assert torch.equal(l0, l1)
    scale = max(float(g.abs().max()) for g in g0)
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-6 * scale


def test_dropout_off_equals_none_and_on_scales():
    _, params, tm, x, t = _pair()
    td = UNetModel(**TINY, dropout=0.3)
    load_flax_params(td, params)
    xt, tt = _cf(x), torch.from_numpy(t)
    ref = tm(xt, tt)
    # deterministic (the default) ignores dropout
    assert torch.equal(td(xt, tt), ref)
    with pytest.raises(ValueError, match="generator"):
        td(xt, tt, deterministic=False)
    g = torch.Generator().manual_seed(0)
    a = td(xt, tt, deterministic=False, generator=g)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(td(xt, tt, deterministic=False, generator=g), a)
    assert not torch.equal(a, ref)
    # the kept activations are scaled by 1/(1 - p) before out_conv
    block = ResBlock(8, 32, 16, dropout=0.3)
    seen = []
    block.out_conv.register_forward_pre_hook(
        lambda m, inp: seen.append(inp[0].detach()))
    h = torch.randn(2, 8, 4, 4)
    emb = torch.randn(2, 32)
    keep = torch.rand(2, 16, 4, 4, generator=torch.Generator().manual_seed(1)
                      ) < 0.7
    block(h, emb)
    block(h, emb, keep)
    torch.testing.assert_close(
        seen[1], torch.where(keep, seen[0] / 0.7, torch.zeros_like(seen[0])),
        rtol=1e-6, atol=0)
