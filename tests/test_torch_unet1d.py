"""UNet1D (sdeflow_tpu_torch/models/unet1d.py) against the JAX package's
(sdeflow_tpu/models/unet1d.py) on the same flax weights, every parameter
random and non-zero, carried by models/convert.py: d = 64 and d = 100
(odd lengths down the encoder, 100 → 50 → 25, so the decoder pads), base
8, mults (1, 2), emb 16, with and without the NormalizeLogRadius
premodule; fp32 within 1e-5 of the largest output; bf16 by the whole
U-Net's two gates of tests/test_torch_bf16.py (within 5e-2·max |JAX bf16|
of JAX bf16, and no farther from JAX fp32 than 1.5× JAX bf16's own
distance plus 1e-3·max |JAX fp32|: the two frameworks round at other
places); a JVP against jax.jvp and the parameter
gradients of a scalar loss against jax.grad; the converter's round trip
and its transposed-convolution rule against flax's nn.ConvTranspose in 1D
and 2D; and make_model's UNet1D of lorenz63_unet1d."""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from sdeflow_tpu.models import unet1d as jax_unet1d
from sdeflow_tpu_torch import configs
from sdeflow_tpu_torch.experiments.driver import make_model
from sdeflow_tpu_torch.models.convert import (
    load_flax_params, state_dict_to_flax)
from sdeflow_tpu_torch.models.unet1d import ConvTranspose1d, UNet1D

torch.set_num_threads(1)
SMALL = dict(base_channels=8, channel_mults=(1, 2), emb_dim=16)
B = 3
NLR = "NormalizeLogRadius"


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        scale = (1.0 / np.sqrt(np.prod(shape[:-1])) if k == "kernel"
                 else 0.1)
        out[k] = (scale * rng.standard_normal(shape)).astype(np.float32)
    return out


def _inputs(d, seed=1):
    rng = np.random.default_rng(seed)
    return ((2.0 * rng.standard_normal((B, d))).astype(np.float32),
            rng.random(B).astype(np.float32))


def _pair(d, premodule, bf16=False, seed=0):
    """(jax module, flax params, the port's net on the same params)."""
    x, t = _inputs(d)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jmodel = jax_unet1d.UNet1D(input_dim=d, premodule=premodule, dtype=jdt,
                               **SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(t))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]),
        np.random.default_rng(seed))
    tmodel = load_flax_params(UNet1D(d, premodule=premodule, dtype=(
        torch.bfloat16 if bf16 else torch.float32), **SMALL), params)
    return jmodel, params, tmodel


@pytest.mark.parametrize("d,premodule", [(64, None), (64, NLR), (100, None),
                                         (100, NLR)])
def test_unet1d_matches_jax_fp32(d, premodule):
    jmodel, params, tmodel = _pair(d, premodule)
    x, t = _inputs(d)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                           jnp.asarray(x), jnp.asarray(t)))
    out = tmodel(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
    assert out.shape == ref.shape == (B, d) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("d,premodule", [(64, NLR), (100, None)])
def test_unet1d_matches_jax_bf16(d, premodule):
    jmodel, params, tmodel = _pair(d, premodule, bf16=True)
    x, t = _inputs(d)
    j32 = jax_unet1d.UNet1D(input_dim=d, premodule=premodule, **SMALL)
    j16, j32 = (np.asarray(jax.jit(m.apply)({"params": params},
                                            jnp.asarray(x), jnp.asarray(t)))
                for m in (jmodel, j32))
    out = tmodel(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
    assert tmodel.enc0.conv0.compute_dtype == torch.bfloat16
    assert tmodel.up0.compute_dtype == torch.bfloat16
    assert tmodel.final.compute_dtype == torch.float32
    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert np.abs(out - j16).max() <= 5e-2 * np.abs(j16).max()
    mine, theirs = np.abs(out - j32).max(), np.abs(j16 - j32).max()
    assert mine <= 1.5 * theirs + 1e-3 * np.abs(j32).max(), (mine, theirs)


def test_jvp_through_unet1d_matches_jax():
    d = 100
    jmodel, params, tmodel = _pair(d, NLR)
    x, t = _inputs(d)
    v = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    tt = jnp.asarray(t)
    _, ref = jax.jvp(lambda y: jmodel.apply({"params": params}, y, tt),
                     (jnp.asarray(x),), (jnp.asarray(v),))
    tt = torch.from_numpy(t)
    _, out = torch.func.jvp(lambda y: tmodel(y, tt), (torch.from_numpy(x),),
                            (torch.from_numpy(v),))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_parameter_gradients_match_jax_grad():
    """The gradient of Σ net(x, t)·w with respect to every parameter,
    carried back to flax's layout by state_dict_to_flax."""
    d = 100
    jmodel, params, tmodel = _pair(d, NLR)
    x, t = _inputs(d)
    w = np.random.default_rng(4).standard_normal((B, d)).astype(np.float32)

    def loss(p):
        return jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x),
                                    jnp.asarray(t)) * w)

    ref = jax.grad(loss)(params)
    (tmodel(torch.from_numpy(x), torch.from_numpy(t))
     * torch.from_numpy(w)).sum().backward()
    got = state_dict_to_flax({k: p.grad for k, p in
                              tmodel.named_parameters()}, tmodel)
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_ref.keys() == flat_got.keys()
    for k, r in flat_ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(flat_got[k], r, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(r).max()),
                                   err_msg=str(k))


def test_converter_round_trip():
    _, params, tmodel = _pair(100, NLR)
    back = state_dict_to_flax(dict(tmodel.named_parameters()), tmodel)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert tuple(tmodel.up0.weight.shape) == (16, 16, 4)  # (I, O, K)


@pytest.mark.parametrize("dims", [1, 2])
def test_transposed_convolution_rule_matches_flax(dims):
    """flax's nn.ConvTranspose (kernel 4, stride 2, SAME) against
    nn.ConvTranspose{1,2}d(padding=1) on the weights the rule carries."""
    rng = np.random.default_rng(dims)
    shape = (2,) + (7,) * dims + (5,)
    x = rng.standard_normal(shape).astype(np.float32)
    jconv = fnn.ConvTranspose(3, (4,) * dims, strides=(2,) * dims,
                              padding="SAME")
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), jax.eval_shape(
            jconv.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]),
        rng)
    ref = np.asarray(jconv.apply({"params": params}, jnp.asarray(x)))
    tconv = (ConvTranspose1d(5, 3, 4, stride=2, padding=1) if dims == 1 else
             torch.nn.ConvTranspose2d(5, 3, 4, stride=2, padding=1))
    load_flax_params(tconv, params)
    out = tconv(torch.from_numpy(np.moveaxis(x, -1, 1)))
    out = np.moveaxis(out.detach().numpy(), 1, -1)
    assert out.shape == ref.shape == (2,) + (14,) * dims + (3,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_make_model_builds_unet1d_of_the_preset():
    cfg = configs.get_preset("lorenz63_unet1d")
    torch.manual_seed(0)
    net = make_model(cfg, 1000, NLR, device="cpu")
    assert isinstance(net, UNet1D) and net.premodule == NLR
    assert net.time_mlp.dense0.out_features == cfg.train.emb_dim == 128
    assert [getattr(net, f"enc{i}").conv1.out_channels for i in range(3)] \
        == [32, 64, 128]
    x = torch.randn(2, 1000)
    assert net(x, torch.rand(2)).shape == (2, 1000)
