"""The score net: the JAX package's VorticityUNet and AttentionBlock against
the port's, on both attention routes ("auto", which is kernel K3 for up to
8 heads, and "unfused"), on the same weights (carried over by
models/convert.py) and the same inputs (the whole VorticityUNet's cases in
test_torch_models_unet.py).

Every parameter, the zero-initialised output layers included, is
overwritten with random values, so that every block does work. Tolerance:
atol 1e-4 in float32 (a few tens of layers, sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.models.common import normalize_log_radius as jax_nlr
from sdeflow_tpu.models.common import timestep_embedding as jax_temb
from sdeflow_tpu.models.unet2d import AttentionBlock as JaxAttentionBlock
from sdeflow_tpu.models.vorticity import (
    VorticityUNet as JaxVorticityUNet, flat_to_img as jax_f2i,
    img_to_flat as jax_i2f)
from sdeflow_tpu_torch.models.common import (
    group_count, normalize_log_radius, timestep_embedding)
from sdeflow_tpu_torch.models.convert import flax_to_state_dict, load_flax_params
from sdeflow_tpu_torch.models.unet2d import AttentionBlock
from sdeflow_tpu_torch.models.vorticity import (
    VorticityUNet, flat_to_img, img_to_flat)

torch.set_num_threads(1)
ATOL = 1e-4

SMALL = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
             attention_resolutions=(2,))
GRF16 = dict(base_channels=32, channel_mults=(1, 2, 4), num_res_blocks=2,
             attention_resolutions=(2, 4))


def randomize(tree, rng):
    """Random non-zero values for every leaf of a flax params tree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif k == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        out[k] = a.astype(np.float32)
    return out


def _pair(arch, batch, seed=0):
    rng = np.random.default_rng(seed)
    kw = dict(arch, premodule="NormalizeLogRadius", in_space=16,
              flatten_order="F")
    jmodel = JaxVorticityUNet(**kw)
    x = (3.0 * rng.standard_normal((batch, 256))).astype(np.float32)
    t = rng.random(batch).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(t))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng)
    tmodel = VorticityUNet(**kw)
    load_flax_params(tmodel, params)
    return jmodel, tmodel, params, x, t


@pytest.mark.parametrize("impl,heads", [
    ("unfused", 1), ("unfused", 4), ("auto", 16)])
def test_attention_block_routes_match_jax(impl, heads):
    # "auto" with more than 8 heads takes the unfused composition, as in the
    # JAX package (sdeflow_tpu/models/unet2d.py:238)
    rng = np.random.default_rng(4)
    c = 32
    x = (2.0 * rng.standard_normal((2, 8, 8, c)) + 0.5).astype(np.float32)
    jblock = JaxAttentionBlock(c, num_heads=heads, attention_impl=impl)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng)
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    tblock = load_flax_params(AttentionBlock(c, heads, impl), params)
    assert not tblock.fused
    with torch.no_grad():
        out = tblock(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(ref - x).max() > 0.1  # the block is not the identity
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("side,c", [(17, 16), (16, 96)],
                         ids=["T289", "T256-C96"])
def test_auto_block_beyond_kernel_k3_takes_the_unfused_route(monkeypatch,
                                                             side, c):
    # T > 256, or a working set beyond one block's shared memory: the plain
    # composition, as the JAX "auto" block runs there
    # (sdeflow_tpu/ops/pallas/attnblock.py:253-265), on every device
    from sdeflow_tpu_torch.models import unet2d

    def refuse(*a):
        raise AssertionError("fused_attention_block called")

    monkeypatch.setattr(unet2d, "fused_attention_block", refuse)
    rng = np.random.default_rng(5)
    x = (2.0 * rng.standard_normal((2, side, side, c)) + 0.5).astype(
        np.float32)
    jblock = JaxAttentionBlock(c, num_heads=1, attention_impl="auto")
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng)
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    tblock = load_flax_params(AttentionBlock(c, 1, "auto"), params)
    assert tblock.fused
    with torch.no_grad():
        out = tblock(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(ref - x).max() > 0.1
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=ATOL)


def test_attention_block_routes_share_parameters():
    fused, unfused = AttentionBlock(64, 2), AttentionBlock(64, 2, "unfused")
    assert fused.fused and not unfused.fused
    assert ({n: p.shape for n, p in fused.named_parameters()}
            == {n: p.shape for n, p in unfused.named_parameters()})
    with pytest.raises(NotImplementedError, match="item 14"):
        AttentionBlock(64, 2, "ring")


def test_grf16_unet_has_the_flagship_attention_shapes():
    tmodel = VorticityUNet(**GRF16, premodule="NormalizeLogRadius",
                           flatten_order="F")
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append(tuple(inp[0].shape[1:])))
        for m in tmodel.modules() if isinstance(m, AttentionBlock)]
    with torch.no_grad():
        tmodel(torch.randn(2, 256), torch.rand(2))
    for h in hooks:
        h.remove()
    assert len(seen) == 11
    assert seen.count((64, 8, 8)) == 5 and seen.count((128, 4, 4)) == 6


def test_converter_rejects_missing_and_unused_keys():
    _, tmodel, params, _, _ = _pair(SMALL, 1)
    broken = dict(params)
    broken["core"] = {k: v for k, v in params["core"].items()
                      if k != "conv_in"}
    with pytest.raises(KeyError, match="no flax counterpart"):
        flax_to_state_dict(broken, tmodel)
    extra = dict(params, bogus={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict(extra, tmodel)


@pytest.mark.parametrize("order", ["C", "F"])
def test_flat_image_reshapes_match_jax(order):
    x = np.random.default_rng(1).standard_normal((2, 12)).astype(np.float32)
    img = flat_to_img(torch.from_numpy(x), 3, 4, order)
    np.testing.assert_allclose(img.numpy(), np.asarray(
        jax_f2i(jnp.asarray(x), 3, 4, order)), rtol=0, atol=1e-7)
    np.testing.assert_allclose(img_to_flat(img, order).numpy(), x,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        img_to_flat(img, order).numpy(),
        np.asarray(jax_i2f(jnp.asarray(img.numpy()), order)), rtol=0, atol=0)


def test_primitives_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 9)).astype(np.float32)
    t = (10 * rng.random(4)).astype(np.float32)
    for a, b in zip(normalize_log_radius(torch.from_numpy(x)),
                    jax_nlr(jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for dim in (8, 7):
        np.testing.assert_allclose(
            timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jax_temb(jnp.asarray(t), dim)), rtol=0, atol=1e-5)
    assert [group_count(c) for c in (8, 32, 96, 48, 40)] == [8, 32, 32, 24, 20]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", [SMALL, GRF16], ids=["small", "grf16"])
def test_score_net_starts_from_flax_default_init(arch):
    """The port's fresh score net is initialized as the JAX package's flax
    layers are: every kernel lecun_normal (a normal truncated at ±2σ with
    variance 1/fan_in, fan_in = input channels × kernel size) except the
    zero-initialized output layers (flax's zero_init: a ResBlock's
    out_conv, an AttentionBlock's proj_out, the final conv_out), every
    bias zero, every GroupNorm scale one. The layout and names come from
    JAX's own parameter tree."""
    from sdeflow_tpu_torch.models.convert import state_dict_to_flax

    kw = dict(arch, premodule="NormalizeLogRadius", in_space=16,
              flatten_order="F")
    shapes = jax.eval_shape(JaxVorticityUNet(**kw).init,
                            jax.random.PRNGKey(0), jnp.zeros((2, 256)),
                            jnp.zeros((2,)))["params"]
    torch.manual_seed(0)
    net = VorticityUNet(**kw)
    ours = {k: np.asarray(v) for k, v in _flat(
        state_dict_to_flax(dict(net.named_parameters()), net))}
    ref = {k: tuple(v.shape) for k, v in _flat(shapes)}
    assert {k: v.shape for k, v in ours.items()} == ref
    zero_layers = (".out_conv.", ".proj_out.", "core.conv_out.")
    kernels = []
    for name, v in ours.items():
        if name.endswith(".bias") or any(z in name for z in zero_layers):
            assert not v.any(), name
        elif name.endswith(".scale"):
            assert (v == 1.0).all(), name
        else:
            assert name.endswith(".kernel"), name
            std = 1.0 / np.sqrt(np.prod(v.shape[:-1]))  # HWIO / (in, out)
            assert np.abs(v).max() <= 2.0 * std / 0.8796256610342398 + 1e-6
            kernels.append((v / std).ravel())
    z = np.concatenate(kernels)  # unit variance if every layer is lecun
    assert z.size > 1000 and abs(z.std() - 1.0) < 0.02, z.std()
