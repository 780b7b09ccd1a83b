"""The score net: the JAX package's VorticityUNet against the port's, on the
same weights (carried over by models/convert.py) and the same inputs.

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


@pytest.mark.parametrize("arch,batch", [(SMALL, 3), (GRF16, 2)],
                         ids=["small", "grf16"])
def test_vorticity_unet_matches_jax(arch, batch):
    jmodel, tmodel, params, x, t = _pair(arch, batch)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                           jnp.asarray(t)))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


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
