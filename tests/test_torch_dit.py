"""The DiT score nets against the JAX package (models/dit.py) on the same
flax weights, every parameter (the zero-initialized ada_mod, ada_out and
head_out, and pos_emb, included) random and non-zero, carried by
models/convert.py: DiT1D at an odd d (padded and cropped) and an even one,
DiT2D on flat F- and C-order inputs and on (B, H, W, 1) images, with and
without the NormalizeLogRadius premodule; fp32 at atol 1e-4, bf16 within
2e-2 of the largest output; a forward-mode JVP through DiT2D against
jax.jvp; one DiTBlock and the affine-free LayerNorm alone; and the
adaLN-Zero start (score ≡ 0) of the net the driver builds. Small widths
keep the JAX compiles short."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.models import dit as jax_dit
from sdeflow_tpu_torch import configs
from sdeflow_tpu_torch.experiments.driver import make_model
from sdeflow_tpu_torch.models import dit
from sdeflow_tpu_torch.models.convert import load_flax_params

torch.set_num_threads(1)
SMALL = dict(width=32, depth=2, heads=4)
B = 5


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


def _pair(jcls, tcls, x, t, seed=0, **kw):
    """(jax apply, params, the port's net on the same params)."""
    jmodel = jcls(**kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(t))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]),
        np.random.default_rng(seed))
    jdt = kw.pop("dtype", jnp.float32)
    tdt = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32
    tmodel = load_flax_params(tcls(dtype=tdt, **kw), params)
    return jax.jit(jmodel.apply), params, tmodel


def _inputs(shape, seed=1):
    rng = np.random.default_rng(seed)
    return ((2.0 * rng.standard_normal(shape)).astype(np.float32),
            rng.random(shape[0]).astype(np.float32))


def _check(jfn, params, tmodel, x, t, bf16=False):
    ref = np.asarray(jfn({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    out = tmodel(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    if bf16:
        assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("d,premodule", [(10, "NormalizeLogRadius"),
                                         (12, None)])
def test_dit1d_matches_jax_fp32(d, premodule):
    x, t = _inputs((B, d))
    jfn, params, tmodel = _pair(jax_dit.DiT1D, dit.DiT1D, x, t,
                                input_dim=d, patch=4, premodule=premodule,
                                **SMALL)
    assert tmodel.pad == (-d) % 4
    _check(jfn, params, tmodel, x, t)


@pytest.mark.parametrize("shape,order,premodule", [
    ((B, 64), "F", "NormalizeLogRadius"), ((B, 64), "C", None),
    ((B, 8, 8, 1), "C", "NormalizeLogRadius")])
def test_dit2d_matches_jax_fp32(shape, order, premodule):
    x, t = _inputs(shape)
    jfn, params, tmodel = _pair(jax_dit.DiT2D, dit.DiT2D, x, t, in_space=8,
                                patch=4, premodule=premodule,
                                flatten_order=order, **SMALL)
    _check(jfn, params, tmodel, x, t)


@pytest.mark.parametrize("which", ["1d", "2d"])
def test_dit_matches_jax_bf16(which):
    if which == "1d":
        x, t = _inputs((B, 10))
        jfn, params, tmodel = _pair(
            jax_dit.DiT1D, dit.DiT1D, x, t, input_dim=10, patch=4,
            premodule="NormalizeLogRadius", dtype=jnp.bfloat16, **SMALL)
    else:
        x, t = _inputs((B, 64))
        jfn, params, tmodel = _pair(
            jax_dit.DiT2D, dit.DiT2D, x, t, in_space=8, patch=4,
            premodule="NormalizeLogRadius", flatten_order="F",
            dtype=jnp.bfloat16, **SMALL)
    assert tmodel.block0.qkv.compute_dtype == torch.bfloat16
    assert tmodel.head_out.compute_dtype == torch.float32
    assert tmodel.time_mlp.dense0.compute_dtype == torch.float32
    _check(jfn, params, tmodel, x, t, bf16=True)


def test_jvp_through_dit2d_matches_jax():
    x, t = _inputs((B, 64))
    v = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    jfn, params, tmodel = _pair(jax_dit.DiT2D, dit.DiT2D, x, t, in_space=8,
                                patch=4, premodule="NormalizeLogRadius",
                                flatten_order="F", **SMALL)
    tt = jnp.asarray(t)
    _, ref = jax.jvp(lambda y: jfn({"params": params}, y, tt),
                     (jnp.asarray(x),), (jnp.asarray(v),))
    tt = torch.from_numpy(t)
    _, out = torch.func.jvp(lambda y: tmodel(y, tt), (torch.from_numpy(x),),
                            (torch.from_numpy(v),))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_dit_block_and_layer_norm_match_jax():
    rng = np.random.default_rng(3)
    h = (3.0 * rng.standard_normal((B, 4, 32)) + 1.0).astype(np.float32)
    c = rng.standard_normal((B, 32)).astype(np.float32)
    jblock = jax_dit.DiTBlock(width=32, heads=4)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0),
                            jnp.asarray(h), jnp.asarray(c))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng)
    ref = jax.jit(jblock.apply)({"params": params}, jnp.asarray(h),
                                jnp.asarray(c))
    tblock = load_flax_params(dit.DiTBlock(32, 4), params)
    out = tblock(torch.from_numpy(h), torch.from_numpy(c))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-4)
    # the population variance (ddof 0), eps inside the rsqrt, fp32
    # statistics of a bf16 input rounded back once
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        a = dit._ln(torch.from_numpy(h).to(dt))
        b = jax_dit._ln(jnp.asarray(h).astype(jdt))
        assert a.dtype == dt
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   rtol=0, atol=1e-5 if dt == torch.float32
                                   else 1e-2)


def test_driver_dit2d_starts_at_zero_score():
    """make_model's DiT2D on a small grf16_dit: the adaLN-Zero layers and
    the head start at zero (score ≡ 0), pos_emb from normal(0.02)."""
    cfg = configs.get_preset("grf16_dit")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, dit_width=64, dit_depth=2))
    torch.manual_seed(0)
    model = make_model(cfg, 256, "NormalizeLogRadius", device="cpu")
    assert isinstance(model, dit.DiT2D) and model.flatten_order == "F"
    assert (model.patch, model.in_space) == (4, 16)
    assert model.pos_emb.shape == (16, 64)
    assert 0.015 < float(model.pos_emb.detach().std()) < 0.025
    for name in ("block0.ada_mod", "block1.ada_mod", "ada_out", "head_out"):
        layer = model.get_submodule(name)
        assert not layer.weight.any() and not layer.bias.any()
    out = model(torch.randn(3, 256), torch.rand(3))
    assert out.shape == (3, 256) and not out.any()
