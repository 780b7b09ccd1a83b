"""The U-Net's unfused AttentionBlock in bf16 against the JAX package's
``AttentionBlock(attention_impl="unfused", dtype=bfloat16)``, and the
grf16_production_dbg preset on the unfused route through the CLI, on the
CPU.

The block's weights are the JAX block's, carried over by
``load_flax_params``; inputs come from numpy under a seed. Output, tangent
(``torch.func.jvp`` against ``jax.jvp``) and the gradient of a loss on the
output with respect to the input and every parameter are held to the rule
of tests/test_torch_bf16.py: within 3e-2·max |JAX bf16| of JAX bf16, and no
farther from JAX fp32 than 1.5× JAX bf16's own distance plus
1e-3·max |JAX fp32|. At T = 64 the attention core is the (T, T) plain
version; with the thresholds patched small on both sides (T > 32, key
tiles of 16) the block takes the tiled path at T = 64: the pair
K7a/K7b's plain versions under autograd, their tiled tangent under
``torch.func.jvp``, where JAX differentiates its tiled math. The "auto"
blocks at T = 256 with 8 heads take K3's route in bf16 as in fp32, and
match JAX's "auto" block."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.models.unet2d import AttentionBlock as JaxAttentionBlock
from sdeflow_tpu.ops.pallas import attention as jax_attn
from sdeflow_tpu_torch import configs, run
from sdeflow_tpu_torch.experiments.driver import make_model
from sdeflow_tpu_torch.models.convert import load_flax_params
from sdeflow_tpu_torch.models.unet2d import AttentionBlock
from sdeflow_tpu_torch.ops.kernels import attention as A

torch.set_num_threads(1)
BF = torch.bfloat16


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_bf16_close(ours, jax16, jax32, what, tol=3e-2):
    """Within tol·max |JAX bf16| of JAX bf16, and no farther from JAX
    fp32 than 1.5× JAX bf16's distance plus 1e-3·max |JAX fp32|."""
    ours, jax16, jax32 = _np(ours), _np(jax16), _np(jax32)
    assert ours.shape == jax16.shape == jax32.shape, what
    assert np.isfinite(ours).all(), what
    err = np.abs(ours - jax16).max()
    assert err <= tol * np.abs(jax16).max(), (what, err)
    mine = np.abs(ours - jax32).max()
    theirs = np.abs(jax16 - jax32).max()
    assert mine <= 1.5 * theirs + 1e-3 * np.abs(jax32).max(), (
        what, mine, theirs)


def _params(tree, rng):
    """Random non-zero values for every leaf of a flax params tree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _params(v, rng)
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


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "T64"])
def test_unfused_block_bf16_matches_jax(monkeypatch, tiled):
    if tiled:
        for mod in (A, jax_attn):
            monkeypatch.setattr(mod, "_FLASH_SEQ_THRESHOLD", 32)
            monkeypatch.setattr(mod, "_FLASH_KV_BLOCK", 16)
    rng = np.random.default_rng(11)
    c, heads = 64, 2  # ch = 32: the scale is inexact in bf16
    x = torch.from_numpy((2.0 * rng.standard_normal((2, 8, 8, c)) + 0.5)
                         .astype(np.float32)).to(BF).float().numpy()
    dx = torch.from_numpy(rng.standard_normal((2, 8, 8, c)).astype(
        np.float32)).to(BF).float().numpy()
    w = rng.standard_normal((2, 8, 8, c)).astype(np.float32)
    shapes = jax.eval_shape(JaxAttentionBlock(c, heads).init,
                            jax.random.PRNGKey(0), jnp.asarray(x))
    params = _params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng)
    ref = {}
    for dt in (jnp.bfloat16, jnp.float32):
        block = JaxAttentionBlock(c, heads, dtype=dt, attention_impl="unfused")

        def f(p, xx):
            return block.apply({"params": p}, xx)

        xs = jnp.asarray(x, dt)
        out, tan = jax.jit(lambda xx, d: jax.jvp(
            lambda y: f(params, y), (xx,), (d,)))(xs, jnp.asarray(dx, dt))
        gx, gp = jax.jit(jax.grad(lambda xx, p: (
            f(p, xx).astype(jnp.float32) * w).sum(), argnums=(0, 1)))(
            xs, params)
        ref[dt] = (out, tan, gx, gp)
    tblock = load_flax_params(AttentionBlock(c, heads, "unfused"), params)
    assert not tblock.fused
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(BF)
    tdx = torch.from_numpy(dx).permute(0, 3, 1, 2).to(BF)
    out, tan = torch.func.jvp(tblock, (tx,), (tdx,))
    assert out.dtype == tan.dtype == BF
    xg = tx.clone().requires_grad_()
    y = tblock(xg)
    loss = (y.float() * torch.from_numpy(w).permute(0, 3, 1, 2)).sum()
    grads = torch.autograd.grad(loss, [xg, *tblock.parameters()])
    assert grads[0].dtype == BF
    perm = lambda a: a.permute(0, 2, 3, 1)  # noqa: E731  NCHW -> NHWC
    for what, ours, i in [("out", perm(out), 0), ("tangent", perm(tan), 1),
                          ("dx", perm(grads[0]), 2)]:
        assert_bf16_close(ours, ref[jnp.bfloat16][i], ref[jnp.float32][i],
                          what)
    names = [n for n, _ in tblock.named_parameters()]
    for name, g in zip(names, grads[1:]):
        mod, leaf = name.split(".")
        assert g.dtype == torch.float32, name
        assert_bf16_close(g, ref[jnp.bfloat16][3][mod][leaf],
                          ref[jnp.float32][3][mod][leaf], name)


def _auto_block_routes(monkeypatch, side, c, heads, seed):
    """The bf16 "auto" block at (side², c, heads) on the CPU with its two
    routes spied on: (the routes taken, its output, JAX's "auto" block's
    output in bf16 and in fp32 on the same weights)."""
    from sdeflow_tpu_torch.models import unet2d

    calls = []
    for name in ("attention_core", "fused_attention_block"):
        fn = getattr(unet2d, name)
        monkeypatch.setattr(unet2d, name, lambda *a, fn=fn, name=name: (
            calls.append(name), fn(*a))[1])
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((2.0 * rng.standard_normal((2, side, side, c))
                          + 0.5).astype(np.float32)).to(BF).float().numpy()
    shapes = jax.eval_shape(JaxAttentionBlock(c, heads).init,
                            jax.random.PRNGKey(0), jnp.asarray(x))
    params = _params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng)
    ref = {dt: jax.jit(lambda xx, dt=dt: JaxAttentionBlock(
        c, heads, dtype=dt).apply({"params": params}, xx))(
            jnp.asarray(x, dt)) for dt in (jnp.bfloat16, jnp.float32)}
    tblock = load_flax_params(AttentionBlock(c, heads), params)
    assert tblock.fused
    with torch.no_grad():
        out = tblock(torch.from_numpy(x).permute(0, 3, 1, 2).to(BF))
    assert out.dtype == BF
    return calls, out.permute(0, 2, 3, 1), ref[jnp.bfloat16], ref[jnp.float32]


@pytest.mark.parametrize("c", [32, 64], ids=["C32", "C64"])
def test_auto_block_beyond_bf16_k3_runs_unfused(monkeypatch, c):
    """The "auto" block at (T, heads) = (256, 8), groups 32, which K3 holds
    in fp32 with qkv in scratch, and which bf16 K3 held only unfused until
    its kernel read the fp32 weights itself (the name keeps that history),
    now takes K3's route in bf16 too, and computes what JAX's "auto" block
    computes on the same weights."""
    from sdeflow_tpu_torch.ops.kernels.attnblock import block_plan

    assert block_plan(256, c, 32, 8) is not None
    assert block_plan(256, c, 32, 8, BF) is not None
    calls, out, j16, j32 = _auto_block_routes(monkeypatch, 16, c, 8, 12)
    assert calls == ["fused_attention_block"]
    assert_bf16_close(out, j16, j32, "out")


@pytest.mark.parametrize("side,c", [(8, 64), (4, 128)],
                         ids=["T64-C64", "T16-C128"])
def test_auto_block_bf16_within_k3_stays_fused(monkeypatch, side, c):
    """grf16's two block shapes, which K3 holds in bf16 too, keep the
    fused route in bf16 (one K3 call, no attention core)."""
    calls, out, j16, j32 = _auto_block_routes(monkeypatch, side, c, 1, 13)
    assert calls == ["fused_attention_block"]
    assert_bf16_close(out, j16, j32, "out")


def test_production_dbg_unfused_cli_runs_on_the_cpu(tmp_path, capsys,
                                                     monkeypatch):
    """grf16_production_dbg with --attention-impl unfused through the CLI
    on the CPU: bf16 compute, every AttentionBlock module by module."""
    calls = []
    core = A.attention_core
    monkeypatch.setattr("sdeflow_tpu_torch.models.unet2d.attention_core",
                        lambda qkv, h: (calls.append(qkv.dtype),
                                        core(qkv, h))[1])
    monkeypatch.chdir(tmp_path)
    res = run.main(["--preset", "grf16_production_dbg", "--cpu",
                    "--attention-impl", "unfused", "--no-plots",
                    "--eval-mmd", "--iterations", "1", "--num-samples", "4",
                    "--steps-backward", "1",
                    "--results-dir", str(tmp_path / "res")])
    out = capsys.readouterr().out
    assert "preset = grf16_production_dbg" in out
    assert calls and set(calls) == {BF}
    for k in ("mmd_sgm", "mmd_msgm", "mmd_ref"):
        assert np.isfinite(res[k]).all()
    cfg = configs.get_preset("grf16_production_dbg")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, attention_impl="unfused"))
    model = make_model(cfg, 256, None, device="cpu")
    blocks = [m for m in model.modules() if isinstance(m, AttentionBlock)]
    assert blocks and not any(m.fused for m in blocks)
