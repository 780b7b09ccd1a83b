"""bf16 compute in the score net (the grf16_production preset) against the
JAX package's, on the CPU.

The plain twins of the bf16 kernels (``gn_math`` with its tangent and
vjp, ``attn_block_math`` with its tangent), one ResBlock and the whole
VorticityUNet on the same seeded inputs and weights in bf16 against JAX in
bf16. Roundings happen at other places in the two frameworks (a fused
multiply-add rounds once, XLA may keep a bf16 chain in fp32), so each
result is held to two things: within 3e-2·max |JAX bf16| of JAX bf16, and
no farther from JAX's fp32 result than 1.5× JAX bf16's own distance from
it plus 1e-3·max |JAX fp32| (the port's bf16 is no worse than JAX's). The
whole U-Net is held to 5e-2·max |JAX bf16| by the first: on these random
weights JAX's own bf16 lies 2.3-3.4 % of max from its fp32 and the port's
2.4-2.6 %, so two independent roundings of that size differ by up to √2
of it (3.0 % measured); the second criterion is the sharp one there.
Besides: the score leaves a bf16 net as fp32; parameters, Adam moments and
the EMA stay fp32 through three bf16 train steps; the production presets
field by field against JAX's; the launch plans of the bf16 kernels; the
unfused route's attention kernels take bf16 and refuse float16; and the
grf16_production_dbg CLI on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu import configs as jax_configs
from sdeflow_tpu.models.unet2d import ResBlock as JaxResBlock
from sdeflow_tpu.models.vorticity import VorticityUNet as JaxVorticityUNet
from sdeflow_tpu.ops.pallas.attnblock import _attn_block_math as jax_block
from sdeflow_tpu.ops.pallas.groupnorm import _gn_math as jax_gn
from sdeflow_tpu_torch import configs, run
from sdeflow_tpu_torch.data.synthetic import SmoothedGRF
from sdeflow_tpu_torch.experiments.driver import make_model
from sdeflow_tpu_torch.models.convert import load_flax_params
from sdeflow_tpu_torch.models.unet2d import ResBlock
from sdeflow_tpu_torch.models.vorticity import VorticityUNet
from sdeflow_tpu_torch.ops.kernels import attention as attn_k
from sdeflow_tpu_torch.ops.kernels import attnblock as ab
from sdeflow_tpu_torch.ops.kernels import groupnorm as gnk
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde
from sdeflow_tpu_torch.training import Trainer

torch.set_num_threads(1)
BF = torch.bfloat16
SMALL = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
             attention_resolutions=(2,))
GRF16 = dict(base_channels=32, channel_mults=(1, 2, 4), num_res_blocks=2,
             attention_resolutions=(2, 4))


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


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_bf16_matches_jax(silu):
    rng = np.random.default_rng(0)
    b, c, s, groups = 3, 32, 64, 8
    x = (2.0 * rng.standard_normal((b, c, s)) + 0.5).astype(np.float32)
    dx = rng.standard_normal((b, c, s)).astype(np.float32)
    dy = rng.standard_normal((b, c, s)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dgamma = (0.1 * rng.standard_normal(c)).astype(np.float32)

    def jf(xx, g, bb):  # JAX is channels-last
        return jax_gn(xx.transpose(0, 2, 1), g, bb, groups,
                      silu).transpose(0, 2, 1)

    @jax.jit
    def jax_ref(xs, dxs, dys):  # one compile per dtype, not one per op
        y, tan = jax.jvp(jf, (xs, gamma, beta),
                         (dxs, dgamma, jnp.zeros_like(beta)))
        _, vjp = jax.vjp(jf, xs, gamma, beta)
        return (y, tan, *vjp(dys))

    ref = {dt: jax_ref(*(jnp.asarray(a, dt) for a in (x, dx, dy)))
           for dt in (jnp.bfloat16, jnp.float32)}
    tx, tdx, tdy = (torch.from_numpy(a).to(BF) for a in (x, dx, dy))
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    out = gnk.gn_math(tx, tg, tb, groups, silu)
    tan = gnk.gn_math_jvp(tx, tg, tb, groups, silu, tdx,
                          torch.from_numpy(dgamma), None)
    vjp = gnk.gn_math_vjp(tx, tg, tb, groups, silu, tdy)
    assert out.dtype == tan.dtype == vjp[0].dtype == BF
    assert vjp[1].dtype == vjp[2].dtype == torch.float32
    for what, ours, j16, j32 in zip(
            ("out", "tangent", "dx", "dgamma", "dbeta"),
            (out, tan, *vjp), ref[jnp.bfloat16], ref[jnp.float32]):
        assert_bf16_close(ours, j16, j32, what)
    # the kernel's Function on CPU tensors: the plain twin, its backward
    # (grad mode off) the closed-form vjp in the inputs' dtypes
    ts = [tx.clone().requires_grad_(), tg.clone().requires_grad_(),
          tb.clone().requires_grad_()]
    y = gnk.group_norm_silu(*ts, groups, silu)
    torch.testing.assert_close(y, out, rtol=0, atol=0)
    grads = torch.autograd.grad(y, ts, tdy)
    assert [g.dtype for g in grads] == [BF, torch.float32, torch.float32]
    for g, v in zip(grads, vjp):
        torch.testing.assert_close(g, v, rtol=0, atol=0)


def test_attention_block_bf16_matches_jax():
    rng = np.random.default_rng(1)
    b, t, c, groups, heads = 2, 64, 32, 8, 2
    x = (2.0 * rng.standard_normal((b, t, c)) + 0.5).astype(np.float32)
    dx = rng.standard_normal((b, t, c)).astype(np.float32)
    params = [(1.0 + 0.1 * rng.standard_normal(c)),
              0.1 * rng.standard_normal(c),
              rng.standard_normal((c, 3 * c)) / np.sqrt(c),
              0.1 * rng.standard_normal(3 * c),
              rng.standard_normal((c, c)) / np.sqrt(c),
              0.1 * rng.standard_normal(c)]
    params = [p.astype(np.float32) for p in params]
    ref = {}
    for dt in (jnp.bfloat16, jnp.float32):
        f = lambda xx: jax_block(xx, *params, groups, heads)  # noqa: E731
        ref[dt] = jax.jit(lambda a, da: jax.jvp(f, (a,), (da,)))(
            jnp.asarray(x, dt), jnp.asarray(dx, dt))
    tp = [torch.from_numpy(p) for p in params]
    tx, tdx = torch.from_numpy(x).to(BF), torch.from_numpy(dx).to(BF)
    out = ab.attn_block_math(tx, *tp, groups, heads)
    tan = ab.attn_block_jvp(tx, *tp, groups, heads, tdx, *[None] * 6)
    assert out.dtype == tan.dtype == BF
    assert_bf16_close(out, ref[jnp.bfloat16][0], ref[jnp.float32][0], "out")
    assert_bf16_close(tan, ref[jnp.bfloat16][1], ref[jnp.float32][1],
                      "tangent")
    # through the kernel's Function on CPU tensors, forward mode included
    y, dy = torch.func.jvp(lambda a: ab.fused_attention_block(
        a, *tp, groups, heads), (tx,), (tdx,))
    torch.testing.assert_close(y, out, rtol=0, atol=0)
    torch.testing.assert_close(dy, tan, rtol=0, atol=0)


def test_resblock_bf16_matches_jax():
    rng = np.random.default_rng(2)
    cin, cout, temb = 16, 32, 64
    x = rng.standard_normal((3, 8, 8, cin)).astype(np.float32)
    emb = rng.standard_normal((3, temb)).astype(np.float32)
    kw = dict(channels=cin, emb_channels=temb, out_channels=cout)
    shapes = jax.eval_shape(JaxResBlock(**kw).init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(emb))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng)
    ref = {dt: jax.jit(JaxResBlock(**kw, dtype=dt).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(emb))
        for dt in (jnp.bfloat16, jnp.float32)}
    block = load_flax_params(ResBlock(cin, temb, cout, dtype=BF), params)
    with torch.no_grad():
        out = block(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(emb))
    assert out.dtype == BF
    assert_bf16_close(out.permute(0, 2, 3, 1), ref[jnp.bfloat16],
                      ref[jnp.float32], "ResBlock")


@pytest.mark.parametrize("arch,batch", [
    (SMALL, 3), (GRF16, 2), (dict(SMALL, attention_impl="unfused"), 3)],
    ids=["small", "grf16", "small-unfused"])
def test_vorticity_unet_bf16_matches_jax(arch, batch):
    """The whole score net in bf16, the JAX model's fp32 parameters loaded
    into the port's bf16 model; the score leaves it as fp32."""
    rng = np.random.default_rng(3)
    kw = dict(arch, premodule="NormalizeLogRadius", in_space=16,
              flatten_order="F")
    x = (3.0 * rng.standard_normal((batch, 256))).astype(np.float32)
    t = rng.random(batch).astype(np.float32)
    shapes = jax.eval_shape(JaxVorticityUNet(**kw).init,
                            jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(t))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng)
    ref = {dt: jax.jit(JaxVorticityUNet(**kw, dtype=dt).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t))
        for dt in (jnp.bfloat16, jnp.float32)}
    assert ref[jnp.bfloat16].dtype == jnp.float32
    model = load_flax_params(VorticityUNet(**kw, dtype=BF), params)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t))
    assert out.dtype == torch.float32
    assert_bf16_close(out, ref[jnp.bfloat16], ref[jnp.float32], "U-Net",
                      tol=5e-2)


def _small_bf16_gen(parameterization="direct"):
    sde = SGMSde.create(num_steps_forward=4, device="cpu")
    torch.manual_seed(0)
    net = VorticityUNet(**SMALL, in_space=16, flatten_order="F", dtype=BF)
    return PluginReverseSDE.create(sde, net,
                                   parameterization=parameterization)


def test_score_boundary_is_state_dtype():
    """The SDE state and the score stay fp32 around a bf16 net, so the SSM
    loss (one JVP through the bf16 net) and its reduction run in fp32."""
    gen = _small_bf16_gen("eps")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 256, generator=g)
    a = gen.score(x, torch.full((4,), 0.5))
    assert a.dtype == torch.float32
    loss = gen.ssm(g, x)
    assert loss.dtype == torch.float32 and torch.isfinite(loss).all()
    loss.mean().backward()
    assert all(p.grad.dtype == torch.float32
               for p in gen.score_net.parameters() if p.grad is not None)


def test_bf16_training_keeps_fp32_state():
    """Three bf16 SSM steps with EMA: parameters, Adam moments and EMA stay
    fp32 and the parameters move; a net with bf16 parameters is refused."""
    gen = _small_bf16_gen("eps")
    before = [p.detach().clone() for p in gen.score_net.parameters()]
    trainer = Trainer(gen, SmoothedGRF(16, 2.0, device="cpu"), lr=1e-3,
                      batch_size=2, ema_rate=0.999, log_fn=lambda *_: None)
    state, loss = trainer.run(torch.Generator().manual_seed(2), 3)
    assert state.step == 3 and np.isfinite(loss)
    moments = [v for st in trainer.optimizer.state.values()
               for v in st.values() if isinstance(v, torch.Tensor) and v.ndim]
    for t in (*state.params.values(), *state.ema_params.values(), *moments):
        assert t.dtype == torch.float32
    assert any(not torch.equal(p, q) for p, q in zip(
        gen.score_net.parameters(), before))
    bad = _small_bf16_gen()
    bad.score_net.to(BF)
    with pytest.raises(ValueError, match="float32"):
        Trainer(bad, None)


def _fields_equal(ours, ref, where):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _fields_equal(a, b, f"{where}.{f.name}")
        else:
            assert a == b and type(a) is type(b), (where, f.name, a, b)


@pytest.mark.parametrize("name", ["grf16_production", "grf16_production_dbg"])
def test_production_presets_match_jax(name):
    _fields_equal(configs.get_preset(name), jax_configs.get_preset(name),
                  name)
    with pytest.raises(NotImplementedError, match="item 11"):
        configs.get_preset(name.replace("production", "production_dit"))


def test_bf16_launch_plans():
    """K5's plan in bf16 (``fwd_bf16_plan``) takes 16-byte vectors of 8
    elements where S is a multiple of 8, one block for a slab of 1,536;
    K3's bf16 plan holds grf16's blocks with the weights
    resident and two x buffers a warpgroup (two warpgroups at T = 64, one
    unit of 4 samples at T = 16), its shared memory as attnblock.cu lays
    it out (tests/test_torch_attn_bf16_plan.py holds the mirror to the
    source); the fp32 plan keeps its own."""
    assert gnk.vector_width(BF) == 8 and gnk.vector_width(torch.float32) == 4
    assert tuple(gnk.fwd_bf16_plan(6 * 256, 256, True)) == (
        "cluster", 256, 1, 1, 8)
    assert tuple(gnk.fwd_bf16_plan(2 * 64, 64, True)) == (
        "small", 16, 1, 1, 8)
    assert tuple(gnk.fwd_bf16_plan(2 * 64, 60, True)) == (
        "small", 32, 1, 4, 1)
    plan64 = ab.block_plan(64, 64, 32, 1, BF)
    plan16 = ab.block_plan(16, 128, 32, 1, BF)
    assert plan64 == ab.Bf16Plan(1, 64, 2, 1, 2)
    assert plan16 == ab.Bf16Plan(4, 64, 1, 1, 2)
    assert ab.block_plan(16, 128, 32, 1) == (2, 0)
    # 1,024 to align; Wqkv^T (192 rows) and Wproj^T (64) of one 64-column
    # block; 2 KB of vectors; per warpgroup K and V (8 KB each), two x
    # buffers and h (64 rows of 72 bf16), the (scale, shift) pairs: 45,056
    assert ab._smem_bytes_bf16(64, 64, 32, 1, plan64) == 125_952
    assert ab._smem_bytes_bf16(16, 128, 32, 1, plan16) == 224_256
    # the unfused route's attention kernels take bf16; float16 still raises
    assert attn_k._checked(torch.zeros(1, 4, 24, dtype=BF), 1,
                           "qkv_attention")[0].dtype == BF
    with pytest.raises(NotImplementedError, match="float16"):
        attn_k._checked(torch.zeros(1, 4, 24, dtype=torch.float16), 1,
                        "qkv_attention")


def test_production_dbg_cli_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    """grf16_production_dbg through the CLI on the CPU at full width: bf16
    compute, EMA, eps on the SGM arm, EM with one corrector step."""
    monkeypatch.chdir(tmp_path)
    res = run.main(["--preset", "grf16_production_dbg", "--cpu",
                    "--no-plots", "--eval-mmd", "--iterations", "2",
                    "--num-samples", "6", "--steps-backward", "2",
                    "--results-dir", str(tmp_path / "res")])
    out = capsys.readouterr().out
    assert "preset = grf16_production_dbg" in out
    for k in ("mmd_sgm", "mmd_msgm", "mmd_ref"):  # the dbg sweep's two
        assert res[k].shape == (1, 2, 1, 1, 1)  # train-set sizes
        assert np.isfinite(res[k]).all()
    assert make_model(configs.get_preset("grf16_production_dbg"), 256,
                      None, device="cpu").core.conv_in.compute_dtype == BF
