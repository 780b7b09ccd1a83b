"""Training: the U-Net's SSM loss and parameter gradients, the optimizer,
the EMA, the train step and chunk, the Trainer and the driver's training
half, against the JAX package where it has a counterpart.

The gradients use the small U-Net of test_torch_sampling.py, on the fused
("auto") and the "unfused" AttentionBlock route, with every
weight random and non-zero, carried over by models/convert.py and mapped
back by its inverse, and JAX's draws replayed (test_torch_ssm.py); the
forward solve takes 8 steps under β 0.1→20 (test_torch_forward.py).
Tolerances (float32): the loss rtol 1e-4; each gradient leaf
max |Δ| ≤ 1e-4·max |g|, where a leaf whose gradient is zero in exact
arithmetic (|g| below 1e-6 of the largest leaf's: at this width every
GroupNorm has one channel per group, so the time embedding's path has no
gradient) is held to 1e-4 of the largest leaf's max |g|. The optimizer is
held against optax on identical gradients (comparing after training would
magnify the sign flips of near-zero gradients): the parameters rtol 1e-6,
and their displacement over the steps rtol 1e-3 (a difference of float32
numbers near 1 that moved by about lr = 1e-3 per step keeps three
digits)."""

import re
from dataclasses import replace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.configs import get_preset as jax_preset
from sdeflow_tpu.experiments.driver import ExperimentDriver
from sdeflow_tpu.models.vorticity import VorticityUNet as JaxVorticityUNet
from sdeflow_tpu.ops.hutchinson import sample_v as jax_sample_v
from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu.sde.reverse import PluginReverseSDE as JaxReverse
from sdeflow_tpu.training.train import (
    build_optimizer as jax_build_optimizer, ema_rate_at as jax_ema_rate_at,
    update_ema as jax_update_ema)
from sdeflow_tpu_torch.configs import get_preset
from sdeflow_tpu_torch.data.synthetic import SmoothedGRF
from sdeflow_tpu_torch.experiments.driver import fair_budgets, train_msgm_arm
from sdeflow_tpu_torch.models.convert import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from sdeflow_tpu_torch.models.vorticity import VorticityUNet
from sdeflow_tpu_torch.ops.kernels import common
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.training import (
    Trainer, TrainState, build_optimizer, ema_rate_at, make_train_chunk,
    make_train_step, update_ema)

torch.set_num_threads(1)
B, D, STEPS = 4, 256, 8
KW = dict(beta_min=0.1, beta_max=20.0, T=1.0, t_epsilon=4e-3,
          num_steps_forward=STEPS, dense_tensor=False, norm_sampler="ecdf",
          norm_map="log", estimate_norm_constant=False)
ARCH = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), premodule="NormalizeLogRadius",
            in_space=16, flatten_order="F")
SMALL_NET = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
                 attention_resolutions=(2,))


def _data(n, seed):
    rng = np.random.default_rng(seed)
    scale = np.exp(0.3 * rng.standard_normal((n, 1)))
    return (scale * rng.standard_normal((n, D))).astype(np.float32)


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


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flax_params(seed):
    """Random flax parameters of the small U-Net, shaped by the port's
    module through the inverse converter (no JAX trace of ``init``;
    test_inverse_converter_round_trips holds the shapes to flax's)."""
    net = VorticityUNet(**ARCH)
    shapes = state_dict_to_flax(dict(net.named_parameters()), net)
    params = _randomize(shapes, np.random.default_rng(seed))
    out_conv = params["core"]["conv_out"]
    out_conv["kernel"] = out_conv["kernel"] * np.float32(0.1)
    return params


@jax.jit
def _ssm_draws(key):
    """The draws of JAX's ssm(key, x) for (B, D) data, in one compile:
    the key splits of sde/reverse.py:258, :238 and sde/base.py:100."""
    key_txy, key_v = jax.random.split(key)
    key_t, key_y = jax.random.split(key_txy)
    key_traj, key_one = jax.random.split(key_y)
    t = jax.random.uniform(key_t, (B,))
    noise = jnp.stack([jax.random.normal(jax.random.fold_in(key_traj, i),
                                         (B, D)) for i in range(STEPS)])
    return (t, noise, jax.random.normal(key_one, (B, D)),
            jax_sample_v(key_v, (B, D)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_loss_and_parameter_gradients(attention_impl):
    arch = dict(ARCH, attention_impl=attention_impl)
    y0 = _data(512, 0)
    jsde = JaxMSGM.create(jax.random.PRNGKey(0), jnp.asarray(y0), **KW)
    tsde = MSGMSde.create(torch.from_numpy(y0), **KW)
    params = _flax_params(0)
    jgen = JaxReverse.create(jsde, JaxVorticityUNet(**arch).apply,
                             {"params": params})
    tnet = load_flax_params(VorticityUNet(**arch), params)
    tgen = PluginReverseSDE.create(tsde, tnet)
    x = _data(B, 3)
    key = jax.random.PRNGKey(13)

    def loss(p):
        per = jgen.replace(a_params={"params": p}).ssm(key, jnp.asarray(x))
        return per.mean(), per

    # XLA's backend optimizations off: 2 s less compile time here
    (ref_loss, ref_per), ref_grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True)).lower(params).compile(
            compiler_options={"xla_backend_optimization_level": 0})(params)
    u, noise, noise_one, v = _ssm_draws(key)
    t = np.maximum(np.asarray(u), KW["t_epsilon"])  # sample_t, T = 1
    per = tgen.ssm(None, torch.from_numpy(x), t=_t(t), noise=_t(noise),
                   noise_one=_t(noise_one), v=_t(v))
    per.mean().backward()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(ref_per),
                               rtol=1e-4, atol=1e-4 * np.abs(ref_per).max())
    np.testing.assert_allclose(float(per.detach().mean()), float(ref_loss),
                               rtol=1e-4)
    grads = state_dict_to_flax(
        {n: p.grad for n, p in tnet.named_parameters()}, tnet)
    ref_leaves = dict(_leaves(jax.device_get(ref_grads)))
    out_leaves = dict(_leaves(grads))
    assert out_leaves.keys() == ref_leaves.keys()
    gmax = max(np.abs(np.asarray(g)).max() for g in ref_leaves.values())
    live = 0
    for path, ref in ref_leaves.items():
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        if scale < 1e-6 * gmax:
            scale = gmax  # zero in exact arithmetic (module docstring)
        else:
            live += 1
        err = np.abs(out_leaves[path] - ref).max()
        assert err <= 1e-4 * scale, (path, err, scale)
    assert live >= 0.7 * len(ref_leaves)


def test_unet_loss_and_parameter_gradients_match_jax():
    _check_loss_and_parameter_gradients("auto")


def test_unfused_route_loss_and_parameter_gradients_match_jax():
    # GroupNorm (K5), the attention core (K6) and the two products of every
    # AttentionBlock as separate Functions and operators
    _check_loss_and_parameter_gradients("unfused")


def test_inverse_converter_round_trips():
    shapes = jax.eval_shape(JaxVorticityUNet(**ARCH).init,
                            jax.random.PRNGKey(0), jnp.zeros((2, D)),
                            jnp.zeros((2,)))
    params = _randomize(shapes["params"], np.random.default_rng(1))
    net = VorticityUNet(**ARCH)
    back = state_dict_to_flax(flax_to_state_dict(params, net), net)
    got, want = dict(_leaves(back)), dict(_leaves(params))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path])


@pytest.mark.parametrize("knobs", [
    {}, {"grad_clip": 0.5}, {"weight_decay": 0.1}, {"lr_warmup_steps": 2},
    {"grad_clip": 0.5, "weight_decay": 0.1, "lr_warmup_steps": 2}],
    ids=["adam", "clip", "adamw", "warmup", "all"])
def test_optimizer_matches_optax_on_identical_gradients(knobs):
    rng = np.random.default_rng(5)
    shapes = {"w": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    lr = 1e-3
    opt = build_optimizer(tparams.values(), lr, **knobs)
    if not knobs:
        assert type(opt) is torch.optim.Adam
    tx = jax_build_optimizer(lr, **knobs)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)

    @jax.jit
    def jax_step(grads, state, jparams):
        updates, state = tx.update(grads, state, jparams)
        return optax.apply_updates(jparams, updates), state

    for step in range(4):
        # small and large gradients, some near zero; the clip fires on
        # the large ones only
        scale = 0.01 if step == 1 else 1.0
        grads = {k: (scale * rng.standard_normal(s)
                     * (rng.random(s) > 0.2)).astype(np.float32)
                 for k, s in shapes.items()}
        jparams, state = jax_step(
            {k: jnp.asarray(g) for k, g in grads.items()}, state, jparams)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k, p in tparams.items():
            got, want = p.detach().numpy(), np.asarray(jparams[k])
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(got - params[k], want - params[k],
                                       rtol=1e-3, atol=1e-6)


def test_ema_matches_jax():
    for step in (1, 2, 10, 1000):
        for warmup in (True, False):
            assert ema_rate_at(0.999, step, warmup) == pytest.approx(
                float(jax_ema_rate_at(0.999, jnp.asarray(step), warmup)),
                rel=1e-6)
    rng = np.random.default_rng(6)
    tgt = {"a": rng.standard_normal((3, 2)).astype(np.float32)}
    src = {"a": rng.standard_normal((3, 2)).astype(np.float32)}
    ref = jax_update_ema({k: jnp.asarray(v) for k, v in tgt.items()},
                         {k: jnp.asarray(v) for k, v in src.items()}, 0.9)
    out = update_ema({k: torch.from_numpy(v) for k, v in tgt.items()},
                     {k: torch.from_numpy(v) for k, v in src.items()}, 0.9)
    np.testing.assert_allclose(out["a"].numpy(), np.asarray(ref["a"]),
                               rtol=1e-6)


def _small_arm(seed, steps=4):
    torch.manual_seed(seed)
    data = SmoothedGRF(16, 2.0, device="cpu")
    y0 = data.sample(torch.Generator().manual_seed(seed), 64)
    sde = MSGMSde.create(y0, **dict(KW, num_steps_forward=steps))
    net = VorticityUNet(**ARCH)
    with torch.no_grad():  # the zero-init output conv would stall training
        net.core.conv_out.weight.normal_(0.0, 0.05)
    return data, net, PluginReverseSDE.create(sde, net)


def test_train_chunk_equals_its_steps():
    runs = []
    for use_chunk in (False, True):
        data, net, gen = _small_arm(0, steps=2)
        opt = build_optimizer(net.parameters(), 1e-3)
        g = torch.Generator().manual_seed(1)
        state = TrainState(gen_sde=gen)
        if use_chunk:
            state, loss = make_train_chunk(opt, data.sample, 2)(state, g, 2)
        else:
            step = make_train_step(opt)
            for _ in range(2):
                state, loss = step(state, g, data.sample(g, 2))
        assert state.step == 2 and torch.isfinite(loss)
        runs.append([p.detach().clone() for p in net.parameters()])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_trainer_runs_three_steps_on_the_cpu():
    data, net, gen = _small_arm(2)
    before = [p.detach().clone() for p in net.parameters()]
    logs = []
    trainer = Trainer(gen, data, lr=1e-3, batch_size=3, print_every=2,
                      ema_rate=0.9, log_fn=logs.append)
    common.reset_launches()
    state, loss = trainer.run(torch.Generator().manual_seed(3), 3,
                              x_test=data.sample(torch.Generator(), 3))
    assert state.step == 3 and np.isfinite(loss)
    assert [h["step"] for h in trainer.history] == [1, 2, 3]
    assert all(np.isfinite(h["elbo"]) for h in trainer.history)
    assert len(logs) == 3 and "ms/step" in logs[0]
    assert all(k.launches == 0 for k in common.KERNELS.values())
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(net.parameters(), before))
    assert moved > 0
    ema_net = trainer.ema_gen_sde.score_net
    assert ema_net is not net
    for (n, p), (_, q) in zip(ema_net.named_parameters(),
                              net.named_parameters()):
        torch.testing.assert_close(p, state.ema_params[n])
    ram_logs = []  # print_ram: the memory_report line after each print
    Trainer(gen, data, batch_size=3, print_ram=True,
            log_fn=ram_logs.append).run(torch.Generator().manual_seed(4), 1)
    assert [m.split()[0] for m in ram_logs] == ["|", "RAM:"]
    assert re.fullmatch(r"RAM: host rss [\d,]+ MiB", ram_logs[1])
    with pytest.raises(NotImplementedError, match="item 14"):
        Trainer(gen, data, mesh=object())


def _small_grf16(**sweep):
    cfg = get_preset("grf16")
    return replace(cfg, train=replace(cfg.train, num_steps_forward=4,
                                      **SMALL_NET),
                   sweep=replace(cfg.sweep, **sweep))


def test_driver_trains_the_msgm_arm_on_the_cpu():
    cfg = _small_grf16(batch_sizes=(3,), iterationss=(2,))
    logs = []
    g = torch.Generator().manual_seed(4)
    x_test = SmoothedGRF(16, 2.0, device="cpu").sample(g, 3)
    trainer, gen, loss = train_msgm_arm(cfg, g, x_test=x_test, device="cpu",
                                        log_fn=logs.append)
    assert np.isfinite(loss) and trainer.state.step == 2
    assert gen.base_sde.r_T.shape == (6,)  # min(100k, iterations·batch)
    assert not any("use_checkpoint" in m for m in logs)  # no longer skipped
    if not torch.cuda.is_available():  # entry points refuse the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            train_msgm_arm(cfg, g)


@pytest.mark.parametrize("fair,intT", [(False, False), (True, False),
                                       (True, True)])
def test_fair_budgets_match_jax(fair, intT):
    ref_cfg, cfg = jax_preset("grf16"), get_preset("grf16")
    ref_cfg = replace(ref_cfg, sweep=replace(ref_cfg.sweep,
                                             fair_comparison=fair))
    cfg = replace(cfg, sweep=replace(cfg.sweep, fair_comparison=fair))
    drv = ExperimentDriver(ref_cfg, log_fn=lambda *_: None, make_plots=False)
    for is_msgm in (False, True):
        assert fair_budgets(cfg, is_msgm, intT, 256, 128, 100_000,
                            log_fn=lambda *_: None) == drv._fair_budgets(
            is_msgm, intT, 256, 128, 100_000)
