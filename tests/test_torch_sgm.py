"""The SGM arm: the VP SDE (its methods' cases in
tests/test_torch_sgm_methods.py), the DSM loss (direct, eps, debias) and DSM
training, and the SSM loss and ELBO that the driver trains and reports the
arm by, against the JAX package with its draws replayed.

JAX's dsm(key, x) splits key into key_t (t: uniform, or the debiasing law's
uniform) and key_y (the kernel's ε); the port takes t and ε injected. The
U-Net case runs the small VorticityUNet without a premodule on the
"unfused" route, with the attention threshold patched to 32 and key tiles
of 16 on both sides, so that its 8×8 attention (T = 64) goes through the
flash pair: K7a/K7b's plain versions here, the JAX package's Pallas pair
in interpret mode under SDEFLOW_FLASH_VJP (patched on). Tolerances
(float32): the SDE's methods rtol 1e-6 / atol 1e-6 (atol 1e-5 where β up
to 20 multiplies products taken in another order); the debiasing law's t
atol 1e-5; the DSM loss per sample rtol 1e-5; the U-Net's loss rtol 1e-4
and each gradient leaf max |Δ| ≤ 1e-4·max |g|, a leaf that is zero in
exact arithmetic held to 1e-4 of the largest leaf's, as
test_torch_train.py."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.models.vorticity import VorticityUNet as JaxVorticityUNet
from sdeflow_tpu.ops.hutchinson import sample_v as jax_sample_v
from sdeflow_tpu.ops.pallas import attention as jax_attn
from sdeflow_tpu.ops.pallas import common as jax_common
from sdeflow_tpu.sde.reverse import PluginReverseSDE as JaxReverse
from sdeflow_tpu.sde.sgm import SGMSde as JaxSGM
from sdeflow_tpu_torch.configs import _grf
from sdeflow_tpu_torch.data.synthetic import SmoothedGRF
from sdeflow_tpu_torch.experiments.driver import build_sgm_arm
from sdeflow_tpu_torch.models.convert import (
    load_flax_params, state_dict_to_flax)
from sdeflow_tpu_torch.models.vorticity import VorticityUNet
from sdeflow_tpu_torch.ops.kernels import attention as A
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde
from sdeflow_tpu_torch.training import Trainer, build_optimizer
from sdeflow_tpu_torch.training.train import TrainState, make_train_step

torch.set_num_threads(1)
KW = dict(beta_min=0.1, beta_max=20.0, T=1.0, t_epsilon=1e-3,
          num_steps_forward=16)
B, D = 4, 256
ARCH = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), premodule=None, in_space=16,
            flatten_order="F", attention_impl="unfused")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def sdes():
    return JaxSGM.create(**KW), SGMSde.create(**KW, device="cpu")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, D)).astype(np.float32)
    w = rng.standard_normal((B, D)).astype(np.float32)
    t = np.array([1e-3, 0.05, 0.5, 1.0], np.float32)
    return y, w, t


METHODS = {
    "mean_weight": lambda s, m, y, w, t: s.mean_weight(m.asarray(t)),
    "var": lambda s, m, y, w, t: s.var(m.asarray(t)),
    "_B": lambda s, m, y, w, t: s._B(m.asarray(t)),
    "f": lambda s, m, y, w, t: s.f(m.asarray(t), m.asarray(y)),
    "f_strato": lambda s, m, y, w, t: s.f_strato(m.asarray(t), m.asarray(y)),
    "div_sigma": lambda s, m, y, w, t: s.div_sigma(m.asarray(t),
                                                   m.asarray(y)),
    "g_diag": lambda s, m, y, w, t: s.g_diag(m.asarray(t), m.asarray(y)),
    "sigma_apply": lambda s, m, y, w, t: s.sigma_apply(
        m.asarray(t), m.asarray(y), m.asarray(w)),
    "sigma_apply_number": lambda s, m, y, w, t: s.sigma_apply(
        0.3, m.asarray(y), m.asarray(w)),
    "log_latent_pdf": lambda s, m, y, w, t: s.log_latent_pdf(m.asarray(y)),
    "log_normal": lambda s, m, y, w, t: s.log_normal(
        m.asarray(y), m.asarray(w), m.asarray(0.1 * w)),
}


class _Torch:
    @staticmethod
    def asarray(a):
        return torch.from_numpy(np.asarray(a, np.float32))


def test_closed_form_kernel_and_latents_match_jax(sdes):
    jsde, tsde = sdes
    y, _, t = _inputs(1)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (B, D)))
    ref = jsde.sample(key, jnp.asarray(t), jnp.asarray(y), return_noise=True)
    out = tsde.sample(None, _t(t), _t(y), noise=_t(eps), return_noise=True)
    for a, r in zip(out, ref):
        np.testing.assert_allclose(np.broadcast_to(a.numpy(), np.shape(r)),
                                   np.asarray(r), rtol=1e-6, atol=1e-6)
    # the MSGM signature's one-step draw is the same ε
    torch.testing.assert_close(tsde.sample(None, _t(t), _t(y),
                                           noise_one=_t(eps)), out[0])
    ref_T = jsde.cond_latent_sample(key, None, jnp.asarray(y))
    np.testing.assert_allclose(
        tsde.cond_latent_sample(None, None, _t(y), z=_t(eps)).numpy(),
        np.asarray(ref_T), rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    z = tsde.latent_sample(g, 20_000, 3)
    assert z.shape == (20_000, 3) and abs(z.std().item() - 1.0) < 0.02


def test_debiasing_t_matches_jax(sdes):
    jsde, tsde = sdes
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (4096,)))
    ref = np.asarray(jsde.sample_debiasing_t(key, (4096,)))
    out = tsde.sample_debiasing_t(None, (4096,), u=_t(u)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert out.min() >= KW["t_epsilon"] and out.max() <= KW["T"]


def _jax_draws(jgen, key, x):
    """JAX dsm's t and ε (sdeflow_tpu/sde/reverse.py:288-293)."""
    key_t, key_y = jax.random.split(key)
    if jgen.debias:
        u = jax.random.uniform(key_t, (x.shape[0],))
    else:
        u = jgen.sample_t(key_t, x.shape[0])
    return np.asarray(u), np.asarray(jax.random.normal(key_y, x.shape))


@pytest.mark.parametrize("param,debias", [("direct", False), ("eps", False),
                                          ("direct", True)],
                         ids=["direct", "eps", "debias"])
def test_dsm_per_sample_matches_jax(sdes, param, debias):
    jsde, tsde = sdes
    rng = np.random.default_rng(7)
    wmat = (rng.standard_normal((D, D)) / 16).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)

    def jnet(p, y, t):
        return jnp.tanh(y @ p) * (1.0 + t[:, None])

    def tnet(y, t):
        return torch.tanh(y @ torch.from_numpy(wmat)) * (1.0 + t[:, None])

    jgen = JaxReverse.create(jsde, jnet, jnp.asarray(wmat),
                             parameterization=param, debias=debias)
    tgen = PluginReverseSDE.create(tsde, tnet, parameterization=param,
                                   debias=debias)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jgen.dsm(key, jnp.asarray(x)))
    u, eps = _jax_draws(jgen, key, x)
    t = (tsde.sample_debiasing_t(None, (B,), u=_t(u)) if debias else _t(u))
    out = tgen.dsm(None, _t(x), t=t, noise=_t(eps))
    assert out.shape == (B,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("param", ["direct", "eps"])
def test_ssm_and_elbo_match_jax(sdes, param):
    """The SSM loss per sample and the ELBO (one JVP of the score net
    through the closed-form kernel), with JAX's draws replayed: t, the
    kernel's ε and the probe v of ssm's key, the conditional latent's ε of
    the ELBO's."""
    jsde, tsde = sdes
    rng = np.random.default_rng(8)
    wmat = (rng.standard_normal((D, D)) / 16).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)

    def jnet(p, y, t):
        return jnp.tanh(y @ p) * (1.0 + t[:, None])

    def tnet(y, t):
        return torch.tanh(y @ torch.from_numpy(wmat)) * (1.0 + t[:, None])

    jgen = JaxReverse.create(jsde, jnet, jnp.asarray(wmat),
                             parameterization=param)
    tgen = PluginReverseSDE.create(tsde, tnet, parameterization=param)
    key = jax.random.PRNGKey(21)
    key_ssm, key_lat = jax.random.split(key)
    ref_ssm, ref_elbo = (np.asarray(a) for a in jax.jit(lambda xx: (
        jgen.ssm(key_ssm, xx), jgen.elbo_random_t_slice(key, xx)))(
            jnp.asarray(x)))
    key_txy, key_v = jax.random.split(key_ssm)
    key_t, key_y = jax.random.split(key_txy)
    draws = dict(t=_t(jgen.sample_t(key_t, B)),
                 noise=_t(jax.random.normal(key_y, (B, D))),
                 v=_t(jax_sample_v(key_v, (B, D), jgen.vtype)))
    out = tgen.ssm(None, _t(x), **draws)
    with torch.no_grad():
        elbo = tgen.elbo_random_t_slice(
            None, _t(x), z=_t(jax.random.normal(key_lat, (B, D))), **draws)
    for got, ref in ((out.detach().numpy(), ref_ssm), (elbo.numpy(),
                                                         ref_elbo)):
        assert got.shape == ref.shape == (B,)
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def _randomize(tree, rng):
    """Random non-zero leaves: kernels N(0, 1/fan_in), norm scales
    1 + N(0, 0.01), everything else N(0, 0.01)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(v, rng)
        elif k == "kernel":
            out[k] = (rng.standard_normal(v.shape)
                      / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
        else:
            base = 1.0 if k == "scale" else 0.0
            out[k] = (base + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return out


def test_dsm_unet_train_step_matches_jax(monkeypatch):
    for mod in (A, jax_attn):
        monkeypatch.setattr(mod, "_FLASH_SEQ_THRESHOLD", 32)
        monkeypatch.setattr(mod, "_FLASH_KV_BLOCK", 16)
    monkeypatch.setattr(jax_common, "_FLASH_VJP", True)
    net = VorticityUNet(**ARCH)
    rng = np.random.default_rng(0)
    params = _randomize(state_dict_to_flax(dict(net.named_parameters()), net),
                        rng)
    load_flax_params(net, params)
    jsde = JaxSGM.create(**KW)
    jgen = JaxReverse.create(jsde, JaxVorticityUNet(**ARCH).apply,
                             {"params": params})
    x = rng.standard_normal((B, D)).astype(np.float32)
    key = jax.random.PRNGKey(13)

    def loss(p):
        per = jgen.replace(a_params={"params": p}).dsm(key, jnp.asarray(x))
        return per.mean()

    with jax_common.force_interpret():
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss)).lower(
            params).compile(compiler_options={
                "xla_backend_optimization_level": 0})(params)
    u, eps = _jax_draws(jgen, key, x)
    tgen = PluginReverseSDE.create(SGMSde.create(**KW, device="cpu"), net)
    calls = []
    stats = A.attention_flash_stats_math
    monkeypatch.setattr(A, "attention_flash_stats_math",
                        lambda *a: (calls.append(1), stats(*a))[1])
    step = make_train_step(build_optimizer(net.parameters(), 1e-3),
                           loss="dsm")
    state, value = step(TrainState(gen_sde=tgen), None, _t(x), t=_t(u),
                        noise=_t(eps))
    assert state.step == 1 and len(calls) == 4  # every attention block
    np.testing.assert_allclose(value.item(), float(ref_loss), rtol=1e-4)
    grads = state_dict_to_flax({n: p.grad for n, p in net.named_parameters()},
                               net)
    ref = jax.device_get(ref_grads)
    flat = jax.tree_util.tree_leaves_with_path(ref)
    gmax = max(np.abs(v).max() for _, v in flat)
    for path, r in flat:
        keys = [p.key for p in path]
        g = grads
        for k in keys:
            g = g[k]
        scale = np.abs(r).max()
        if scale < 1e-6 * gmax:  # zero in exact arithmetic (the time
            scale = gmax         # path: one channel per GroupNorm group)
        assert np.abs(g - r).max() <= 1e-4 * scale, (keys, scale)


def test_trainer_takes_two_dsm_steps_on_the_cpu():
    cfg = _grf(16)
    cfg = replace(cfg, train=replace(
        cfg.train, base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
        attention_resolutions=(2,), parameterization="eps"))
    g = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    net, gen = build_sgm_arm(cfg, g, device="cpu")
    assert net.premodule is None and gen.parameterization == "eps"
    sde = gen.base_sde
    assert (sde.beta_min, sde.beta_max, sde.t_epsilon,
            sde.num_steps_forward) == (0.1, 20.0, 4e-3, 64)
    with torch.no_grad():  # the zero-init output conv would stall training
        net.core.conv_out.weight.normal_(0.0, 0.05)
    before = [p.detach().clone() for p in net.parameters()]
    data = SmoothedGRF(16, 2.0, device="cpu")
    logs = []
    trainer = Trainer(gen, data, lr=1e-3, batch_size=3, loss="dsm",
                      log_fn=logs.append)
    state, loss = trainer.run(g, 2, x_test=data.sample(g, 3))
    assert state.step == 2 and np.isfinite(loss) and len(logs) == 2
    assert all(np.isfinite(h["elbo"]) for h in trainer.history)
    assert max((p.detach() - q).abs().max().item()
               for p, q in zip(net.parameters(), before)) > 0
    if not torch.cuda.is_available():  # entry points refuse the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            build_sgm_arm(cfg, g)
