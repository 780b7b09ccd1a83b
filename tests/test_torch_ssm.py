"""The SSM loss and the ELBO of the training path against the JAX package,
with JAX's draws replayed: t, the forward solve's normals and the probe v
from the key splits of ``ssm`` (sde/reverse.py:258, :238, sde/base.py:100),
the conditional latent's normal from ``elbo_random_t_slice``'s.

A closed-form score net keeps the JAX compiles small (the U-Net's loss and
parameter gradients are in test_torch_train.py). The forward solve takes 8
steps under β 0.1→20 (see test_torch_forward.py), in the random-t mode
(with samples below one grid step) and the ssm_intT mode. Tolerances
(float32): rtol 1e-4, atol 1e-4 of the largest value."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.eval.elbo import evaluate as jax_evaluate
from sdeflow_tpu.ops.hutchinson import sample_v as jax_sample_v
from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu.sde.reverse import PluginReverseSDE as JaxReverse
from sdeflow_tpu_torch.eval.elbo import evaluate
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE

torch.set_num_threads(1)
RTOL = 1e-4
B, D, STEPS = 4, 256, 8
KW = dict(beta_min=0.1, beta_max=20.0, T=1.0, t_epsilon=4e-3,
          num_steps_forward=STEPS, dense_tensor=False, norm_sampler="ecdf",
          norm_map="log")


def _data(n, seed):
    rng = np.random.default_rng(seed)
    scale = np.exp(0.3 * rng.standard_normal((n, 1)))
    return (scale * rng.standard_normal((n, D))).astype(np.float32)


def _closed_form_pair(ssm_intT):
    # no KDE normalizing constant, as the driver builds the arm (the
    # constant itself is held against JAX in test_torch_forward.py); in
    # intT mode a t_epsilon above the first grid time, so that the grid's
    # first step is dropped
    y0 = _data(512, 0)
    kw = dict(KW, estimate_norm_constant=False,
              t_epsilon=0.13 if ssm_intT else KW["t_epsilon"])
    jsde = JaxMSGM.create(jax.random.PRNGKey(0), jnp.asarray(y0), **kw)
    tsde = MSGMSde.create(torch.from_numpy(y0), **kw)
    jgen = JaxReverse.create(
        jsde, lambda p, y, t: -p["s"] * y * t[:, None] + jnp.sin(y),
        {"s": jnp.asarray(0.7)}, ssm_intT=ssm_intT)
    tgen = PluginReverseSDE.create(
        tsde, lambda y, t: -0.7 * y * t[:, None] + torch.sin(y),
        ssm_intT=ssm_intT)
    assert tgen.intT_start == jgen.intT_start == (1 if ssm_intT else 0)
    return jgen, tgen


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssm_draws(jgen, key, x):
    """The draws JAX's ssm(key, x) makes, as tensors for the port's."""
    key_txy, key_v = jax.random.split(key)
    key_t, key_y = jax.random.split(key_txy)
    b = x.shape[0]
    if jgen.ssm_intT:
        noise = [jax.random.normal(jax.random.fold_in(key_y, i), x.shape)
                 for i in range(STEPS)]
        s = STEPS - jgen.intT_start
        return dict(noise=_t(np.stack(noise)),
                    v=_t(jax_sample_v(key_v, (s * b, D), jgen.vtype)))
    key_traj, key_one = jax.random.split(key_y)
    noise = [jax.random.normal(jax.random.fold_in(key_traj, i), x.shape)
             for i in range(STEPS)]
    return dict(t=_t(jgen.sample_t(key_t, b)), noise=_t(np.stack(noise)),
                noise_one=_t(jax.random.normal(key_one, x.shape)),
                v=_t(jax_sample_v(key_v, x.shape, jgen.vtype)))


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.fixture(scope="module", params=[False, True], ids=["t", "intT"])
def closed_form(request):
    """Both generators in one ssm_intT mode, and JAX's ssm, ELBO and
    evaluate on one batch from one compile: ssm with the key the ELBO
    passes it, so that the two share their draws."""
    jgen, tgen = _closed_form_pair(request.param)
    x = _data(B, 2)
    key = jax.random.PRNGKey(12)
    key_ssm, key_lat = jax.random.split(key)

    @jax.jit
    def ref(xx):
        return (jgen.ssm(key_ssm, xx), jgen.elbo_random_t_slice(key, xx),
                jax_evaluate(jgen, key, xx))

    draws = _ssm_draws(jgen, key_ssm, x)
    n = B * (STEPS - jgen.intT_start if request.param else 1)
    z = _t(jax.random.normal(key_lat, (n, D)))
    return jgen, tgen, x, ref(jnp.asarray(x)), draws, z


def test_per_sample_ssm_matches_jax(closed_form):
    jgen, tgen, x, (ref, _, _), draws, _ = closed_form
    if not jgen.ssm_intT:  # some samples take the one-step fallback
        assert (draws["t"] * STEPS < 1).any()
    out = tgen.ssm(None, torch.from_numpy(x), **draws)
    assert out.shape == ref.shape
    _close(out.detach().numpy(), ref)


def test_elbo_matches_jax(closed_form):
    _, tgen, x, (_, ref_elbo, (ref_mean, ref_err)), draws, z = closed_form
    with torch.no_grad():
        elbo = tgen.elbo_random_t_slice(None, torch.from_numpy(x), z=z,
                                        **draws)
        mean, err = evaluate(tgen, None, torch.from_numpy(x), z=z, **draws)
    _close(elbo.numpy(), ref_elbo)
    _close(float(mean), ref_mean)
    _close(float(err), ref_err)
