"""The probability-flow ODE samplers of the port (ops/ode.py, the
Dormand–Prince solve of ops/odeint.py) against the JAX package's
(sdeflow_tpu/ops/ode.py, jax.experimental.ode.odeint), and the twins of the
analytic oracles of tests/test_ode.py.

Parity: the same latents, made with numpy from a seed, through both
packages' ``integrate_ode`` and ``encode_ode`` on two flows whose score is
one closed-form function written in both: VP-SGM with the exact score of
Gaussian data N(0, Σ0) in d = 3 (tests/test_ode.py:28-66) and the
circulant MSGM at d = 16 with a nonlinear score. Fixed-step methods to
1e-5 relative (float32 both sides, the same steps; the port's times are
Python numbers where JAX's are float32); "dopri" within 10·(atol +
rtol·|y|) of ``jax.experimental.ode.odeint`` (one error ratio for the
whole state on both sides, so they take the same steps where the error
estimates stand above float32 rounding; see the test) and against a dense
RK4 solution. The slice as a whole: ODE sampling with a grf16_dbg
VorticityUNet (the grf16 architecture) whose flax weights are carried
across by ``models/convert.load_flax_params``, on the circulant MSGM at
d = 256; tolerance 1e-4·max |x| (the score net's own parity,
tests/test_torch_models.py, is 1e-4 absolute on outputs of order 1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.ode import odeint as jax_odeint

from sdeflow_tpu.models import VorticityUNet as JaxVorticityUNet
from sdeflow_tpu.ops.ode import encode_ode as jax_encode
from sdeflow_tpu.ops.ode import integrate_ode as jax_integrate
from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu.sde.reverse import PluginReverseSDE as JaxReverse
from sdeflow_tpu.sde.sgm import SGMSde as JaxSGM
from sdeflow_tpu_torch.configs import get_preset
from sdeflow_tpu_torch.models.convert import load_flax_params
from sdeflow_tpu_torch.models.vorticity import VorticityUNet
from sdeflow_tpu_torch.ops.ode import encode_ode, integrate_ode
from sdeflow_tpu_torch.ops.odeint import odeint
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde
from sdeflow_tpu_torch.serving import make_sampler_fn

torch.set_num_threads(1)
D, DM = 3, 16
EIGVALS = np.array([0.5, 1.0, 2.0], np.float32)
Q = np.linalg.qr(np.random.default_rng(7).standard_normal((D, D)))[0].astype(
    np.float32)
COV0 = (Q @ np.diag(EIGVALS) @ Q.T).astype(np.float32)


def _gauss_score(sde, lib, t, y):
    """√β·∇log p_t of N(0, Σ0) data under the VP kernel, in `lib`."""
    t = t.reshape(-1, 1)
    inv = 1.0 / (sde.mean_weight(t) ** 2 * lib.asarray(EIGVALS)[None, :]
                 + sde.var(t))
    q = lib.asarray(Q)
    return lib.sqrt(sde.beta(t)) * (-((y @ q) * inv) @ q.T)


class _Torch:  # the torch side of _gauss_score's array calls
    asarray = staticmethod(torch.as_tensor)
    sqrt = staticmethod(torch.sqrt)


def _gauss_pair(t_epsilon=1e-4, beta_max=20.0):
    kw = dict(t_epsilon=t_epsilon, num_steps_forward=16, beta_max=beta_max)
    jsde, tsde = JaxSGM.create(**kw), SGMSde.create(**kw, device="cpu")
    return (JaxReverse.create(jsde, lambda p, y, t: _gauss_score(
                jsde, jnp, t, y), {}),
            PluginReverseSDE.create(tsde, lambda y, t: _gauss_score(
                tsde, _Torch, t, y)))


def _msgm_pair(d=DM, score=None):
    """The circulant MSGM with grf16's schedule on data in R^d, both
    packages, and a nonlinear score (or the given pair of nets)."""
    tc = get_preset("grf16").train
    kw = dict(beta_min=tc.beta_min, beta_max=tc.beta_max, T=tc.T0,
              t_epsilon=tc.t_eps, num_steps_forward=tc.num_steps_forward,
              dense_tensor=False, norm_map=tc.norm_map)
    rng = np.random.default_rng(0)
    y0 = (np.exp(0.2 * rng.standard_normal((256, 1)))
          * rng.standard_normal((256, d))).astype(np.float32)
    jsde = JaxMSGM.create(jax.random.PRNGKey(1), jnp.asarray(y0),
                          estimate_norm_constant=False, **kw)
    tsde = MSGMSde.create(torch.from_numpy(y0), **kw)
    if score is None:
        score = (lambda p, y, t: (-jnp.tanh(y) * (1.0 + t.reshape(-1, 1))
                                  + 0.1 * jnp.roll(y, 1, axis=-1)), {},
                 lambda y, t: (-torch.tanh(y) * (1.0 + t.reshape(-1, 1))
                               + 0.1 * torch.roll(y, 1, dims=-1)))
    jscore, jparams, tscore = score
    return (JaxReverse.create(jsde, jscore, jparams),
            PluginReverseSDE.create(tsde, tscore))


def _latents(n, d, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (n, d))).astype(np.float32)


def _close(out, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
@pytest.mark.parametrize("arm", ["sgm", "msgm"])
def test_fixed_step_ode_matches_jax(arm, method):
    jgen, tgen = _gauss_pair() if arm == "sgm" else _msgm_pair()
    d = D if arm == "sgm" else DM
    x0 = _latents(8, d, scale=2.0)
    nc = arm == "msgm"
    ref = jax.jit(lambda z: jax_integrate(
        jgen, z, 12, method=method, norm_correction=nc, keep_all=True,
        include_t0=True))(jnp.asarray(x0))
    out = integrate_ode(tgen, torch.from_numpy(x0), 12, method=method,
                        norm_correction=nc, keep_all=True, include_t0=True)
    assert out.shape == (13, 8, d)
    _close(out, ref)
    if nc:  # the projection after every step pins every radius
        norms = out.norm(dim=-1)
        torch.testing.assert_close(norms, norms[0].expand_as(norms),
                                   rtol=1e-5, atol=0)


def test_encode_ode_matches_jax_and_inverts_the_sampler():
    jgen, tgen = _gauss_pair()
    x = _latents(8, D, seed=3)
    for kw in (dict(method="rk4"), dict(method="heun", t0=1e-4)):
        ref = jax.jit(lambda z: jax_encode(jgen, z, 16, **kw))(
            jnp.asarray(x))
        _close(encode_ode(tgen, torch.from_numpy(x), 16, **kw), ref)
    # tests/test_ode.py:282-295: encode inverts the sampler, 256 RK4 steps
    z = integrate_ode(tgen, torch.from_numpy(x), 256)
    back = encode_ode(tgen, z, 256)
    np.testing.assert_allclose(back.numpy(), x, atol=5e-3, rtol=0)


def _dopri_tol(ref, rtol=1e-5, atol=1e-5):
    return 10 * (atol + rtol * np.abs(np.asarray(ref)))


@pytest.mark.parametrize("arm,tol", [("sgm", 1e-3), ("msgm", 1e-5)])
def test_dopri_matches_jax_odeint(arm, tol):
    # SGM at tolerance 1e-3: at 1e-5 its error estimates fall to 1e-9, the
    # float32 rounding of the stages (the fields differ by 1e-6 between the
    # packages), so the step controller follows rounding noise on both
    # sides and the two sequences part (each 1e-3 from the dense RK4
    # solution then); MSGM's field keeps its estimates above the noise
    jgen, tgen = _gauss_pair() if arm == "sgm" else _msgm_pair()
    d = D if arm == "sgm" else DM
    x0 = _latents(16, d, seed=4, scale=2.0)
    nc = arm == "msgm"
    ref = jax.jit(lambda z: jax_integrate(
        jgen, z, 4, method="dopri", norm_correction=nc, keep_all=True,
        include_t0=True, rtol=tol, atol=tol))(jnp.asarray(x0))
    stats = {}
    out = integrate_ode(tgen, torch.from_numpy(x0), 4, method="dopri",
                        norm_correction=nc, keep_all=True, include_t0=True,
                        rtol=tol, atol=tol, stats=stats)
    assert out.shape == (5, 16, d)
    assert np.all(np.abs(out.numpy() - np.asarray(ref))
                  <= _dopri_tol(ref, tol, tol))
    assert stats["nfe"] == 2 + 6 * (stats["accepted"] + stats["rejected"])
    assert stats["accepted"] >= 1
    last = integrate_ode(tgen, torch.from_numpy(x0), 4, method="dopri",
                         norm_correction=nc, rtol=tol, atol=tol)
    np.testing.assert_array_equal(last.numpy(), out[-1].numpy())


def test_odeint_tuple_state_matches_jax():
    """A pytree state: one error ratio over both tensors, as odeint ravels
    it; y' = −y·(1 + t), ℓ' = Σ sin(y)."""
    rng = np.random.default_rng(5)
    y0 = rng.standard_normal((6, 4)).astype(np.float32)
    ts = np.array([0.0, 0.3, 1.0], np.float32)

    def jf(s, t):
        return (-s[0] * (1.0 + t), jnp.sin(s[0]).sum(-1))

    def tf(s, t):
        return (-s[0] * (1.0 + t), torch.sin(s[0]).sum(-1))

    ref = jax_odeint(jf, (jnp.asarray(y0), jnp.zeros(6)), jnp.asarray(ts),
                     rtol=1e-6, atol=1e-6)
    out = odeint(tf, (torch.from_numpy(y0), torch.zeros(6)), ts, rtol=1e-6,
                 atol=1e-6)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert np.all(np.abs(o.numpy() - np.asarray(r))
                      <= _dopri_tol(r, 1e-6, 1e-6))
    # the closed form of the first component
    exact = y0[None] * np.exp(-(ts + ts**2 / 2))[:, None, None]
    np.testing.assert_allclose(out[0].numpy(), exact, rtol=1e-4, atol=1e-5)


def test_ode_samplers_reproduce_the_data_law():
    """tests/test_ode.py:133-141 and 196-209: the PF-ODE with the exact
    score transports N(0, I) to N(0, Σ0); dopri lands on the dense RK4
    solution."""
    _, tgen = _gauss_pair()
    x0 = torch.from_numpy(_latents(8192, D, seed=6))
    for method, steps in (("rk4", 128), ("heun", 256)):
        x = integrate_ode(tgen, x0, steps, method=method).numpy()
        np.testing.assert_allclose(np.cov(x.T), COV0, atol=0.12)
        np.testing.assert_allclose(x.mean(0), np.zeros(D), atol=0.05)
    x_star = integrate_ode(tgen, x0[:512], 2048)
    x = integrate_ode(tgen, x0[:512], 8, method="dopri")
    assert (x - x_star).norm(dim=-1).max().item() < 0.05


def test_serving_ode_sampler_is_deterministic_but_for_the_latents():
    _, tgen = _gauss_pair()
    fn = make_sampler_fn(tgen, 16, D, 32, sampler="ode", device="cpu")
    a = fn(torch.Generator().manual_seed(0))
    b = fn(torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, fn(torch.Generator().manual_seed(1)))
    x0 = tgen.latent_sample(torch.Generator().manual_seed(2), 16, D)
    torch.testing.assert_close(fn(None, x0=x0), integrate_ode(tgen, x0, 32),
                               rtol=0, atol=0)
    # dopri under the serving dispatch, MSGM: finite, radii restored
    _, mgen = _msgm_pair()
    x0 = mgen.latent_sample(torch.Generator().manual_seed(3), 8, DM)
    y = make_sampler_fn(mgen, 8, DM, 4, method="dopri", sampler="ode",
                        norm_correction=True, device="cpu")(None, x0=x0)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y.norm(dim=-1), x0.norm(dim=-1), rtol=1e-5,
                               atol=0)


def _unet_pair(batch_seed=0):
    """grf16_dbg's VorticityUNet in both packages, the same random flax
    weights, as score nets of the circulant MSGM at d = 256."""
    arch = get_preset("grf16_dbg").train
    kw = dict(base_channels=arch.base_channels,
              channel_mults=arch.channel_mults,
              num_res_blocks=arch.num_res_blocks,
              attention_resolutions=arch.attention_resolutions,
              premodule="NormalizeLogRadius", in_space=16, flatten_order="F")
    jnet = JaxVorticityUNet(**kw)
    rng = np.random.default_rng(batch_seed)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256)), jnp.zeros((1,)))["params"]

    def rand(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = rand(v)
                continue
            a = rng.standard_normal(v.shape)
            if k == "kernel":
                a = a / np.sqrt(np.prod(v.shape[:-1]))
            elif k == "scale":
                a = 1.0 + 0.1 * a
            else:
                a = 0.1 * a
            out[k] = a.astype(np.float32)
        return out

    params = rand(shapes)
    # a gentler head, as chip_smoke.py's arms: |a| ~ 1
    params["core"]["conv_out"]["kernel"] = (
        0.1 * params["core"]["conv_out"]["kernel"])
    tnet = load_flax_params(VorticityUNet(**kw), params)
    return (lambda p, y, t: jnet.apply({"params": p}, y, t)), params, tnet


def test_grf16_dbg_unet_ode_sample_matches_jax():
    jscore, params, tnet = _unet_pair()
    jgen, tgen = _msgm_pair(256, score=(jscore, params, tnet))
    x0 = _latents(2, 256, seed=8, scale=0.5)
    ref = jax.jit(lambda z: jax_integrate(
        jgen, z, 3, method="rk4", norm_correction=True))(jnp.asarray(x0))
    with torch.no_grad():
        out = integrate_ode(tgen, torch.from_numpy(x0), 3, method="rk4",
                            norm_correction=True)
    ref = np.asarray(ref)
    assert np.isfinite(out.numpy()).all()
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
