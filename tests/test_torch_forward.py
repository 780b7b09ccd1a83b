"""The forward perturbation of the training path: kernel K2's plain version,
the autograd rules of K1, K2 and K3, the forward solve (integrate_select,
sample_scheme, sample_scheme_allt), the Hutchinson estimator and the KDE,
against the JAX package.

Tolerances (float32 unless stated): K2's plain version atol 1e-5 against
``_rk4_math_fwd`` and the interpreted Pallas kernel (the same products in
the same order); the forward solve rtol/atol 1e-5; the KDE rtol 1e-5; the
autograd rules by ``gradcheck`` in float64 with forward mode on.

The forward solve runs 8 steps under JAX's default schedule β 0.1→20:
grf16's β up to 80 on a grid that coarse makes the unprojected RK4 grow the
states a million-fold, and float32 rounding with them (at grf16's own 64
steps the two agree to 3e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.ops.kde import (
    gaussian_kde_logpdf as jax_kde_logpdf,
    kde_normalization_log_constant as jax_kde_const)
from sdeflow_tpu.ops.pallas.circulant import (
    _rk4_math_fwd, circulant_rk4_step as jax_rk4_step)
from sdeflow_tpu.ops.pallas.common import force_interpret
from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu_torch.ops import hutchinson
from sdeflow_tpu_torch.ops.integrators import integrate_select, rk4_step
from sdeflow_tpu_torch.ops.kde import (
    gaussian_kde_logpdf, kde_normalization_log_constant)
from sdeflow_tpu_torch.ops.kernels import common
from sdeflow_tpu_torch.ops.kernels.attnblock import AttnBlock
from sdeflow_tpu_torch.ops.kernels.circulant import (
    K2, CircApply, RK4Step, circulant_rk4_step, rk4_layout, rk4_math_fwd)
from sdeflow_tpu_torch.sde.forward import ForwardFlow
from sdeflow_tpu_torch.sde.msgm import MSGMSde

torch.set_num_threads(1)
KW = dict(beta_min=0.1, beta_max=20.0, T=1.0, t_epsilon=4e-3,
          num_steps_forward=8, dense_tensor=False, norm_sampler="ecdf",
          norm_map="log")
B, D = 6, 256
# per-sample times: two below one grid step (n_int = 0), one at T
TIMES = np.array([0.05, 0.11, 0.3, 0.62, 0.999, 1.0], np.float32)


def _data(n=512, d=D, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.exp(0.3 * rng.standard_normal((n, 1)))
    return (scale * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def sdes():
    y0 = _data()
    jsde = JaxMSGM.create(jax.random.PRNGKey(0), jnp.asarray(y0), **KW)
    return jsde, MSGMSde.create(torch.from_numpy(y0), **KW)


def _k2_inputs(b, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    sb3 = (1.0 + rng.random((b, 3))).astype(dtype)
    x = rng.standard_normal((b, d)).astype(dtype)
    w = (0.3 * rng.standard_normal((b, d))).astype(dtype)
    return sb3, x, w


def test_k2_plain_matches_jax_math_and_interpreted_kernel():
    sb3, x, w = _k2_inputs(B, D)
    jargs = tuple(map(jnp.asarray, (sb3, x, w)))
    ref = np.asarray(_rk4_math_fwd(*jargs))
    with force_interpret():
        ref_kernel = np.asarray(jax_rk4_step(*jargs))
    before = K2.launches
    out = circulant_rk4_step(*map(torch.from_numpy, (sb3, x, w))).numpy()
    assert K2.launches == before  # the CPU path launches nothing
    assert np.abs(out - x).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out, ref_kernel, rtol=0, atol=1e-5)


def test_k2_launch_layout():
    # whole rows per block: several when d < 256 threads, one otherwise;
    # the stage buffers leave shared memory only for very wide rows
    assert rk4_layout(128, 256) == (1, 128, True)
    assert rk4_layout(1000, 16) == (16, 63, True)
    assert rk4_layout(3, 1024) == (1, 3, True)
    assert rk4_layout(2, 100_000) == (1, 2, False)


@pytest.mark.parametrize("name", ["K1", "K2", "K3"])
def test_autograd_rules_gradcheck(name):
    rng = np.random.default_rng(3)

    def t(*shape, base=0.0):
        a = base + rng.standard_normal(shape)
        return torch.tensor(a, dtype=torch.float64, requires_grad=True)

    if name == "K1":
        fn, args = CircApply.apply, (t(3, 1, base=1.5), t(3, 7), t(3, 7))
    elif name == "K2":
        fn, args = RK4Step.apply, (t(3, 3, base=1.5), t(3, 7), 0.3 * t(3, 7))
    else:
        c = 8
        fn = lambda *a: AttnBlock.apply(*a, 4, 2)  # noqa: E731
        args = (t(2, 5, c), t(c, base=1.0), t(c), t(c, 3 * c), t(3 * c),
                t(c, c), t(c))
    args = tuple(a.detach().requires_grad_() for a in args)
    assert torch.autograd.gradcheck(fn, args, check_forward_ad=True)


def test_grad_of_jvp_through_kernel_rules():
    # the SSM pattern: .backward() through a torch.func.jvp tangent that
    # passes a Function equals the same through the plain version
    rng = np.random.default_rng(4)
    sb3, x, w = (torch.from_numpy(a) for a in _k2_inputs(4, 16, 4, np.float64))
    theta = torch.tensor(rng.standard_normal(16), requires_grad=True)
    v = torch.from_numpy(rng.standard_normal((4, 16)))

    def loss(step):
        _, tan = torch.func.jvp(lambda y: step(sb3, y, torch.tanh(theta * y)),
                                (x,), (v,))
        return (tan * v).sum()

    g_rule = torch.autograd.grad(loss(circulant_rk4_step), theta)[0]
    g_plain = torch.autograd.grad(loss(rk4_math_fwd), theta)[0]
    torch.testing.assert_close(g_rule, g_plain, rtol=1e-12, atol=1e-12)


def test_use_kernel_is_decided_by_device_alone():
    y = torch.ones(2, 3, requires_grad=True)
    assert common.use_kernel(y, y) is False
    with pytest.raises(ValueError, match="mixed"):
        common.use_kernel(y, torch.empty(0, device="meta"))


def _jax_noise(key, steps, shape):
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), shape)) for i in range(steps)])


def test_sample_scheme_matches_jax(sdes):
    jsde, tsde = sdes
    y0 = _data(B, seed=1)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jax.jit(jsde.sample_scheme)(key, jnp.asarray(TIMES),
                                                 jnp.asarray(y0)))
    key_traj, key_one = jax.random.split(key)
    noise = _jax_noise(key_traj, KW["num_steps_forward"], (B, D))
    noise_one = np.array(jax.random.normal(key_one, (B, D)))
    out = tsde.sample(None, torch.from_numpy(TIMES), torch.from_numpy(y0),
                      noise=torch.from_numpy(noise),
                      noise_one=torch.from_numpy(noise_one)).numpy()
    assert np.abs(out - y0).max(axis=1).min() > 1e-3  # every sample moved
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_integrate_select_and_allt_match_jax(sdes):
    jsde, tsde = sdes
    y0 = _data(B, seed=2)
    key = jax.random.PRNGKey(8)
    steps = KW["num_steps_forward"]
    ref_all = np.asarray(jax.jit(lambda y: jsde.sample_scheme_allt(
        key, y, include_t0=True))(jnp.asarray(y0)))
    noise = torch.from_numpy(_jax_noise(key, steps, (B, D)))
    out_all = tsde.sample_scheme_allt(None, torch.from_numpy(y0),
                                      noise=noise).numpy()
    assert out_all.shape == (steps + 1, B, D)
    np.testing.assert_allclose(out_all, ref_all, rtol=1e-5, atol=1e-5)
    idx = torch.tensor([0, 1, 3, 8, 5, 0])
    flow = ForwardFlow(base_sde=tsde, T=tsde.T)
    kept = integrate_select(flow, torch.from_numpy(y0), None, steps, idx,
                            noise=noise).numpy()
    np.testing.assert_allclose(kept, out_all[idx.numpy(), np.arange(B)],
                               rtol=0, atol=0)


def test_fused_forward_step_equals_generic_stages(sdes):
    _, tsde = sdes
    flow = ForwardFlow(base_sde=tsde, T=tsde.T)
    x = torch.from_numpy(_data(B, seed=3))
    dw = 0.2 * torch.from_numpy(_data(B, seed=4))
    for t in (0.25, torch.from_numpy(TIMES)):
        fused = flow.rk4_step(t, x, 0.125, dw)
        generic = rk4_step(flow, t, x, 0.125, dw)
        torch.testing.assert_close(fused, generic, rtol=1e-6, atol=1e-6)


def test_hutchinson_probes_and_estimate():
    g = torch.Generator().manual_seed(0)
    v = hutchinson.sample_v(g, (400, 5), "rademacher", device="cpu")
    assert set(v.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(v.mean())) < 0.05
    u = hutchinson.sample_v(g, (3, 5), "uniform", device="cpu")
    torch.testing.assert_close(u.norm(dim=1), torch.ones(3))
    assert hutchinson.sample_v(g, (3, 5), "gaussian", device="cpu").shape == (3, 5)
    with pytest.raises(ValueError):
        hutchinson.sample_v(g, (3, 5), "cauchy", device="cpu")
    a = torch.randn(5, 5, generator=g, dtype=torch.float64)
    y = torch.randn(3, 5, generator=g, dtype=torch.float64)
    est, primal = hutchinson.hutchinson_div(lambda yy: yy @ a.T, y, u.double())
    torch.testing.assert_close(est, torch.einsum("bi,ij,bj->b", u.double(), a,
                                                 u.double()))
    torch.testing.assert_close(primal, y @ a.T)


def test_kde_and_msgm_constants_match_jax(sdes):
    jsde, tsde = sdes
    np.testing.assert_allclose(float(tsde.kde_bandwidth),
                               float(jsde.kde_bandwidth), rtol=1e-5)
    np.testing.assert_allclose(float(tsde.cst_log_dens),
                               float(jsde.cst_log_dens), rtol=1e-5, atol=1e-6)
    r = np.linspace(1.5, 3.5, 50).astype(np.float32)
    ref = np.asarray(jax_kde_logpdf(jnp.asarray(r), jsde.r_T,
                                    jsde.kde_bandwidth))
    out = gaussian_kde_logpdf(torch.from_numpy(r), tsde.r_T,
                              tsde.kde_bandwidth).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(kde_normalization_log_constant(tsde.r_T, 0.05, 200)),
        float(jax_kde_const(jsde.r_T, 0.05, 200)), rtol=1e-5, atol=1e-6)
