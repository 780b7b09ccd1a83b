"""K2's forward solve (``circulant_rk4_solve_select``) and the launch plans
of K1 and K2: the plain version against the JAX package's integrate_select,
the port's whole-solve override against its per-step loop, when the
override is taken, the solve's autograd rules, and the Python plan mirrors
(their edges in test_torch_circulant_plans.py; the kernels themselves
against the plain versions on a card are in test_torch_kernels_cuda*.py).

Tolerances: against JAX rtol/atol 1e-5 in float32, as
test_torch_forward.py's integrate_select check (the same products in the
same order; only the last bits of β and √δ may differ); the override
against the per-step loop exactly (both run the plain version on the CPU);
the tangent and the gradient against torch.func of the plain loop in
float64, rtol/atol 1e-10."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.ops.integrators import integrate_select as jax_select
from sdeflow_tpu.sde.forward import ForwardFlow as JaxFlow
from sdeflow_tpu.sde.msgm import MSGMSde as JaxMSGM
from sdeflow_tpu_torch.ops.integrators import integrate_select
from sdeflow_tpu_torch.ops.kernels.circulant import (
    K2, K2_SOLVE, RK4SolveSelect, circulant_rk4_solve_select,
    rk4_solve_select_math)
from sdeflow_tpu_torch.sde import msgm
from sdeflow_tpu_torch.sde.forward import ForwardFlow
from sdeflow_tpu_torch.sde.msgm import MSGMSde, sqrt_beta_table
from sdeflow_tpu_torch.sde.sgm import SGMSde

torch.set_num_threads(1)
KW = dict(beta_min=0.1, beta_max=20.0, T=1.0, t_epsilon=4e-3,
          num_steps_forward=8, dense_tensor=False, norm_sampler="ecdf",
          norm_map="log")
B, N = 6, 8
SEL = [0, 1, 3, 8, 5, 0]  # includes 0 (x0 kept) and N (every step)


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    scale = np.exp(0.3 * rng.standard_normal((n, 1)))
    return (scale * rng.standard_normal((n, d))).astype(np.float32)


def _jax_noise(key, steps, shape):
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), shape)) for i in range(steps)])


def _sde(d):
    return MSGMSde.create(torch.from_numpy(_data(256, d, 0)), **KW)


def _step_loop(flow, x0, z, sel):
    """integrate_select's generic loop: ForwardFlow.rk4_step per step (K2's
    plain version on the CPU), then the masked select."""
    n = z.shape[0]
    delta = float(flow.T) / n
    x = kept = x0
    for i in range(n):
        x = flow.rk4_step(i * delta, x, delta, delta ** 0.5 * z[i])
        kept = torch.where(sel.reshape(-1, 1) == i + 1, x, kept)
    return kept


@pytest.mark.parametrize("d", [32, 256])
def test_plain_solve_matches_jax_integrate_select(d):
    y0 = _data(256, d, 0)
    jsde = JaxMSGM.create(jax.random.PRNGKey(0), jnp.asarray(y0), **KW)
    x0 = _data(B, d, 1)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jax.jit(lambda x, s: jax_select(
        JaxFlow(base_sde=jsde, T=jsde.T), x, key, N, s))(
            jnp.asarray(x0), jnp.asarray(SEL, jnp.int32)))
    z = torch.from_numpy(_jax_noise(key, N, (B, d)))
    delta = 1.0 / N
    sb = sqrt_beta_table(KW["beta_min"], KW["beta_max"], delta, N,
                         torch.device("cpu"), torch.float32)
    out = rk4_solve_select_math(torch.from_numpy(x0), z, sb,
                                torch.tensor(SEL), math.sqrt(delta)).numpy()
    assert np.abs(out - x0).max(axis=1)[np.array(SEL) > 0].min() > 1e-3
    np.testing.assert_array_equal(out[np.array(SEL) == 0],
                                  x0[np.array(SEL) == 0])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [32, 256])
def test_override_equals_the_per_step_loop(d):
    sde = _sde(d)
    flow = ForwardFlow(base_sde=sde, T=sde.T)
    x0 = torch.from_numpy(_data(B, d, 2))
    z = torch.from_numpy(_data(N, B * d, 3).reshape(N, B, d))
    sel = torch.tensor(SEL)
    want = _step_loop(flow, x0, z, sel)
    before = (K2.launches, K2_SOLVE.launches)
    got = integrate_select(flow, x0, None, N, sel, noise=z)
    assert (K2.launches, K2_SOLVE.launches) == before  # the CPU: no launch
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # without injected noise: all steps' normals in one draw, on the CPU the
    # numbers of one draw per step
    g = torch.Generator().manual_seed(4)
    drawn = integrate_select(flow, x0, g, N, sel)
    g = torch.Generator().manual_seed(4)
    per_step = torch.stack([torch.randn((B, d), generator=g)
                            for _ in range(N)])
    torch.testing.assert_close(drawn, _step_loop(flow, x0, per_step, sel),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["taken", "norm_correction", "lmbd", "sgm"])
def test_override_is_taken_only_where_it_applies(case, monkeypatch):
    calls = []
    plain = msgm.circulant_rk4_solve_select

    def spy(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(msgm, "circulant_rk4_solve_select", spy)
    sde = (SGMSde.create(num_steps_forward=N, device="cpu") if case == "sgm"
           else _sde(32))
    flow = ForwardFlow(base_sde=sde, T=sde.T)
    assert (flow.rk4_solve_select is None) == (case == "sgm")
    x0 = torch.from_numpy(_data(B, 32, 5))
    z = torch.from_numpy(_data(N, B * 32, 6).reshape(N, B, 32))
    kw = {"norm_correction": {"norm_correction": True},
          "lmbd": {"lmbd": 0.5}}.get(case, {})
    out = integrate_select(flow, x0, None, N, torch.tensor(SEL), noise=z,
                           **kw)
    assert len(calls) == (case == "taken")
    assert out.shape == (B, 32) and torch.isfinite(out).all()


def _solve_args(d=32, seed=7):
    rng = np.random.default_rng(seed)
    x0 = torch.tensor(rng.standard_normal((B, d)))
    z = torch.tensor(rng.standard_normal((N, B, d)))
    sb = torch.tensor(1.0 + rng.random((N, 3)))
    return (x0, z, sb), [torch.tensor(rng.standard_normal((B, d))),
                         torch.tensor(rng.standard_normal((N, B, d))),
                         torch.tensor(rng.standard_normal((N, 3)))]


@pytest.mark.parametrize("mode", ["jvp", "grad"])
def test_solve_rules_match_torch_func_of_the_plain_loop(mode):
    primals, tangents = _solve_args()
    sel, sd = torch.tensor(SEL), math.sqrt(1.0 / N)

    def rule(*a):
        return RK4SolveSelect.apply(*a, sel, sd)

    def plain(*a):
        return rk4_solve_select_math(*a, sel, sd)

    if mode == "jvp":
        got = torch.func.jvp(rule, primals, tuple(tangents))
        want = torch.func.jvp(plain, primals, tuple(tangents))
    else:
        cot = tangents[0]
        got = torch.func.vjp(rule, *primals)[1](cot)
        want = torch.func.vjp(plain, *primals)[1](cot)
    for a, b in zip(got, want):
        assert b.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    # the public wrapper goes through the same Function
    torch.testing.assert_close(circulant_rk4_solve_select(*primals, sel, sd),
                               plain(*primals), rtol=0, atol=0)
