"""Kernel K5 (GroupNorm + SiLU): the port's Function on the CPU (its plain
version) against the JAX package's Pallas kernel run in interpret mode, and
the closed-form tangent and the autograd rules (the CUDA kernel against the
plain version on a card is in test_torch_kernels_cuda.py).

The port is channels-first (B, C, S), the JAX package channels-last
(B, S, C): the JAX inputs are the port's transposed. Tolerances: atol 1e-5
in float32 against JAX (statistics summed in another order); the tangent
and the gradient of a JVP rtol/atol 1e-12 in float64 against
``torch.func`` through the plain version (the same algebra, rounded
differently); ``gradcheck`` in float64 with forward mode on."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdeflow_tpu.ops.pallas.common import force_interpret
from sdeflow_tpu.ops.pallas.groupnorm import group_norm_silu as jax_gn
from sdeflow_tpu_torch.ops.kernels.groupnorm import (
    K5, GroupNormSiLU, gn_math, gn_math_jvp, group_norm_silu)

torch.set_num_threads(1)
ATOL = 1e-5


def _inputs(b, c, s, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = 3.0 * rng.standard_normal((b, c, s)) + 1.0
    gamma = 1.0 + 0.5 * rng.standard_normal(c)
    beta = 0.5 * rng.standard_normal(c)
    return tuple(torch.from_numpy(a.astype(dtype)) for a in (x, gamma, beta))


@pytest.mark.parametrize("b,s,c,groups", [(4, 49, 32, 8), (2, 256, 96, 32)])
@pytest.mark.parametrize("silu", [False, True])
def test_matches_jax_kernel(b, s, c, groups, silu):
    x, gamma, beta = _inputs(b, c, s)
    with force_interpret():
        ref = np.asarray(jax_gn(jnp.asarray(x.transpose(1, 2).numpy()),
                                jnp.asarray(gamma.numpy()),
                                jnp.asarray(beta.numpy()), groups, silu))
    before = K5.launches
    out = group_norm_silu(x, gamma, beta, groups, silu)
    assert K5.launches == before  # the CPU path launches nothing
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("tangents", ["all", "x", "weights"])
@pytest.mark.parametrize("silu", [False, True])
def test_closed_form_tangent_matches_func_jvp(tangents, silu):
    x, gamma, beta = _inputs(3, 12, 10, seed=1, dtype=np.float64)
    dx, dgamma, dbeta = _inputs(3, 12, 10, seed=2, dtype=np.float64)
    if tangents == "x":
        dgamma = dbeta = None
    elif tangents == "weights":
        dx = None
    got = gn_math_jvp(x, gamma, beta, 4, silu, dx, dgamma, dbeta)
    zero = torch.zeros_like
    _, want = torch.func.jvp(
        lambda *a: gn_math(*a, 4, silu), (x, gamma, beta),
        (zero(x) if dx is None else dx, zero(gamma) if dgamma is None
         else dgamma, zero(beta) if dbeta is None else dbeta))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_autograd_rules_gradcheck():
    args = tuple(a.requires_grad_() for a in
                 _inputs(2, 6, 5, seed=3, dtype=np.float64))
    for silu in (False, True):
        assert torch.autograd.gradcheck(
            lambda *a: GroupNormSiLU.apply(*a, 3, silu), args,
            check_forward_ad=True)


def test_grad_of_jvp_through_the_rules():
    # the SSM loss's pattern: .backward() through a torch.func.jvp tangent
    # that passes the Function equals the same through the plain version
    x, gamma, beta = _inputs(2, 8, 9, seed=4, dtype=np.float64)
    v = _inputs(2, 8, 9, seed=5, dtype=np.float64)[0]
    theta = torch.ones(8, dtype=torch.float64, requires_grad=True)

    def loss(gn):
        _, tan = torch.func.jvp(
            lambda y: gn(y, theta * gamma, beta, 4, True), (x,), (v,))
        return (tan * v).sum()

    g_rule = torch.autograd.grad(loss(group_norm_silu), theta)[0]
    g_plain = torch.autograd.grad(loss(gn_math), theta)[0]
    torch.testing.assert_close(g_rule, g_plain, rtol=1e-12, atol=1e-12)


def test_plain_version_refuses_bf16():
    x, gamma, beta = (a.to(torch.bfloat16) for a in _inputs(1, 4, 3))
    with pytest.raises(NotImplementedError, match="item 8"):
        group_norm_silu(x, gamma, beta, 2, True)
