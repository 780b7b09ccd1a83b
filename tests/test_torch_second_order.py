"""Second-order differentiation through the kernel Functions, on the CPU.

Each kernel's ``torch.autograd.Function`` (ops/kernels/common.py) runs its
plain version forward on CPU tensors and differentiates it in its rules, so
a second reverse pass checks the rules themselves: a double backward
(``torch.autograd.grad`` with ``create_graph=True``, then a gradient of
that gradient) and ``torch.func.grad`` of ``torch.func.grad`` through the
Function against the same taken through the plain version, in float64
(rtol/atol 1e-9: the same algebra, rounded differently). For K5 and K3 the
second derivative also matches the JAX package's, ``jax.grad`` of ``jax.grad``
on the CPU with 64-bit types on (atol 1e-6 of the largest entry: the JAX
package takes the GroupNorm statistics in float32 at any input type,
sdeflow_tpu/ops/pallas/groupnorm.py:56-60, which puts its second derivatives
0.4e-7 to 3.5e-7 of their largest entry from the float64 ones). The attention
core above T = 1024 checkpoints its tiled plain version, which ``torch.func``
refuses: there a reverse pass inside ``torch.func`` raises, and a double
backward matches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdeflow_tpu.ops.pallas.attnblock import (
    fused_attention_block as jax_block)
from sdeflow_tpu.ops.pallas.groupnorm import group_norm_silu as jax_gn
from sdeflow_tpu_torch.ops.kernels.attention import (
    attention_reference, qkv_attention)
from sdeflow_tpu_torch.ops.kernels.attnblock import (
    attn_block_math, fused_attention_block)
from sdeflow_tpu_torch.ops.kernels.circulant import (
    circ_math, circulant_apply, circulant_rk4_step, rk4_math_fwd)
from sdeflow_tpu_torch.ops.kernels.groupnorm import gn_math, group_norm_silu

torch.set_num_threads(1)
TOL = 1e-9


def _f64(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape))


def _block_args(rng, b, t, c):
    return [2.0 * _f64(rng, b, t, c) + 0.5, 1.0 + 0.1 * _f64(rng, c),
            0.1 * _f64(rng, c), _f64(rng, c, 3 * c) / c**0.5,
            0.1 * _f64(rng, 3 * c), _f64(rng, c, c) / c**0.5,
            0.1 * _f64(rng, c)]


def _case(name, rng):
    """(Function entry, plain version, float64 inputs) at debug size."""
    if name == "K1":
        args = [1.0 + _f64(rng, 3, 1).abs(), _f64(rng, 3, 8), _f64(rng, 3, 8)]
        return circulant_apply, circ_math, args
    if name == "K2":
        args = [1.0 + _f64(rng, 3, 3).abs(), _f64(rng, 3, 8),
                0.3 * _f64(rng, 3, 8)]
        return circulant_rk4_step, rk4_math_fwd, args
    if name == "K3":
        return (lambda *a: fused_attention_block(*a, 4, 2),
                lambda *a: attn_block_math(*a, 4, 2),
                _block_args(rng, 2, 5, 8))
    if name == "K5":
        args = [2.0 * _f64(rng, 2, 8, 5) + 0.5, 1.0 + 0.1 * _f64(rng, 8),
                0.1 * _f64(rng, 8)]
        return (lambda *a: group_norm_silu(*a, 4, True),
                lambda *a: gn_math(*a, 4, True), args)
    # K6 (K4 above T = 1024): the attention core at T <= 1024
    return (lambda q: qkv_attention(q, 2),
            lambda q: attention_reference(q, 2), [_f64(rng, 2, 9, 12)])


def _loss(fn, cot):
    """A scalar with a non-trivial second derivative: Σ c·fn(args)²."""
    return lambda *a: (cot * fn(*a) ** 2).sum()


def _double_backward(fn, args, cot, v):
    """∂/∂args of <∂L/∂args[0], v>, with L = Σ c·fn(args)², by autograd."""
    xs = [a.clone().requires_grad_() for a in args]
    (g0,) = torch.autograd.grad(_loss(fn, cot)(*xs), xs[0],
                                create_graph=True)
    return torch.autograd.grad((g0 * v).sum(), xs, allow_unused=True,
                               materialize_grads=True)


def _func_grad(fn, args, cot, v):
    """The same by torch.func.grad of torch.func.grad."""
    inner = torch.func.grad(_loss(fn, cot))
    return torch.func.grad(lambda *a: (inner(*a) * v).sum(),
                           argnums=tuple(range(len(args))))(*args)


@pytest.mark.parametrize("mode", ["double_backward", "func_grad"])
@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K5", "K6"])
def test_second_order_through_function_matches_plain(name, mode):
    rng = np.random.default_rng(11)
    kern, plain, args = _case(name, rng)
    with torch.no_grad():
        out = plain(*args)
    cot, v = _f64(rng, *out.shape), _f64(rng, *args[0].shape)
    second = _double_backward if mode == "double_backward" else _func_grad
    got = second(kern, args, cot, v)
    want = second(plain, args, cot, v)
    assert max(w.abs().max().item() for w in want) > 1e-3  # not trivially 0
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=TOL, atol=TOL)


def _jax_second(fn, args, cot, v):
    """jax.grad of <jax.grad of Σ c·fn(args)² in args[0], v>, in every
    argument."""
    def loss(*a):
        return jnp.sum(cot * fn(*a) ** 2)

    def inner(*a):
        return jnp.sum(jax.grad(loss)(*a) * v)

    return jax.grad(inner, argnums=tuple(range(len(args))))(*args)


def _assert_matches_jax(got, want):
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


def test_groupnorm_second_derivative_matches_jax():
    rng = np.random.default_rng(12)
    _, _, args = _case("K5", rng)
    cot, v = _f64(rng, 2, 8, 5), _f64(rng, 2, 8, 5)
    got = _double_backward(lambda *a: group_norm_silu(*a, 4, True), args,
                           cot, v)
    # JAX is channels-last: x, its cotangent and v transposed to (B, S, C)
    tr = lambda a: jnp.asarray(a.numpy().transpose(0, 2, 1))  # noqa: E731
    with jax.enable_x64(True):
        want = _jax_second(lambda *a: jax_gn(*a, 4, True),
                           [tr(args[0]), *(jnp.asarray(a.numpy())
                                           for a in args[1:])],
                           tr(cot), tr(v))
        want = [np.asarray(want[0]).transpose(0, 2, 1), *want[1:]]
    _assert_matches_jax(got, want)


def test_attention_block_second_derivative_matches_jax():
    rng = np.random.default_rng(13)
    _, _, args = _case("K3", rng)
    cot, v = _f64(rng, *args[0].shape), _f64(rng, *args[0].shape)
    got = _double_backward(lambda *a: fused_attention_block(*a, 4, 2), args,
                           cot, v)
    with jax.enable_x64(True):
        want = _jax_second(lambda *a: jax_block(*a, 4, 2),
                           [jnp.asarray(a.numpy()) for a in args],
                           jnp.asarray(cot.numpy()), jnp.asarray(v.numpy()))
    _assert_matches_jax(got, want)


@pytest.mark.parametrize("t", [1100, 2048])
def test_attention_above_1024_matches_or_raises(t):
    # T = 1100 runs the (T, T) plain math (T % 512 != 0); T = 2048 the
    # checkpointed tiled math, which torch.func refuses
    rng = np.random.default_rng(14)
    qkv = _f64(rng, 1, t, 6)
    cot, v = _f64(rng, 1, t, 2), _f64(rng, 1, t, 6)
    kern = lambda q: qkv_attention(q, 1)  # noqa: E731
    plain = lambda q: attention_reference(q, 1)  # noqa: E731
    want = _double_backward(plain, [qkv], cot, v)
    got = _double_backward(kern, [qkv], cot, v)
    torch.testing.assert_close(got[0], want[0], rtol=TOL, atol=TOL)
    if t % 512:
        got = _func_grad(kern, [qkv], cot, v)
        torch.testing.assert_close(got[0], want[0], rtol=TOL, atol=TOL)
    else:
        with pytest.raises(NotImplementedError, match="checkpoint"):
            _func_grad(kern, [qkv], cot, v)
