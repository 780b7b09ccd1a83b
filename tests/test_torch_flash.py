"""The reverse-mode flash-attention pair K7a/K7b and the tiled attention
math: the port's plain versions and its Function ``FlashAttention`` on the
CPU against the JAX package (its Pallas kernels run in interpret mode;
the CUDA kernels against the plain versions on a card are in
test_torch_kernels_cuda.py), and the dispatch of ``attention_core``.

Inputs come from numpy under a seed. Tolerances (float32): the outputs
atol 1e-5 and lse 1e-4, as tests/test_pallas_kernels.py:215-235 holds the
JAX kernel; dqkv atol 1e-5·max |dqkv| (the same sums in another order);
the gradient of ``flash_attention_vjp`` atol 2e-4, as
tests/test_pallas_kernels.py:238-256; the jvp and the gradient of the jvp
atol 1e-5·max |ref| (tiles of 16 keys summed in another order than XLA's).
The thresholds (T > 1024, key tiles of 512) are patched small on both
sides where a test needs the tiled math at a small T."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.ops.pallas import attention as jax_attn
from sdeflow_tpu.ops.pallas.common import force_interpret
from sdeflow_tpu_torch.ops.kernels import attention as A

torch.set_num_threads(1)


def _np(shape, seed, scale=1.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(out, ref, atol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0,
                               atol=atol)


@pytest.fixture
def small_tiles(monkeypatch):
    """Threshold 32 and key tiles of 16 on both sides."""
    for mod in (A, jax_attn):
        monkeypatch.setattr(mod, "_FLASH_SEQ_THRESHOLD", 32)
        monkeypatch.setattr(mod, "_FLASH_KV_BLOCK", 16)


@pytest.mark.parametrize("t,heads", [(64, 1), (64, 2), (60, 2)],
                         ids=["1head", "2heads", "ragged-fallback"])
def test_flash_math_matches_jax(t, heads):
    qkv = _np((2, t, 3 * 16), 0)
    ref = jax_attn._attention_flash_math(jnp.asarray(qkv), heads, kv_block=16)
    out = A.attention_flash_math(torch.from_numpy(qkv), heads, kv_block=16)
    _close(out.numpy(), ref, 1e-5)
    _close(out.numpy(), A.attention_math(torch.from_numpy(qkv), heads), 1e-5)


@pytest.mark.parametrize("t", [64, 256])
def test_flash_stats_math_matches_jax_kernel(t):
    qkv = _np((2, t, 3 * 32), 1)
    with force_interpret():
        ref_out, ref_lse = jax_attn._attention_flash_stats(jnp.asarray(qkv), 2)
    out, lse = A.attention_flash_stats_math(torch.from_numpy(qkv), 2)
    _close(out.numpy(), ref_out, 1e-5)
    assert lse.shape == (2, 2, t) and lse.dtype == torch.float32
    _close(lse.numpy(), ref_lse, 1e-4)


def test_flash_bwd_math_matches_jax_kernel():
    b, t, c, h = 2, 256, 32, 2
    qkv, dout = _np((b, t, 3 * c), 2), _np((b, t, c), 3, 1.0)
    out, lse = A.attention_flash_stats_math(torch.from_numpy(qkv), h)
    delta = (A._heads(torch.from_numpy(dout), h) * A._heads(out, h)).sum(-1)
    with force_interpret():
        ref = np.asarray(jax_attn._attention_flash_bwd(
            jnp.asarray(qkv), jnp.asarray(dout), jnp.asarray(lse.numpy()),
            jnp.asarray(delta.numpy()), h))
    dqkv = A.attention_flash_bwd_math(torch.from_numpy(qkv),
                                      torch.from_numpy(dout), lse, delta, h)
    _close(dqkv.numpy(), ref, 1e-5 * np.abs(ref).max())


def test_flash_vjp_gradient_matches_jax():
    b, t, c, h = 2, 256, 32, 4
    qkv, g = _np((b, t, 3 * c), 4), _np((b, t, c), 5, 1.0)
    with force_interpret():
        ref = jax.grad(lambda q: jnp.vdot(
            jax_attn.flash_attention_vjp(q, h), jnp.asarray(g)))(
                jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    out = A.flash_attention_vjp(x, h)
    grad = torch.autograd.grad((out * torch.from_numpy(g)).sum(), x)[0]
    _close(out.detach().numpy(), jax_attn._attention_math(jnp.asarray(qkv), h),
           1e-5)
    _close(grad.numpy(), ref, 2e-4)


@pytest.mark.parametrize("fn", ["flash_attention_vjp", "qkv_attention"])
def test_jvp_and_gradient_of_jvp_match_jax(small_tiles, fn):
    """The tiled closed-form tangent (FlashAttention's jvp, and
    QKVAttention's above the threshold) and the gradient of a loss on it
    against jax.jvp / jax.grad of the JAX qkv_attention, whose rule
    differentiates the tiled _attention_flash_math there."""
    b, t, c, h = 2, 64, 16, 2
    qkv, v, w = _np((b, t, 3 * c), 6), _np((b, t, 3 * c), 7), _np((b, t, c), 8)
    theta0 = 1.0 + 0.1 * np.random.default_rng(9).standard_normal(3 * c)

    def jax_loss(theta):
        out, tan = jax.jvp(lambda q: jax_attn.qkv_attention(theta * q, h),
                           (jnp.asarray(qkv),), (jnp.asarray(v),))
        return (tan * w).sum(), (out, tan)

    (_, (ref_out, ref_tan)), ref_g = jax.value_and_grad(
        jax_loss, has_aux=True)(jnp.asarray(theta0, jnp.float32))
    attn = getattr(A, fn)
    theta = torch.tensor(theta0, dtype=torch.float32, requires_grad=True)
    out, tan = torch.func.jvp(lambda q: attn(theta * q, h),
                              (torch.from_numpy(qkv),), (torch.from_numpy(v),))
    grad = torch.autograd.grad((tan * torch.from_numpy(w)).sum(), theta)[0]
    for got, ref in [(out, ref_out), (tan, ref_tan), (grad, ref_g)]:
        ref = np.asarray(ref)
        _close(got.detach().numpy(), ref, 1e-5 * np.abs(ref).max())


def test_qkv_attention_backward_above_threshold(small_tiles):
    # the tiled math's checkpoints: the backward rule takes them by autograd
    qkv, g = _np((2, 64, 48), 10), _np((2, 64, 16), 11, 1.0)
    got, want = [], []
    for attn, out in [(A.qkv_attention, got), (A.attention_math, want)]:
        x = torch.from_numpy(qkv).requires_grad_()
        out.append(torch.autograd.grad(
            (attn(x, 2) * torch.from_numpy(g)).sum(), x)[0])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)


def test_attention_core_dispatch(small_tiles, monkeypatch):
    """The pair when autograd records a call at T > threshold with
    T % tile == 0, including inside torch.func.jvp; qkv_attention under
    no_grad and for other T."""
    calls = []
    stats = A.attention_flash_stats_math
    monkeypatch.setattr(A, "attention_flash_stats_math",
                        lambda *a: (calls.append(a[0].shape[1]), stats(*a))[1])
    w = torch.ones(48, requires_grad=True)
    v = torch.from_numpy(_np((1, 64, 48), 13))

    def run(t, grad, jvp):
        qkv = torch.from_numpy(_np((1, t, 48), 12))
        calls.clear()
        with torch.set_grad_enabled(grad):
            if jvp:
                torch.func.jvp(lambda q: A.attention_core(w * q, 2), (qkv,),
                               (v[:, :t],))
            else:
                A.attention_core(w * qkv, 2)
        return bool(calls)

    assert run(64, grad=True, jvp=False)
    assert run(64, grad=True, jvp=True)   # the SSM loss's JVP under autograd
    assert not run(64, grad=False, jvp=False)
    assert not run(64, grad=False, jvp=True)  # the ELBO print
    assert not run(32, grad=True, jvp=False)  # not above the threshold
    assert not run(40, grad=True, jvp=False)  # T % 16 != 0
    calls.clear()
    A.attention_core(torch.from_numpy(_np((1, 64, 48), 12)), 2)
    assert not calls  # autograd records no tensor without history
