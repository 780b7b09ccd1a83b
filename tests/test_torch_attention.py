"""Kernels K6 and K4 (the attention core): the port's Function on the CPU
(its plain version) against the JAX package's Pallas kernels run in
interpret mode, and the closed-form tangent and the autograd rules (the
CUDA kernel against the plain version on a card is in
test_torch_kernels_cuda.py).

qkv is (B, T, 3C) with heads in interleaved [q_h k_h v_h] slices; the
cases with 2 and 4 heads hold the port to that layout. Tolerances: atol
1e-5 in float32 against JAX (sums in another order; at T = 2048 the flash
kernel's online softmax over four KV tiles rounds differently again, held
to the same atol); the tangent and the gradient of a JVP rtol/atol 1e-12 in
float64 against ``torch.func`` through the plain version; ``gradcheck`` in
float64 with forward mode on."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdeflow_tpu.ops.pallas.attention import (
    _attention_flash, qkv_attention as jax_attention)
from sdeflow_tpu.ops.pallas.common import force_interpret
from sdeflow_tpu_torch.ops.kernels.attention import (
    K6, QKVAttention, attention_core, attention_jvp, attention_math,
    qkv_attention)

torch.set_num_threads(1)
ATOL = 1e-5


def _qkv(b, t, c3, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((2.0 * rng.standard_normal((b, t, c3)))
                            .astype(dtype))


@pytest.mark.parametrize("b,t,c3,heads", [(3, 64, 96, 4), (2, 16, 384, 1)])
def test_matches_jax_kernel(b, t, c3, heads):
    qkv = _qkv(b, t, c3)
    with force_interpret():  # T <= 1024: the single-block kernel
        ref = np.asarray(jax_attention(jnp.asarray(qkv.numpy()), heads))
    before = K6.launches
    out = qkv_attention(qkv, heads)
    assert K6.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    # T <= 1024: the AttentionBlock's entry point is qkv_attention
    qkv.requires_grad_()
    torch.testing.assert_close(attention_core(qkv, heads),
                               qkv_attention(qkv, heads), rtol=0, atol=0)


def test_matches_jax_flash_kernel():
    qkv = _qkv(2, 2048, 48, seed=1)
    with force_interpret():
        ref = np.asarray(_attention_flash(jnp.asarray(qkv.numpy()), 2))
    out = qkv_attention(qkv, 2).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_heads_are_interleaved_slices():
    # head h reads channels [3·ch·h, 3·ch·(h+1)) of each row as [q k v]
    qkv = _qkv(2, 8, 24, seed=2, dtype=np.float64)
    out = attention_math(qkv, 2)
    for h in range(2):
        torch.testing.assert_close(out[..., 4 * h:4 * (h + 1)],
                                   attention_math(qkv[..., 12 * h:12 * (h + 1)],
                                                  1), rtol=0, atol=0)


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_closed_form_tangent_matches_func_jvp(heads):
    qkv = _qkv(2, 6, 24, seed=3, dtype=np.float64)
    dqkv = _qkv(2, 6, 24, seed=4, dtype=np.float64)
    _, want = torch.func.jvp(lambda q: attention_math(q, heads), (qkv,),
                             (dqkv,))
    torch.testing.assert_close(attention_jvp(qkv, heads, dqkv), want,
                               rtol=1e-12, atol=1e-12)


def test_autograd_rules_gradcheck():
    qkv = _qkv(2, 5, 12, seed=5, dtype=np.float64).requires_grad_()
    assert torch.autograd.gradcheck(lambda q: QKVAttention.apply(q, 2),
                                    (qkv,), check_forward_ad=True)


def test_grad_of_jvp_through_the_rules():
    qkv = _qkv(2, 7, 24, seed=6, dtype=np.float64)
    v = _qkv(2, 7, 24, seed=7, dtype=np.float64)
    theta = torch.ones(24, dtype=torch.float64, requires_grad=True)

    def loss(attn):
        _, tan = torch.func.jvp(lambda q: attn(theta * q, 2), (qkv,), (v,))
        return (tan * v[..., :8]).sum()

    g_rule = torch.autograd.grad(loss(qkv_attention), theta)[0]
    g_plain = torch.autograd.grad(loss(attention_math), theta)[0]
    torch.testing.assert_close(g_rule, g_plain, rtol=1e-12, atol=1e-12)


def test_plain_version_refuses_bf16():
    # the tiled plain version above T = 1024 takes bf16 too now
    # (tests/test_torch_attention_bf16.py holds it to JAX); what it refuses
    # is float16, naming the gap
    out = qkv_attention(_qkv(1, 2048, 6).to(torch.bfloat16), 1)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="float16"):
        qkv_attention(_qkv(1, 2048, 6).to(torch.float16), 1)
