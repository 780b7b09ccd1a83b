"""The attention core's plain versions in bf16 (the unfused route under the
score net's bf16 compute) against the JAX package, on the CPU; the bf16
kernels themselves against these on a card are in
test_torch_kernels_cuda_attention_bf16.py.

Inputs come from numpy under a seed, rounded to bf16 once, so that both
sides see the same bf16 values. Each bf16 result is held to two things,
the rule of tests/test_torch_bf16.py: within 3e-2·max |JAX bf16| of JAX
bf16, and no farther from JAX's fp32 result on the same (widened) inputs
than 1.5× JAX bf16's own distance from it plus 1e-3·max |JAX fp32|.
``attention_flash_math``, its tangent and ``attention_math`` keep the JAX
math versions' rounding points (the scale rounded to bf16, q·s and k·s
bf16) and are held to ``_attention_flash_math`` and its ``jax.jvp``;
``attention_flash_stats_math`` and ``attention_flash_bwd_math`` keep the
kernel bodies' (q·s and k·s fp32) and are held to ``_attention_flash_stats``
and ``_attention_flash_bwd`` in interpret mode, lse to 1e-4 as in
tests/test_torch_flash.py (the same fp32 scores); ``attention_math`` is
also held to ``_attention_pallas`` (K6) in interpret mode, whose body takes
q·s in fp32. The head widths make the scale inexact in bf16 (ch = 32, 64,
128), where the two sets of rounding points differ. The thresholds
(T > 1024, key tiles of 512) are patched small on both sides where a test
needs the tiled math at a small T."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.ops.pallas import attention as jax_attn
from sdeflow_tpu.ops.pallas.common import force_interpret
from sdeflow_tpu_torch.ops.kernels import attention as A
from test_torch_flash_tc import _constants

torch.set_num_threads(1)
BF = torch.bfloat16


def _inputs(shape, seed, scale=1.5):
    """bf16 values as float32 numpy (exact in bf16)."""
    a = scale * np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(a.astype(np.float32)).to(BF).float().numpy()


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _jax(a, dt):
    return jnp.asarray(a, dt)


def assert_bf16_close(ours, jax16, jax32, what, tol=3e-2):
    """Within tol·max |JAX bf16| of JAX bf16, and no farther from JAX
    fp32 than 1.5× JAX bf16's distance plus 1e-3·max |JAX fp32|."""
    ours, jax16, jax32 = _np(ours), _np(jax16), _np(jax32)
    assert ours.shape == jax16.shape == jax32.shape, what
    assert np.isfinite(ours).all(), what
    err = np.abs(ours - jax16).max()
    assert err <= tol * np.abs(jax16).max(), (what, err)
    mine = np.abs(ours - jax32).max()
    theirs = np.abs(jax16 - jax32).max()
    assert mine <= 1.5 * theirs + 1e-3 * np.abs(jax32).max(), (
        what, mine, theirs)


@pytest.fixture
def small_tiles(monkeypatch):
    """Threshold 32 and key tiles of 16 on both sides."""
    for mod in (A, jax_attn):
        monkeypatch.setattr(mod, "_FLASH_SEQ_THRESHOLD", 32)
        monkeypatch.setattr(mod, "_FLASH_KV_BLOCK", 16)


@pytest.mark.parametrize("t,heads", [(64, 1), (64, 2), (60, 2)],
                         ids=["1head", "2heads", "ragged-fallback"])
def test_flash_math_bf16_matches_jax(t, heads):
    qkv = _inputs((2, t, 3 * 64), 0)
    ref = {dt: jax_attn._attention_flash_math(_jax(qkv, dt), heads,
                                              kv_block=16)
           for dt in (jnp.bfloat16, jnp.float32)}
    out = A.attention_flash_math(torch.from_numpy(qkv).to(BF), heads,
                                 kv_block=16)
    assert out.dtype == BF
    assert_bf16_close(out, ref[jnp.bfloat16], ref[jnp.float32], "out")


def test_flash_stats_math_bf16_matches_jax_kernel():
    b, t, c, h = 2, 64, 64, 2
    qkv = _inputs((b, t, 3 * c), 1)
    with force_interpret():
        ref = {dt: jax_attn._attention_flash_stats(_jax(qkv, dt), h)
               for dt in (jnp.bfloat16, jnp.float32)}
    out, lse = A.attention_flash_stats_math(torch.from_numpy(qkv).to(BF), h)
    assert out.dtype == BF and lse.dtype == torch.float32
    assert_bf16_close(out, ref[jnp.bfloat16][0], ref[jnp.float32][0], "out")
    np.testing.assert_allclose(lse.numpy(), _np(ref[jnp.bfloat16][1]),
                               rtol=0, atol=1e-4)


def test_flash_bwd_math_bf16_matches_jax_kernel():
    b, t, c, h = 2, 128, 64, 2
    qkv, dout = _inputs((b, t, 3 * c), 2), _inputs((b, t, c), 3, 1.0)
    out, lse = A.attention_flash_stats_math(torch.from_numpy(qkv).to(BF), h)
    delta = (A._heads(torch.from_numpy(dout), h)
             * A._heads(out.float(), h)).sum(-1)
    args = (jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()), h)
    with force_interpret():
        ref = {dt: jax_attn._attention_flash_bwd(
            _jax(qkv, dt), _jax(dout, dt), *args)
            for dt in (jnp.bfloat16, jnp.float32)}
    dqkv = A.attention_flash_bwd_math(torch.from_numpy(qkv).to(BF),
                                      torch.from_numpy(dout).to(BF), lse,
                                      delta, h)
    assert dqkv.dtype == BF
    assert_bf16_close(dqkv, ref[jnp.bfloat16], ref[jnp.float32], "dqkv")


def test_flash_vjp_gradient_bf16_matches_jax():
    """The pair's forward and gradient on the CPU (the plain versions of
    K7a and K7b, Δ in fp32) against jax.grad of JAX's
    flash_attention_vjp with its Pallas kernels in interpret mode."""
    b, t, c, h = 2, 256, 64, 2
    qkv, g = _inputs((b, t, 3 * c), 4), _inputs((b, t, c), 5, 1.0)
    ref = {}
    for dt in (jnp.bfloat16, jnp.float32):
        gg = _jax(g, dt)
        with force_interpret():
            out, vjp = jax.vjp(lambda q: jax_attn.flash_attention_vjp(q, h),
                               _jax(qkv, dt))
            ref[dt] = (out, vjp(gg)[0])
    x = torch.from_numpy(qkv).to(BF).requires_grad_()
    out = A.flash_attention_vjp(x, h)
    grad = torch.autograd.grad(out, x, torch.from_numpy(g).to(BF))[0]
    assert out.dtype == grad.dtype == BF
    for what, ours, j16, j32 in zip(("out", "grad"), (out, grad),
                                    ref[jnp.bfloat16], ref[jnp.float32]):
        assert_bf16_close(ours, j16, j32, what)


@pytest.mark.parametrize("fn", ["flash_attention_vjp", "qkv_attention"])
def test_flash_jvp_bf16_matches_jax(small_tiles, fn):
    """The tiled closed-form tangent in bf16 (FlashAttention's jvp, and
    QKVAttention's above the threshold) against jax.jvp of the JAX
    qkv_attention, whose rule differentiates the tiled
    _attention_flash_math in bf16 there."""
    b, t, c, h = 2, 64, 64, 2
    qkv, v = _inputs((b, t, 3 * c), 6), _inputs((b, t, 3 * c), 7, 1.0)
    ref = {dt: jax.jvp(lambda q: jax_attn.qkv_attention(q, h),
                       (_jax(qkv, dt),), (_jax(v, dt),))
           for dt in (jnp.bfloat16, jnp.float32)}
    out, tan = torch.func.jvp(lambda q: getattr(A, fn)(q, h),
                              (torch.from_numpy(qkv).to(BF),),
                              (torch.from_numpy(v).to(BF),))
    assert out.dtype == tan.dtype == BF
    for what, ours, j16, j32 in zip(("out", "tangent"), (out, tan),
                                    ref[jnp.bfloat16], ref[jnp.float32]):
        assert_bf16_close(ours, j16, j32, what)


@pytest.mark.parametrize("b,t,c", [(2, 64, 64), (2, 16, 128)])
def test_attention_math_bf16_matches_jax_kernel(b, t, c):
    """attention_math in bf16 against K6's Pallas kernel (_attention_pallas
    in interpret mode) and against _attention_math."""
    qkv = _inputs((b, t, 3 * c), 8)
    with force_interpret():
        ref = {dt: jax_attn._attention_pallas(_jax(qkv, dt), 1)
               for dt in (jnp.bfloat16, jnp.float32)}
    out = A.attention_math(torch.from_numpy(qkv).to(BF), 1)
    assert out.dtype == BF
    assert_bf16_close(out, ref[jnp.bfloat16], ref[jnp.float32], "kernel")
    math = {dt: jax_attn._attention_math(_jax(qkv, dt), 1)
            for dt in (jnp.bfloat16, jnp.float32)}
    assert_bf16_close(out, math[jnp.bfloat16], math[jnp.float32], "math")


@pytest.mark.parametrize("wrong", ["dout", "lse", "delta"])
def test_bf16_bwd_launch_checks_its_inputs(wrong):
    """K7b's launcher refuses a dout in another dtype than qkv, and lse or
    Δ not fp32 (B, heads, T), naming the input, before any launch."""
    b, t, c, h = 2, 64, 32, 2
    args = {"dout": torch.zeros(b, t, c, dtype=BF),
            "lse": torch.zeros(b, h, t), "delta": torch.zeros(b, h, t)}
    args[wrong] = {"dout": torch.zeros(b, t, c),
                   "lse": torch.zeros(b, h, t, dtype=BF),
                   "delta": torch.zeros(b, h, t + 1)}[wrong]
    with pytest.raises(ValueError, match=wrong):
        A._launch_bwd(torch.zeros(b, t, 3 * c, dtype=BF), args["dout"],
                      args["lse"], args["delta"], h)


def test_bf16_kernel_layouts():
    """The launch checks take bf16 (float16 still raises, naming the gap);
    the bf16 shared-memory mirrors against the constants of the sources,
    within one block's limit at every head width."""
    qkv, b, t, ch = A._checked(torch.zeros(2, 4, 24, dtype=BF), 2, "k")
    assert (qkv.dtype, b, t, ch) == (BF, 2, 4, 4)
    with pytest.raises(NotImplementedError, match="float16"):
        A._checked(torch.zeros(2, 4, 24, dtype=torch.float16), 2, "k")
    k6 = {k: v for k, v in _constants("attention.cu").items()
          if k.startswith(("kTiled", "kShort"))}
    assert (k6["kShortRows"], k6["kShortStages"]) == (A._K6_SHORT_ROWS,
                                                      A._K6_SHORT_STAGES)
    bwd = _constants("attention_bwd.cu")
    fwd = _constants("flash_fwd.cu")
    assert (fwd["kBfKeys"], fwd["kBfStages"], fwd["kBfGroupRows"]) == (
        A._FWD_BF_KEYS, A._FWD_BF_STAGES, A._FWD_BF_GROUP_ROWS)
    assert (k6["kTiledRows"], k6["kTiledKeys"], k6["kTiledStages"]) == (
        A._K6_TILED_ROWS, A._K6_TILED_KEYS, A._K6_TILED_STAGES)
    assert (bwd["kBfQueries"], bwd["kBfStages"]) == (A._BWD_BF_QUERIES,
                                                     A._BWD_BF_STAGES)
    for ch in range(1, A.MAX_HEAD_WIDTH + 1):
        # the wgmma kernels' tiles: whole 64-column blocks of the 128-byte
        # swizzle, and 1,024 bytes to align them
        w = 64 if ch <= 64 else 128
        assert A._swizzled_width(ch) == w
        for rows in (64, 128):  # K4's and K7a's bf16 blocks
            flash = 1024 + 2 * w * (rows + 2 * fwd["kBfStages"]
                                    * fwd["kBfKeys"])
            assert A.flash_fwd_smem_bytes(ch, BF, rows) == flash <= 232_448
        tiled = 1024 + 2 * w * (k6["kTiledRows"]
                                + 2 * k6["kTiledStages"] * k6["kTiledKeys"])
        for t in (65, 1024):  # K6's tiled body
            assert A.smem_bytes(t, ch, BF) == tiled <= 232_448
        assert A.smem_bytes(2048, ch, BF) == tiled  # the mirror's branch
        rows = A.bwd_query_rows(ch)
        dkdv = (1024 + 4 * bwd["kKeys"] * w
                + bwd["kBfStages"] * (4 * rows * w + 8 * rows))
        dq = 1024 + 4 * w * (bwd["kBfQueries"] + bwd["kBfStages"] * rows)
        assert A.bwd_smem_bytes(ch, BF) == dkdv <= 232_448
        assert A.bwd_dq_smem_bytes(ch) == dq <= 232_448
        short = 1024 + k6["kShortStages"] * 3 * 2 * k6["kShortRows"] * w
        for t in (1, 16, 17, 64):  # the short path's ring of 64-row tiles
            assert A.smem_bytes(t, ch, BF) == short <= 232_448
    assert A.flash_fwd_smem_bytes(128, BF, 128) == 164_864
    assert A.flash_fwd_smem_bytes(64, BF, 128) == 82_944
    # by shared memory (1 KB per block reserved): two tiled K6 blocks per SM
    # at W = 128, three of each K7b kernel at W = 64
    assert 2 * (A.smem_bytes(1024, 128, BF) + 1024) <= 233_472
    assert 3 * (A.bwd_smem_bytes(64, BF) + 1024) <= 233_472
    assert 3 * (A.bwd_dq_smem_bytes(64) + 1024) <= 233_472
    # the short path's blocks an SM: four at W = 64, two at W = 128
    assert 4 * (A.smem_bytes(64, 64, BF) + 1024) <= 233_472
    assert 2 * (A.smem_bytes(16, 128, BF) + 1024) <= 233_472
    assert A.smem_bytes(64, 64, BF) == 50_176
    assert A.smem_bytes(16, 128, BF) == 99_328
