"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no JAX, so it also runs where only PyTorch is installed. The checks
of the parametrized cases are the ``check_*`` functions here, with their
case lists; the cases run from tests/test_torch_kernels_cuda_*.py (at most
15 to a file), all of them with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py

Tolerances: K1, K2 and K2's solve bit for bit against the plain versions
on every launch plan (the kernels round each product like the plain
versions, in their order, without FMA contraction), the solve also bit for
bit against a loop of K2 steps with the masked select; through autograd
1e-6; K3 rtol/atol
1e-5 (its four products in 3xTF32 on the tensor cores, within ~2^-21 of each
fp32 product, tests/test_torch_attn_tc.py; TF32 is off for the plain
version's matmuls); K5 rtol/atol 1e-5 (per-warp sums in another order than
PyTorch's reductions); K5b: dx within 1e-5·max |plain| of gn_math_vjp, dγ
and dβ (sums over B·S terms) within 1e-5·max of gn_math_vjp in float64; K6 atol 1e-5, K4 (T > 1024) 2e-5 (the online softmax
sums thousands of terms in another order than the plain version's softmax;
K6's and K4's products are 3xTF32 on the tensor cores, within ~2^-21 of each
fp32 product, tests/test_torch_flash_tc.py). Through autograd, the jvp and
the gradient of each Function (the kernel's forward, the plain version's
rules) against the plain version with the same tolerances. K7a: the output
within 2e-5·max |plain| (as K4) and lse within 1e-5; K7b: dqkv within
1e-4·max |plain| (each element sums T terms in another order; its dQ sums
arrive by atomics, so two runs on the same inputs agree within that
tolerance, not bit for bit). The cases cover the tensor-core kernels' edges:
T past 1024 that is not a multiple of 64, head widths that are not multiples
of 8 (20) or 4, ch = 8, and 4 heads; K6 at T = 1, 15, 16, 17, 64, 1000 and
1024 (units packed 4, 2 or 1 to a block up to T = 64, tiles above); K3 with
qkv in scratch (T = 256 at C = 64) and at B not a multiple of its samples
per block.
"""

import numpy as np
import pytest
import torch

from sdeflow_tpu_torch.models.common import group_count
from sdeflow_tpu_torch.ops.kernels.attention import (
    K4, K6, K7A, K7B, attention_core, attention_flash_bwd_math,
    attention_flash_stats_math, attention_math, flash_attention_vjp,
    qkv_attention)
from sdeflow_tpu_torch.ops.kernels.attention import (
    _launch_bwd as launch_k7b, _launch_stats as launch_k7a)
from sdeflow_tpu_torch.ops.kernels.attnblock import (
    K3, attn_block_math, fused_attention_block)
from sdeflow_tpu_torch.ops.kernels.circulant import (
    K1, K2, K2_SOLVE, circ_math, circulant_apply, circulant_plan,
    circulant_rk4_solve_select, circulant_rk4_step, rk4_math_fwd, rk4_plan,
    rk4_solve_select_math)
from sdeflow_tpu_torch.ops.kernels.circulant import (
    kernel_plan as circulant_kernel_plan)
from sdeflow_tpu_torch.ops.kernels.groupnorm import (
    K5, K5B, gn_math, gn_math_vjp, group_norm_silu, kernel_plan,
    launch_plan)
from sdeflow_tpu_torch.ops.kernels.groupnorm import _launch_vjp as launch_k5b

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# the launch plans' edges of K1 and K2 (circulant_plan, rk4_plan): the warp
# plan from 1 to 32 floats per lane (96 and 992 without float4 loads),
# d past 1,024 or not a multiple of 32 (the general plans, K2's with 16
# rows per block at d = 16 and its buffers in device memory at d = 100,000),
# B not a multiple of the rows per block; each aligned and 4 bytes past a
# 16-byte boundary (the warp plans then load one float at a time)
CIRC_SHAPES = [(1024, 256), (1000, 256), (1024, 1024), (3, 5), (2, 1),
               (9, 32), (7, 96), (5, 128), (3, 992), (3, 1056), (5, 33),
               (1000, 16), (1023, 256)]


def _misaligned(t):
    """t's values in a tensor that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_circulant_kernel(dev, shape, aligned):
    rng = np.random.default_rng(0)
    y, w = _rand(rng, *shape).to(dev), _rand(rng, *shape).to(dev)
    sb = (1.0 + _rand(rng, shape[0], 1).abs()).to(dev)
    if not aligned:
        y, w = _misaligned(y), _misaligned(w)
    with torch.no_grad():
        before = K1.launches
        out = circulant_apply(sb, y, w)
        torch.cuda.synchronize()
        assert K1.launches == before + 1
        assert torch.equal(out, circ_math(sb, y, w))
        # a number for sqrt_beta broadcasts like the plain version
        assert torch.equal(circulant_apply(2.5, y, w), circ_math(2.5, y, w))


RK4_SHAPES = CIRC_SHAPES + [(128, 256), (2, 100_000)]


def check_rk4_kernel(dev, shape, aligned):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, *shape).to(dev), 0.3 * _rand(rng, *shape).to(dev)
    sb3 = torch.from_numpy(1.0 + rng.random((shape[0], 3)).astype(
        np.float32)).to(dev)
    if not aligned:
        x, w = _misaligned(x), _misaligned(w)
    with torch.no_grad():
        before = K2.launches
        out = circulant_rk4_step(sb3, x, w)
        torch.cuda.synchronize()
        assert K2.launches == before + 1
        assert torch.equal(out, rk4_math_fwd(sb3, x, w))


def test_circulant_plan_mirrors_match_the_kernels(dev):
    for b in (1, 5, 8, 9, 128, 1000, 1024):
        for d in (1, 16, 31, 32, 33, 96, 100, 128, 256, 992, 1000, 1024,
                  1056, 2048, 100_000):
            for aligned in (True, False):
                assert (circulant_kernel_plan(K1, b, d, aligned)
                        == circulant_plan(b, d, aligned))
                assert (circulant_kernel_plan(K2, b, d, aligned)
                        == rk4_plan(b, d, aligned))


def _select(kind, b, n, rng):
    if kind == "zeros":
        return torch.zeros(b, dtype=torch.int64)
    if kind == "full":
        return torch.full((b,), n, dtype=torch.int64)
    # every count from 0 to n, and two outside [0, n] (x0 kept, as the
    # masked select keeps it)
    sel = torch.from_numpy(rng.integers(0, n + 1, b))
    sel[:3] = torch.tensor([0, n, -1 if b > 3 else 0])
    if b > 4:
        sel[3] = n + 1
    return sel


SOLVE_CASES = [(64, 128, 256), (8, 7, 96), (8, 5, 1056), (8, 6, 100),
               (4, 3, 2048)]  # (n, b, d), each with three select kinds


def check_solve_against_the_step_loop(dev, n, b, d, kind):
    rng = np.random.default_rng(3)
    x0 = _rand(rng, b, d).to(dev)
    z = _rand(rng, n, b, d).to(dev)
    sb = torch.from_numpy(1.0 + rng.random((n, 3)).astype(np.float32)).to(dev)
    sel = _select(kind, b, n, rng).to(dev)
    sd = (1.0 / n) ** 0.5
    with torch.no_grad():
        before = K2_SOLVE.launches, K2.launches
        got = circulant_rk4_solve_select(x0, z, sb, sel, sd)
        torch.cuda.synchronize()
        assert (K2_SOLVE.launches, K2.launches) == (before[0] + 1, before[1])
        x = kept = x0
        for i in range(n):
            x = circulant_rk4_step(sb[i].expand(b, 3), x, sd * z[i])
            kept = torch.where(sel.reshape(-1, 1) == i + 1, x, kept)
        assert torch.equal(got, kept)
        torch.testing.assert_close(
            got, rk4_solve_select_math(x0, z, sb, sel, sd), rtol=1e-6,
            atol=1e-6)


def test_sample_scheme_launches_one_solve(dev):
    from sdeflow_tpu_torch.sde.msgm import MSGMSde

    g = torch.Generator(device=dev).manual_seed(0)
    sde = MSGMSde.create(torch.randn(512, 256, generator=g, device=dev),
                         beta_max=80.0, t_epsilon=4e-3, num_steps_forward=64,
                         dense_tensor=False, norm_map="log")
    x = torch.randn(128, 256, generator=g, device=dev)
    t = torch.rand(128, generator=g, device=dev)
    t[0] = 0.001  # below one grid step: the one-step fallback (K1)
    before = K2_SOLVE.launches, K2.launches, K1.launches
    out = sde.sample(g, t, x)
    torch.cuda.synchronize()
    assert (K2_SOLVE.launches - before[0], K2.launches - before[1],
            K1.launches - before[2]) == (1, 0, 4)
    assert torch.isfinite(out).all() and out.shape == x.shape


def test_autograd_through_the_solve_matches_plain(dev):
    rng = np.random.default_rng(4)
    n, b, d = 8, 128, 256
    args = [_rand(rng, b, d).to(dev), _rand(rng, n, b, d).to(dev),
            torch.from_numpy(1.0 + rng.random((n, 3)).astype(
                np.float32)).to(dev)]
    sel = _select("mixed", b, n, rng).to(dev)
    sd = (1.0 / n) ** 0.5
    before = K2_SOLVE.launches
    got = _through_autograd(
        lambda *a: circulant_rk4_solve_select(*a, sel, sd), args,
        np.random.default_rng(6))
    assert K2_SOLVE.launches == before + 2  # the jvp's forward, the grad's
    want = _through_autograd(
        lambda *a: rk4_solve_select_math(*a, sel, sd), args,
        np.random.default_rng(6))
    for a, b_ in zip(got, want):  # output, tangent, then each gradient
        torch.testing.assert_close(a, b_, rtol=1e-6,
                                   atol=1e-6 * b_.abs().max().item())


def _through_autograd(fn, args, rng):
    """fn's jvp (random tangents on every argument) and the gradients of
    sum(fn(args)·g) for a random cotangent g."""
    def draw(a):
        return torch.from_numpy(rng.standard_normal(a.shape).astype(
            np.float32)).to(a.device)

    out, tan = torch.func.jvp(fn, tuple(args), tuple(map(draw, args)))
    diff = [a.detach().requires_grad_() for a in args]
    grads = torch.autograd.grad((fn(*diff) * draw(out)).sum(), diff)
    return (out, tan, *grads)


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K5", "K6"])
def test_autograd_through_kernels_matches_plain(dev, name):
    rng = np.random.default_rng(5)
    if name == "K5":
        args = [(2.0 * _rand(rng, 128, 96, 64) + 0.5).to(dev),
                (1.0 + 0.1 * _rand(rng, 96)).to(dev),
                (0.1 * _rand(rng, 96)).to(dev)]
        kern = lambda *a: group_norm_silu(*a, 32, True)  # noqa: E731
        plain = lambda *a: gn_math(*a, 32, True)  # noqa: E731
        kernel, tol = K5, 1e-5
    elif name == "K6":
        args = [(1.5 * _rand(rng, 128, 64, 192)).to(dev)]
        kern = lambda q: qkv_attention(q, 2)  # noqa: E731
        plain = lambda q: attention_math(q, 2)  # noqa: E731
        kernel, tol = K6, 1e-5
    elif name == "K3":
        args = _block_args(rng, 128, 64, 64, dev)
        kern = lambda *a: fused_attention_block(*a, 32, 1)  # noqa: E731
        plain = lambda *a: attn_block_math(*a, 32, 1)  # noqa: E731
        kernel, tol = K3, 1e-5
    else:
        y, w = _rand(rng, 128, 256).to(dev), _rand(rng, 128, 256).to(dev)
        if name == "K1":
            args = [(1.0 + _rand(rng, 128, 1).abs()).to(dev), y, w]
            kern, plain, kernel = circulant_apply, circ_math, K1
        else:
            args = [(1.0 + _rand(rng, 128, 3).abs()).to(dev), y, 0.3 * w]
            kern, plain, kernel = circulant_rk4_step, rk4_math_fwd, K2
        tol = 1e-6
    before, before_b = kernel.launches, K5B.launches
    got = _through_autograd(kern, args, np.random.default_rng(6))
    assert kernel.launches == before + 2  # the jvp's forward, the grad's
    # K5's gradient (grad mode off) through its own kernel K5b
    assert K5B.launches == before_b + (name == "K5")
    want = _through_autograd(plain, args, np.random.default_rng(6))
    for a, b in zip(got, want):  # output, tangent, then each gradient
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * b.abs().max().item())


def _block_args(rng, b, t, c, dev):
    args = [2.0 * _rand(rng, b, t, c) + 0.5, 1.0 + 0.1 * _rand(rng, c),
            0.1 * _rand(rng, c), _rand(rng, c, 3 * c) / c**0.5,
            0.1 * _rand(rng, 3 * c), _rand(rng, c, c) / c**0.5,
            0.1 * _rand(rng, c)]
    return [a.to(dev) for a in args]


K3_CASES = [(1024, 64, 64, 1), (1024, 16, 128, 1), (1024, 64, 64, 4),
            (16, 64, 64, 8), (8, 256, 64, 2), (5, 7, 24, 3)]
# T = 256 at C = 64 and T = 2 at C = 2048 put qkv in device-memory scratch
# (mode 1), T = 1 at C = 4096 h too (mode 2); B not a multiple of the
# samples per block (2 at T = 16); head widths 8
K3_EDGES = [(3, 256, 64, 8), (5, 16, 128, 1), (7, 16, 64, 8), (3, 17, 32, 4),
            (3, 2, 2048, 4), (2, 1, 4096, 8)]


def check_attention_block_kernel(dev, b, t, c, heads):
    args = _block_args(np.random.default_rng(1), b, t, c, dev)
    groups = group_count(c)
    with torch.no_grad():
        before = K3.launches
        out = fused_attention_block(*args, groups, heads)
        torch.cuda.synchronize()
        assert K3.launches == before + 1
        ref = attn_block_math(*args, groups, heads)
    assert (ref - args[0]).abs().max() > 0.1  # not the identity
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_attention_block_kernel_rejects_what_it_does_not_cover(dev):
    args = _block_args(np.random.default_rng(2), 2, 512, 32, dev)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="T <="):
        fused_attention_block(*args, 32, 1)
    args = [a.to(torch.bfloat16) for a in
            _block_args(np.random.default_rng(2), 2, 16, 32, dev)]
    with torch.no_grad(), pytest.raises(NotImplementedError, match="float32"):
        fused_attention_block(*args, 32, 1)


# the launch plans' edges (groupnorm.launch_plan): slabs of n = S floats
# (C = G = 32) just below and above each threshold of the lanes per slab
# (32, 64), the vectors per lane (128, 1,024), the cluster size (8,192,
# 16,384) and the stream plan (65,536); S % 4 != 0 (1,023 and 1,025 floats,
# and 33,333: streamed); a cluster block ending inside a channel (C/G = 2,
# S = 4,100); 8-lane slabs past the last whole block (B·G = 15); and the
# DSM step's largest slab (49,152 floats)
GN_EDGES = [(3, 32, s, 32) for s in (32, 36, 64, 68, 128, 132, 1024, 1028,
                                     8192, 8196, 16384, 16388, 65536,
                                     65540, 1023, 1025, 33333)] + [
    (2, 64, 4100, 32), (3, 10, 16, 5), (4, 96, 16384, 32)]
# grf16's GroupNorms at batch 1024 and the DSM step's at batch 128 (32
# groups each)
GN_PATH = [(1024, 32, 256, 32), (1024, 96, 256, 32), (1024, 64, 64, 32),
           (1024, 192, 64, 32), (1024, 256, 16, 32), (1024, 64, 16, 32),
           (128, 32, 16384, 32), (128, 96, 16384, 32), (128, 64, 1024, 32),
           (128, 192, 1024, 32), (128, 192, 4096, 32)]


def _gn_inputs(b, c, s, dev, seed=3):
    rng = np.random.default_rng(seed)
    return ((3.0 * _rand(rng, b, c, s) + 1.0).to(dev),
            (1.0 + 0.5 * _rand(rng, c)).to(dev), (0.5 * _rand(rng, c)).to(dev))


# (2, 64, 4096) has slabs of 8192 floats: a cluster of 2 blocks
GN_FWD_SHAPES = [(1024, 32, 256, 32), (1024, 96, 256, 32), (1024, 64, 64, 32),
                 (1024, 192, 64, 32), (1024, 256, 16, 32), (3, 5, 7, 5),
                 (2, 10, 3, 2), (2, 64, 4096, 32), *GN_PATH[5:], *GN_EDGES]
GN_BWD_SHAPES = [(3, 5, 7, 5), (2, 10, 3, 2), *GN_PATH, *GN_EDGES]


def check_groupnorm_kernel(dev, b, c, s, groups, silu):
    rng = np.random.default_rng(3)
    x = (3.0 * _rand(rng, b, c, s) + 1.0).to(dev)
    gamma = (1.0 + 0.5 * _rand(rng, c)).to(dev)
    beta = (0.5 * _rand(rng, c)).to(dev)
    with torch.no_grad():
        before = K5.launches
        out = group_norm_silu(x, gamma, beta, groups, silu)
        torch.cuda.synchronize()
        assert K5.launches == before + 1
        ref = gn_math(x, gamma, beta, groups, silu)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    if not silu:  # PyTorch's own GroupNorm computes the same function
        torch.testing.assert_close(out, torch.nn.functional.group_norm(
            x, groups, gamma, beta, eps=1e-5), rtol=1e-5, atol=1e-5)


def check_groupnorm_backward_kernel(dev, b, c, s, groups, silu):
    x, gamma, beta = _gn_inputs(b, c, s, dev)
    dy = _rand(np.random.default_rng(4), b, c, s).to(dev)
    before = K5.launches, K5B.launches
    with torch.no_grad():
        dx, dgamma, dbeta = launch_k5b(x, gamma, beta, groups, silu, dy)
        torch.cuda.synchronize()
        assert (K5.launches, K5B.launches) == (before[0], before[1] + 1)
        # the same bits again: no atomics
        again = launch_k5b(x, gamma, beta, groups, silu, dy)
        ref_dx = gn_math_vjp(x, gamma, beta, groups, silu, dy)[0]
        ref64 = gn_math_vjp(*(t.double() for t in (x, gamma, beta)), groups,
                            silu, dy.double())
    assert all(torch.equal(a, r) for a, r in zip((dx, dgamma, dbeta), again))
    torch.testing.assert_close(dx, ref_dx, rtol=1e-5,
                               atol=1e-5 * ref_dx.abs().max().item())
    for got, want in zip((dgamma, dbeta), ref64[1:]):
        torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


def test_groupnorm_plan_mirror_matches_the_kernels(dev):
    sizes = [(n, s) for s in (1, 3, 4, 7, 16, 64, 1023, 1024, 1025, 4100,
                              16384, 33333, 65536, 65540)
             for n in (s, 2 * s, 3 * s, 6 * s, 8 * s)]
    for n, s in sizes:
        for aligned in (True, False):
            assert kernel_plan(n, s, aligned) == launch_plan(n, s, aligned)


def test_groupnorm_kernels_take_empty_slabs(dev):
    x = torch.zeros(2, 8, 0, device=dev)
    w = torch.ones(8, device=dev)
    with torch.no_grad():
        assert group_norm_silu(x, w, w, 4, True).shape == x.shape
        dx, dgamma, dbeta = launch_k5b(x, w, w, 4, True, x)
    torch.cuda.synchronize()
    assert dx.shape == x.shape and not dgamma.any() and not dbeta.any()


ATTENTION_CASES = [
    (1024, 64, 64, 1), (1024, 16, 128, 1), (1024, 64, 64, 4),
    (4, 4096, 64, 1), (4, 4096, 64, 2), (2, 2048, 128, 1), (3, 37, 48, 3),
    (2, 5, 256, 2), (2, 1100, 64, 1), (2, 2049, 64, 1), (2, 1100, 60, 3),
    (2, 2049, 8, 1), (2, 1100, 256, 4), (2, 1030, 126, 2)]


def check_attention_kernel(dev, b, t, c, heads):
    rng = np.random.default_rng(4)
    qkv = (1.5 * _rand(rng, b, t, 3 * c)).to(dev)
    kernel, other = (K4, K6) if t > 1024 else (K6, K4)
    with torch.no_grad():
        before = kernel.launches, other.launches
        out = qkv_attention(qkv, heads)
        torch.cuda.synchronize()
        assert (kernel.launches, other.launches) == (before[0] + 1, before[1])
        ref = attention_math(qkv, heads)
    tol = 2e-5 if t > 1024 else 1e-5  # K4's tiled online softmax above
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


SHORT_T = [1, 15, 16, 17, 64, 1000, 1024]
HEAD_WIDTHS = [(1, 64), (4, 16), (8, 8), (1, 128)]  # (heads, ch)


def check_attention_kernel_edges(dev, t, heads, ch):
    # K6's short-sequence design up to T = 64 (4, 2 or 1 units per block),
    # the tiled one above. Against the plain version in float64: at
    # T = 1000-1024 and ch = 128 the fp32 plain version is itself about
    # 1e-5 from it (chip_smoke.py phase 6 prints both at (128, 1024, 128))
    qkv = (1.5 * _rand(np.random.default_rng(4), 3, t, 3 * heads * ch)).to(
        dev)
    with torch.no_grad():
        before = K6.launches
        out = qkv_attention(qkv, heads)
        torch.cuda.synchronize()
        assert K6.launches == before + 1
        ref = attention_math(qkv.double(), heads)
    torch.testing.assert_close(out.double(), ref, rtol=0, atol=1e-5)


def test_attention_kernel_rejects_what_it_does_not_cover(dev):
    qkv = torch.randn(2, 8, 3 * 256, device=dev)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="128"):
        qkv_attention(qkv, 1)
    # bf16 has its own entry; float16 has none
    with torch.no_grad(), pytest.raises(NotImplementedError, match="float16"):
        qkv_attention(qkv.to(torch.float16), 2)
    x = torch.randn(2, 8, 5, device=dev, dtype=torch.bfloat16)
    w = torch.ones(8, device=dev, dtype=torch.bfloat16)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="float32"):
        group_norm_silu(x, w, w, 4, True)


def _flash_inputs(rng, b, t, c, heads, dev):
    qkv = (1.5 * _rand(rng, b, t, 3 * c)).to(dev)
    dout = _rand(rng, b, t, c).to(dev)
    with torch.no_grad():
        out, lse = attention_flash_stats_math(qkv, heads)
    delta = (dout * out).reshape(b, t, heads, -1).sum(-1).transpose(1, 2)
    return qkv, dout, lse, delta.contiguous()


FLASH_CASES = [
    (4, 4096, 64, 1), (4, 4096, 64, 2), (2, 2048, 128, 1), (2, 1000, 64, 1),
    (3, 37, 48, 3), (2, 1100, 64, 1), (2, 2049, 64, 1), (2, 1000, 60, 3),
    (2, 2049, 8, 1), (2, 1100, 256, 4), (2, 1030, 126, 2)]


def check_flash_pair_kernels(dev, b, t, c, heads):
    qkv, dout, lse, delta = _flash_inputs(np.random.default_rng(7), b, t, c,
                                          heads, dev)
    with torch.no_grad():
        before = K7A.launches, K7B.launches
        out, lse_k = launch_k7a(qkv, heads)
        dqkv = launch_k7b(qkv, dout, lse, delta, heads)
        torch.cuda.synchronize()
        assert (K7A.launches, K7B.launches) == (before[0] + 1, before[1] + 1)
        out_p, lse_p = attention_flash_stats_math(qkv, heads)
        dqkv_p = attention_flash_bwd_math(qkv, dout, lse, delta, heads)
    torch.testing.assert_close(out, out_p, rtol=0,
                               atol=2e-5 * out_p.abs().max().item())
    torch.testing.assert_close(lse_k, lse_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(dqkv, dqkv_p, rtol=0,
                               atol=1e-4 * dqkv_p.abs().max().item())


def test_flash_backward_runs_agree(dev):
    # dQ arrives by atomics in any order: equal within the tolerance, dK and
    # dV (one writer each) bit for bit
    qkv, dout, lse, delta = _flash_inputs(np.random.default_rng(9), 4, 4096,
                                          64, 1, dev)
    with torch.no_grad():
        runs = [launch_k7b(qkv, dout, lse, delta, 1) for _ in range(2)]
    torch.cuda.synchronize()
    torch.testing.assert_close(runs[0], runs[1], rtol=0,
                               atol=1e-4 * runs[0].abs().max().item())
    assert torch.equal(runs[0][..., 64:], runs[1][..., 64:])


def test_attention_core_takes_the_pair_under_autograd(dev):
    rng = np.random.default_rng(8)
    qkv = (1.5 * _rand(rng, 2, 2048, 3 * 64)).to(dev)
    cot = _rand(rng, 2, 2048, 64).to(dev)
    counts = lambda: (K4.launches, K7A.launches, K7B.launches)  # noqa: E731
    before = counts()
    with torch.no_grad():
        attention_core(qkv, 2)
    assert counts() == (before[0] + 1, before[1], before[2])
    x = qkv.clone().requires_grad_()
    grad = torch.autograd.grad((attention_core(x, 2) * cot).sum(), x)[0]
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    x = qkv.clone().requires_grad_()
    want = torch.autograd.grad((attention_math(x, 2) * cot).sum(), x)[0]
    torch.testing.assert_close(grad, want, rtol=0,
                               atol=1e-4 * want.abs().max().item())


def test_flash_pair_rejects_what_it_does_not_cover(dev):
    qkv = torch.randn(2, 8, 3 * 256, device=dev)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="128"):
        flash_attention_vjp(qkv, 1)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="float16"):
        flash_attention_vjp(qkv.to(torch.float16), 2)
