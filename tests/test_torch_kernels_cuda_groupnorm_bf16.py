"""The bf16 variants of K5 and K5b against their plain twins on a card, at
the edges of their launch plans (``chip_smoke.py`` phase 21 holds them at
grf16's shapes). Every case is marked ``cuda`` and skips without a CUDA
device; run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py

Tolerances, as phase 21: K5 within 1.6e-2·max |plain| (two bf16 ulps);
K5b's dx within 2e-2·max |dx| of the vjp of the bf16 forward evaluated in
fp32, dγ and dβ within 1e-3·max of float64.
"""

import numpy as np
import pytest
import torch

from sdeflow_tpu_torch.ops.kernels.groupnorm import (
    K5, K5B, fwd_bf16_plan, gn_math, gn_math_vjp, group_norm_silu,
    kernel_fwd_bf16_plan)
from sdeflow_tpu_torch.ops.kernels.groupnorm import _launch_vjp as launch_k5b
from test_torch_kernels_cuda import _rand, dev  # noqa: F401

pytestmark = pytest.mark.cuda
BF = torch.bfloat16


def _rel(a, ref):
    return ((a.to(ref.dtype) - ref).abs().max() / ref.abs().max()).item()


# a small plan without 16-byte loads (S % 8 != 0), one block with them
# (8,192 elements a slab), K5b's stream plan and K5's cluster of 8 with
# them (70,000)
GN_CASES = [(3, 5, 7, 5), (2, 64, 4096, 32), (2, 32, 70_000, 32)]


@pytest.mark.parametrize("b,c,s,groups", GN_CASES)
@pytest.mark.parametrize("silu", [False, True])
def test_groupnorm_bf16_kernels_match_plain(dev, b, c, s, groups, silu):
    rng = np.random.default_rng(3)
    x = (3.0 * _rand(rng, b, c, s) + 1.0).to(dev, BF)
    gamma = (1.0 + 0.5 * _rand(rng, c)).to(dev)
    beta = (0.5 * _rand(rng, c)).to(dev)
    dy = _rand(rng, b, c, s).to(dev, BF)
    with torch.no_grad():
        before = K5.launches, K5B.launches
        out = group_norm_silu(x, gamma, beta, groups, silu)
        dx, dgamma, dbeta = launch_k5b(x, gamma, beta, groups, silu, dy)
        torch.cuda.synchronize()
        assert (K5.launches, K5B.launches) == (before[0] + 1, before[1] + 1)
        ref = gn_math(x, gamma, beta, groups, silu)
        ref_dx = gn_math_vjp(x.float(), gamma, beta, groups, silu,
                             dy.float())[0]
        ref64 = gn_math_vjp(x.double(), gamma.double(), beta.double(),
                            groups, silu, dy.double())
    assert out.dtype == dx.dtype == BF
    assert _rel(out, ref.float()) <= 1.6e-2
    assert _rel(dx, ref_dx) <= 2e-2
    assert _rel(dgamma, ref64[1]) <= 1e-3 and _rel(dbeta, ref64[2]) <= 1e-3


def test_groupnorm_bf16_kernels_take_misaligned_tensors(dev):
    """x and dy 2 bytes past a 16-byte boundary: the element loads."""
    rng = np.random.default_rng(4)
    b, c, s, groups = 2, 32, 256, 32
    buf = torch.empty(2, b * c * s + 1, dtype=BF, device=dev)
    buf.copy_(_rand(rng, 2, b * c * s + 1).to(dev))
    x, dy = (buf[i, 1:].view(b, c, s) for i in range(2))
    gamma = (1.0 + 0.5 * _rand(rng, c)).to(dev)
    beta = (0.5 * _rand(rng, c)).to(dev)
    assert fwd_bf16_plan(c // groups * s, s, False).vec == 1
    with torch.no_grad():
        out = group_norm_silu(x, gamma, beta, groups, True)
        dx = launch_k5b(x, gamma, beta, groups, True, dy)[0]
        ref = gn_math(x, gamma, beta, groups, True)
        ref_dx = gn_math_vjp(x.float(), gamma, beta, groups, True,
                             dy.float())[0]
    assert _rel(out, ref.float()) <= 1.6e-2 and _rel(dx, ref_dx) <= 2e-2


def test_groupnorm_bf16_plan_mirror_matches_the_kernels(dev):
    for n, s, aligned in [(64, 64, True), (128, 128, True),
                          (1024, 1024, True), (1032, 1032, True),
                          (8192, 8192, True), (65536, 65536, True),
                          (70_000, 70_000, True), (1028, 1028, True),
                          (7, 7, True), (256, 64, False)]:
        assert kernel_fwd_bf16_plan(n, s, aligned) == fwd_bf16_plan(
            n, s, aligned), (n, s)
