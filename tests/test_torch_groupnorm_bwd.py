"""Kernel K5b (GroupNorm + SiLU's backward) and the launch plans of K5 and
K5b, on the CPU: the plain version ``gn_math_vjp`` against ``jax.vjp`` of
the JAX package's ``group_norm_silu`` (its Pallas forward run in interpret
mode, its backward the transpose of the ``custom_jvp`` rule) and against
``torch.func.vjp`` of ``gn_math``; ``GroupNormSiLU``'s backward with grad
mode off on the CPU (the closed form, no launch); and the Python mirror of
the kernels' launch plan at every GroupNorm shape of the grf16 and DSM
paths (``PATH_PLANS`` and ``check_path_plan``, whose cases run in
test_torch_groupnorm_plans_grf16.py and test_torch_groupnorm_plans_dsm.py;
the plans' edges are in test_torch_groupnorm_plan_edges.py, the CUDA
kernels on a card in test_torch_kernels_cuda*.py).

Tolerances: against JAX 1e-5·max of each gradient in float32 (sums in
another order; dγ and dβ sum B·S terms); against ``torch.func`` rtol/atol
1e-12 in float64 (the same algebra, rounded differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdeflow_tpu.ops.pallas.common import force_interpret
from sdeflow_tpu.ops.pallas.groupnorm import group_norm_silu as jax_gn
from sdeflow_tpu_torch.models.common import group_count
from sdeflow_tpu_torch.ops.kernels.groupnorm import (
    K5, K5B, MAX_CLUSTER, SMALL_MAX, THREADS, gn_math, gn_math_vjp,
    group_norm_silu, launch_plan)

torch.set_num_threads(1)


def _inputs(b, c, s, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = 3.0 * rng.standard_normal((b, c, s)) + 1.0
    gamma = 1.0 + 0.5 * rng.standard_normal(c)
    beta = 0.5 * rng.standard_normal(c)
    dy = rng.standard_normal((b, c, s))
    return tuple(torch.from_numpy(a.astype(dtype))
                 for a in (x, gamma, beta, dy))


@pytest.mark.parametrize("b,s,c,groups", [(4, 49, 32, 8), (2, 256, 96, 32)])
@pytest.mark.parametrize("silu", [False, True])
def test_vjp_matches_jax(b, s, c, groups, silu):
    x, gamma, beta, dy = _inputs(b, c, s)
    with force_interpret():
        _, vjp = jax.vjp(lambda *a: jax_gn(*a, groups, silu),
                         jnp.asarray(x.transpose(1, 2).numpy()),
                         jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()))
        want = vjp(jnp.asarray(dy.transpose(1, 2).numpy()))
    want = (np.asarray(want[0]).transpose(0, 2, 1), *map(np.asarray, want[1:]))
    got = gn_math_vjp(x, gamma, beta, groups, silu, dy)
    for a, w in zip(got, want):
        scale = np.abs(w).max()
        assert scale > 0.1
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("b,c,s,groups", [(3, 12, 10, 4), (2, 6, 7, 3)])
@pytest.mark.parametrize("silu", [False, True])
def test_vjp_matches_func_vjp(b, c, s, groups, silu):
    x, gamma, beta, dy = _inputs(b, c, s, seed=1, dtype=np.float64)
    got = gn_math_vjp(x, gamma, beta, groups, silu, dy)
    _, vjp = torch.func.vjp(lambda *a: gn_math(*a, groups, silu), x, gamma,
                            beta)
    for a, w in zip(got, vjp(dy)):
        torch.testing.assert_close(a, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("silu", [False, True])
def test_backward_with_grad_mode_off_is_the_closed_form(silu):
    x, gamma, beta, dy = _inputs(2, 8, 9, seed=2)
    ts = [t.requires_grad_() for t in (x, gamma, beta)]
    before = K5.launches, K5B.launches
    grads = torch.autograd.grad(group_norm_silu(*ts, 4, silu), ts, dy)
    assert (K5.launches, K5B.launches) == before  # the CPU launches nothing
    want = gn_math_vjp(x.detach(), gamma.detach(), beta.detach(), 4, silu,
                       dy)
    for a, w in zip(grads, want):
        assert torch.equal(a, w)


# (C, S) of every GroupNorm of grf16's U-Net and of the grf U-Net at
# 128x128 (the DSM step), 32 groups each, and the plan each takes:
# (kind, lanes, cluster, vectors per thread, floats per vector)
PATH_PLANS = {
    (32, 64): ("small", 16, 1, 1, 4), (32, 256): ("small", 32, 1, 2, 4),
    (64, 16): ("small", 8, 1, 1, 4), (64, 64): ("small", 32, 1, 1, 4),
    (64, 256): ("small", 32, 1, 4, 4), (96, 64): ("small", 32, 1, 2, 4),
    (96, 256): ("small", 32, 1, 8, 4), (128, 16): ("small", 16, 1, 1, 4),
    (128, 64): ("small", 32, 1, 2, 4), (192, 16): ("small", 32, 1, 1, 4),
    (192, 64): ("small", 32, 1, 4, 4), (256, 16): ("small", 32, 1, 1, 4),
    (32, 4096): ("cluster", 256, 2, 2, 4),
    (32, 16384): ("cluster", 256, 4, 4, 4),
    (64, 1024): ("cluster", 256, 2, 1, 4),
    (64, 4096): ("cluster", 256, 2, 4, 4),
    (64, 16384): ("cluster", 256, 8, 4, 4),
    (96, 4096): ("cluster", 256, 4, 4, 4),
    (96, 16384): ("cluster", 256, 8, 8, 4),
    (128, 1024): ("cluster", 256, 2, 2, 4),
    (128, 4096): ("cluster", 256, 4, 4, 4),
    (192, 1024): ("cluster", 256, 2, 4, 4),
    (192, 4096): ("cluster", 256, 8, 4, 4),
    (256, 1024): ("cluster", 256, 2, 4, 4)}
SHARED_BYTES = 4 * (2 * THREADS // 32 + 4)  # a cluster block's sums


def check_path_plan(c, s):
    """launch_plan at the GroupNorm shape (C, S) of a path: PATH_PLANS'
    plan, and one whose threads hold the slab without streaming."""
    n = c // group_count(c) * s
    plan = launch_plan(n, s)
    assert tuple(plan) == PATH_PLANS[(c, s)]
    # the slab fits what its threads hold: no shape of the paths streams
    assert plan.lanes * plan.cluster * plan.nv * plan.vec >= n
    held = plan.nv * plan.vec  # floats of x a thread holds (K5b: and dy)
    assert 2 * held <= 64 and plan.cluster <= MAX_CLUSTER
    assert SHARED_BYTES <= 48 * 1024
    # the lane groups tile a warp; one warp's slabs are whole
    assert plan.kind == ("small" if n <= SMALL_MAX else "cluster")
    assert 32 % plan.lanes == 0 or plan.lanes == THREADS
