"""K5 bf16's launch plan on the CPU (``groupnorm.fwd_bf16_plan``, the Python
mirror of the C function ``choose_fwd_bf16``): the plan at every GroupNorm
slab of grf16's U-Net and of the grf U-Net at 128×128 (the shapes of
``PATH_PLANS`` in test_torch_groupnorm_bwd.py), its rules there, its edges
(1,024, 8,192 and 16,384 elements and one past each, every cluster size,
the stream plan, S % 8 ≠ 0 and misaligned tensors) and the constants it
shares with ``csrc/groupnorm.cu``. The card tests
(``test_torch_kernels_cuda_k5_bf16_edges.py``) hold the mirror to the
compiled chooser. No JAX."""

import re
from pathlib import Path

import pytest

from sdeflow_tpu_torch.models.common import group_count
from sdeflow_tpu_torch.ops.kernels import groupnorm as G

CSRC = Path(G.__file__).resolve().parents[2] / "csrc"

# (C, S) -> K5 bf16's plan: (kind, lanes, cluster, vectors a thread,
# elements a vector); grf16's slabs (n ≤ 768) take K5b bf16's small plan
FWD_PATH_PLANS = {
    (32, 64): ("small", 8, 1, 1, 8), (32, 256): ("small", 32, 1, 1, 8),
    (64, 16): ("small", 8, 1, 1, 8), (64, 64): ("small", 16, 1, 1, 8),
    (64, 256): ("small", 32, 1, 2, 8), (96, 64): ("small", 32, 1, 1, 8),
    (96, 256): ("small", 32, 1, 4, 8), (128, 16): ("small", 8, 1, 1, 8),
    (128, 64): ("small", 32, 1, 1, 8), (192, 16): ("small", 16, 1, 1, 8),
    (192, 64): ("small", 32, 1, 2, 8), (256, 16): ("small", 16, 1, 1, 8),
    (32, 4096): ("cluster", 256, 1, 2, 8),
    (32, 16384): ("cluster", 256, 1, 8, 8),
    (64, 1024): ("cluster", 256, 1, 1, 8),
    (64, 4096): ("cluster", 256, 1, 4, 8),
    (64, 16384): ("cluster", 256, 2, 8, 8),
    (96, 4096): ("cluster", 256, 1, 8, 8),
    (96, 16384): ("cluster", 256, 4, 8, 8),
    (128, 1024): ("cluster", 256, 1, 2, 8),
    (128, 4096): ("cluster", 256, 1, 8, 8),
    (192, 1024): ("cluster", 256, 1, 4, 8),
    (192, 4096): ("cluster", 256, 2, 8, 8),
    (256, 1024): ("cluster", 256, 1, 4, 8)}


def _n(c, s):
    return c // group_count(c) * s


def test_constants_match_the_source():
    src = (CSRC / "groupnorm.cu").read_text()

    def const(name):
        return int(re.search(rf"^constexpr int {name} = (\d+);", src,
                             re.M)[1])
    assert (const("kBfSmallMax"), const("kBfFwdBlockElems"),
            const("kBfScalarElems"), const("kBfBlockElems")) == (
        G.BF16_SMALL_MAX, G.BF16_FWD_BLOCK_ELEMS, G.BF16_SCALAR_ELEMS,
        G.BF16_BLOCK_ELEMS)
    assert (const("kThreads"), const("kMaxCluster")) == (G.THREADS,
                                                          G.MAX_CLUSTER)
    # the forward's chooser is the shared one with the forward's block
    assert re.search(r"choose_bf16\(n, S, aligned, kBfFwdBlockElems\)", src)


@pytest.mark.parametrize("dsm", [False, True])
def test_plans_at_the_paths(dsm):
    """Every slab of the paths keeps its plan, in registers (no stream), at
    most 64 elements of x a thread (128 bytes), a block's elements 32 KB of
    x at most, the small plan's lanes a warp's whole share; the grf16
    slabs as K5b bf16's plan."""
    for (c, s), want in FWD_PATH_PLANS.items():
        n = _n(c, s)
        if (n > G.BF16_SMALL_MAX) != dsm:
            continue
        plan = G.fwd_bf16_plan(n, s)
        assert tuple(plan) == want, (c, s)
        assert plan.lanes * plan.cluster * plan.nv * plan.vec >= n
        assert plan.nv * plan.vec * 2 <= 128
        assert plan.nv * plan.vec * plan.lanes * 2 <= 32 * 1024
        assert (plan.kind == "small") == (n <= G.BF16_SMALL_MAX)
        if not dsm:
            assert plan == G.bwd_bf16_plan(n, s)


def test_plan_rules_at_the_dsm_mix():
    """No slab of the DSM step up to 16,384 elements (so none up to 8,192)
    takes a cluster; the larger ones take 2 or 4 blocks, half of K5b's;
    every slab is whole vectors of 8."""
    dsm = {k: v for k, v in FWD_PATH_PLANS.items() if _n(*k) > 1024}
    clusters = set()
    for c, s in dsm:
        n = _n(c, s)
        plan = G.fwd_bf16_plan(n, s)
        assert plan.kind == "cluster" and plan.vec == 8
        assert (plan.cluster == 1) == (n <= G.BF16_FWD_BLOCK_ELEMS), (c, s)
        bwd = G.bwd_bf16_plan(n, s)
        assert plan.cluster == max(1, bwd.cluster // 2), (c, s)
        clusters.add(plan.cluster)
    assert clusters == {1, 2, 4}


@pytest.mark.parametrize("n,s,aligned,want", [
    (1024, 1024, True, ("small", 32, 1, 4, 8)),
    (1032, 1032, True, ("cluster", 256, 1, 1, 8)),
    (8192, 8192, True, ("cluster", 256, 1, 4, 8)),
    (8200, 8200, True, ("cluster", 256, 1, 8, 8)),
    (16384, 16384, True, ("cluster", 256, 1, 8, 8)),
    (16392, 16392, True, ("cluster", 256, 2, 8, 8)),
    (65536, 65536, True, ("cluster", 256, 4, 8, 8)),
    (131072, 131072, True, ("cluster", 256, 8, 8, 8)),
    (131080, 131080, True, ("stream", 256, 8, 0, 8)),
    (1025, 1025, True, ("cluster", 256, 1, 16, 1)),
    (8192, 1024, False, ("cluster", 256, 2, 16, 1))])
def test_plan_edges(n, s, aligned, want):
    """Past the small plan, one block, a cluster of 2, 4 and 8, the stream
    plan; without 16-byte loads (S % 8 ≠ 0, or a misaligned tensor) 16
    elements a thread, as K5b bf16's plan."""
    assert tuple(G.fwd_bf16_plan(n, s, aligned)) == want
    if want[4] == 1:
        assert G.fwd_bf16_plan(n, s, aligned) == G.bwd_bf16_plan(n, s,
                                                                 aligned)
