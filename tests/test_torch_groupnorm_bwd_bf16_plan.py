"""K5b bf16's own launch plan on the CPU (``groupnorm.bwd_bf16_plan``, the
Python mirror of the C function ``choose_bwd_bf16``): the plan at every
GroupNorm slab of grf16's U-Net and of the grf U-Net at 128×128 (the
shapes of ``PATH_PLANS``), its rules there, and the plan at its edges
(just below and above the small plan's 1,024 elements, one block's 8,192,
the cluster sizes, the stream plan; S % 8 ≠ 0 and misaligned tensors),
as ``test_torch_groupnorm_plan_edges.py`` holds the fp32 plan. The card
tests (``test_torch_kernels_cuda_k5b_bf16_edges.py``) hold the mirror to
the compiled chooser."""

import re
from pathlib import Path

import pytest

from sdeflow_tpu_torch.models.common import group_count
from sdeflow_tpu_torch.ops.kernels import groupnorm as G
from test_torch_groupnorm_bwd import PATH_PLANS

CSRC = Path(G.__file__).resolve().parents[2] / "csrc"

# (C, S) -> K5b bf16's plan: (kind, lanes, cluster, vectors a thread,
# elements a vector)
BF16_PATH_PLANS = {
    (32, 64): ("small", 8, 1, 1, 8), (32, 256): ("small", 32, 1, 1, 8),
    (64, 16): ("small", 8, 1, 1, 8), (64, 64): ("small", 16, 1, 1, 8),
    (64, 256): ("small", 32, 1, 2, 8), (96, 64): ("small", 32, 1, 1, 8),
    (96, 256): ("small", 32, 1, 4, 8), (128, 16): ("small", 8, 1, 1, 8),
    (128, 64): ("small", 32, 1, 1, 8), (192, 16): ("small", 16, 1, 1, 8),
    (192, 64): ("small", 32, 1, 2, 8), (256, 16): ("small", 16, 1, 1, 8),
    (32, 4096): ("cluster", 256, 1, 2, 8),
    (32, 16384): ("cluster", 256, 2, 4, 8),
    (64, 1024): ("cluster", 256, 1, 1, 8),
    (64, 4096): ("cluster", 256, 1, 4, 8),
    (64, 16384): ("cluster", 256, 4, 4, 8),
    (96, 4096): ("cluster", 256, 2, 4, 8),
    (96, 16384): ("cluster", 256, 8, 4, 8),
    (128, 1024): ("cluster", 256, 1, 2, 8),
    (128, 4096): ("cluster", 256, 2, 4, 8),
    (192, 1024): ("cluster", 256, 1, 4, 8),
    (192, 4096): ("cluster", 256, 4, 4, 8),
    (256, 1024): ("cluster", 256, 1, 4, 8)}


def test_constants_match_the_source():
    src = (CSRC / "groupnorm.cu").read_text()

    def const(name):
        return int(re.search(rf"^constexpr int {name} = (\d+);", src,
                             re.M)[1])
    assert (const("kBfSmallMax"), const("kBfBlockElems"),
            const("kBfScalarElems")) == (G.BF16_SMALL_MAX,
                                         G.BF16_BLOCK_ELEMS,
                                         G.BF16_SCALAR_ELEMS)
    assert (const("kThreads"), const("kSmallMax"), const("kMaxCluster")) == (
        G.THREADS, G.SMALL_MAX, G.MAX_CLUSTER)


@pytest.mark.parametrize("dsm", [False, True])
def test_plans_at_the_paths(dsm):
    """Every slab of the paths keeps its plan, held in registers (no
    stream), at most 32 elements of x a thread (64 bytes), a block's
    elements 16 KB of x at most (an fp32 block's bytes), a cluster only
    past one block's 8,192 elements, and the small plan's lanes a warp's
    whole share; the same shapes as the fp32 plan's PATH_PLANS."""
    assert set(BF16_PATH_PLANS) == set(PATH_PLANS)
    for (c, s), want in BF16_PATH_PLANS.items():
        n = c // group_count(c) * s
        if (n > G.SMALL_MAX) != dsm:
            continue
        plan = G.bwd_bf16_plan(n, s)
        assert tuple(plan) == want, (c, s)
        assert plan.lanes * plan.cluster * plan.nv * plan.vec >= n
        assert plan.nv * plan.vec * 2 <= 64
        assert plan.nv * plan.vec * plan.lanes * 2 <= 16 * 1024
        assert (plan.kind == "small") == (n <= G.BF16_SMALL_MAX)
        assert (plan.cluster > 1) == (n > G.BF16_BLOCK_ELEMS)
        assert 32 % plan.lanes == 0 or plan.lanes == G.THREADS


@pytest.mark.parametrize("n,s,aligned,want", [
    (64, 64, True, ("small", 8, 1, 1, 8)),
    (136, 136, True, ("small", 32, 1, 1, 8)),
    (1024, 1024, True, ("small", 32, 1, 4, 8)),
    (1032, 1032, True, ("cluster", 256, 1, 1, 8)),
    (8192, 8192, True, ("cluster", 256, 1, 4, 8)),
    (8200, 8200, True, ("cluster", 256, 2, 4, 8)),
    (65536, 65536, True, ("cluster", 256, 8, 4, 8)),
    (65544, 65544, True, ("stream", 256, 8, 0, 8)),
    (1023, 1023, True, ("small", 32, 1, 32, 1)),
    (1025, 1025, True, ("cluster", 256, 1, 16, 1)),
    (33333, 33333, True, ("stream", 256, 8, 0, 1)),
    (256, 64, False, ("small", 32, 1, 32, 1))])
def test_plan_edges(n, s, aligned, want):
    assert tuple(G.bwd_bf16_plan(n, s, aligned)) == want
