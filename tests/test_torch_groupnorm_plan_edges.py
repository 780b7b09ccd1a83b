"""The launch plans' edges of K5 and K5b (groupnorm.launch_plan, the
Python mirror of the C function ``choose``), on the CPU: slabs just below
and above each threshold of the lanes per slab, the vectors per lane, the
cluster size and the stream plan, S % 4 != 0 and an unaligned tensor."""

import pytest

from sdeflow_tpu_torch.ops.kernels.groupnorm import launch_plan


@pytest.mark.parametrize("n,s,aligned,want", [
    (32, 32, True, ("small", 8, 1, 1, 4)),
    (36, 36, True, ("small", 16, 1, 1, 4)),
    (68, 68, True, ("small", 32, 1, 1, 4)),
    (132, 132, True, ("small", 32, 1, 2, 4)),
    (1024, 1024, True, ("small", 32, 1, 8, 4)),
    (1028, 1028, True, ("cluster", 256, 2, 1, 4)),
    (8196, 8196, True, ("cluster", 256, 4, 4, 4)),
    (16388, 16388, True, ("cluster", 256, 8, 4, 4)),
    (65536, 65536, True, ("cluster", 256, 8, 8, 4)),
    (65540, 65540, True, ("stream", 256, 8, 0, 4)),
    (7, 7, True, ("small", 32, 1, 1, 1)),
    (1023, 1023, True, ("small", 32, 1, 32, 1)),
    (1025, 1025, True, ("cluster", 256, 2, 16, 1)),
    (33333, 33333, True, ("stream", 256, 8, 0, 1)),
    (256, 64, False, ("small", 32, 1, 32, 1))])
def test_launch_plan_edges(n, s, aligned, want):
    assert tuple(launch_plan(n, s, aligned)) == want
