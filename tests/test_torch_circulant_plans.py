"""The launch plans of K1 and K2 (circulant_plan and rk4_plan, the Python
mirrors of the C choosers) at their edges, on the CPU: the warp plan from
1 to 32 floats per lane, with and without float4 loads, and the general
plans past 1,024 floats, at d not a multiple of 32 and at d = 100,000
(K2's buffers then in device memory)."""

import pytest

from sdeflow_tpu_torch.ops.kernels.circulant import (
    RowPlan, circulant_plan, rk4_layout, rk4_plan)


@pytest.mark.parametrize("b,d,aligned,k1,k2", [
    # warp plan: d % 32 == 0 up to 1,024, d/32 floats per lane, float4 where
    # d % 128 == 0 and aligned; 8 (K1) or 4 (K2) rows per block
    (1024, 256, True, ("warp", 8, 4, 8, 128), ("warp", 8, 4, 4, 256)),
    (128, 256, False, ("warp", 8, 1, 8, 16), ("warp", 8, 1, 4, 32)),
    (9, 32, True, ("warp", 1, 1, 8, 2), ("warp", 1, 1, 4, 3)),
    (7, 96, True, ("warp", 3, 1, 8, 1), ("warp", 3, 1, 4, 2)),
    (5, 128, True, ("warp", 4, 4, 8, 1), ("warp", 4, 4, 4, 2)),
    (3, 1024, True, ("warp", 32, 4, 8, 1), ("warp", 32, 4, 4, 1)),
    # general plan: one thread per element (K1), rk4_layout's rows (K2)
    (3, 1056, True, ("general", 0, 1, 0, 13), ("general", 0, 1, 1, 3)),
    (1000, 16, True, ("general", 0, 1, 0, 63), ("general", 0, 1, 16, 63)),
    (5, 33, True, ("general", 0, 1, 0, 1), ("general", 0, 1, 7, 1)),
    (2, 100_000, True, ("general", 0, 1, 0, 782), ("general", 0, 1, 1, 2)),
])
def test_plan_mirrors_at_the_edges(b, d, aligned, k1, k2):
    assert circulant_plan(b, d, aligned) == RowPlan(*k1, False)
    plan = rk4_plan(b, d, aligned)
    assert plan[:5] == k2
    if plan.kind == "general":
        assert plan[3:] == rk4_layout(b, d)
        # its buffers leave shared memory only for very wide rows
        assert plan.in_smem == (d < 100_000)
    else:
        assert plan.in_smem is False
