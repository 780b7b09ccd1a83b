"""The Python mirror of the launch plan of K5 and K5b at every GroupNorm
shape of grf16's U-Net (slabs of up to 1,024 floats, lane groups):
the plan each takes, held to PATH_PLANS by check_path_plan
(tests/test_torch_groupnorm_bwd.py)."""

import pytest

from sdeflow_tpu_torch.models.common import group_count
from test_torch_groupnorm_bwd import PATH_PLANS, SMALL_MAX, check_path_plan

SHAPES = [(c, s) for c, s in sorted(PATH_PLANS)
          if c // group_count(c) * s <= SMALL_MAX]


@pytest.mark.parametrize("c,s", SHAPES)
def test_launch_plan_at_the_paths_shapes(c, s):
    check_path_plan(c, s)
