"""K5 bf16's plan on a card: the Python mirror ``fwd_bf16_plan`` against
the compiled ``choose_fwd_bf16``, and the kernel against its plain twin at
the plan's edges (gates as ``test_torch_kernels_cuda_k5_bf16_dsm.py``):
slabs at and just past the small plan's 1,024 elements, one block's
16,384, clusters of 2, 4 and 8, the stream plan past 8 blocks; without
16-byte loads (S % 8 ≠ 0) in the small, cluster and stream plans; a
misaligned x; one slab (B = 1, G = 1). Marked ``cuda``; skips without a
CUDA device."""

import numpy as np
import pytest
import torch

from sdeflow_tpu_torch.ops.kernels.groupnorm import (
    fwd_bf16_plan, kernel_fwd_bf16_plan)
from test_torch_kernels_cuda import _rand, dev  # noqa: F401
from test_torch_kernels_cuda_k5_bf16_dsm import check_k5_bf16

pytestmark = pytest.mark.cuda
BF = torch.bfloat16

# (B, C, S, groups) -> n = C/G·S and the plan each reaches
EDGES = [(3, 32, 1024, 32), (3, 1, 1032, 1), (2, 8, 1024, 1),
         (2, 1, 8200, 1), (2, 4, 4096, 1), (2, 1, 16392, 1),
         (1, 1, 65536, 1), (1, 1, 131072, 1), (1, 1, 131080, 1),
         (3, 5, 7, 5), (2, 3, 345, 1), (1, 1, 33333, 1), (1, 1, 4096, 1)]


@pytest.mark.parametrize("b,c,s,groups", EDGES)
def test_k5_bf16_at_the_plan_edges(dev, b, c, s, groups):
    check_k5_bf16(dev, b, c, s, groups, 33)


def test_k5_bf16_takes_misaligned_tensors(dev):
    """x 2 bytes past a 16-byte boundary: the element plan."""
    rng = np.random.default_rng(34)
    b, c, s, groups = 2, 32, 4096, 32
    buf = (3.0 * _rand(rng, b * c * s + 1) + 1.0).to(dev, BF)
    x = buf[1:].view(b, c, s)
    assert fwd_bf16_plan(c // groups * s, s, False).vec == 1
    check_k5_bf16(dev, b, c, s, groups, 34, x=x)


def test_k5_bf16_plan_mirror(dev):
    ns = [(c // g * s, s) for _, c, s, g in EDGES]
    ns += [(c // 32 * s, s) for c, s in [(32, 16384), (96, 16384),
                                         (192, 4096), (64, 16), (128, 1024)]]
    for n, s in ns:
        for aligned in (True, False):
            assert kernel_fwd_bf16_plan(n, s, aligned) == fwd_bf16_plan(
                n, s, aligned), (n, s, aligned)
