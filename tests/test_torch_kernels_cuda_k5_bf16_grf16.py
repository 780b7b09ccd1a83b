"""K5 bf16 against its plain twin on a card at every GroupNorm slab of
grf16's U-Net, SiLU on and off, at the production request's batch
(B = 1024) and the bf16 SSM step's (B = 128): the small plan's 8, 16 and
32 lanes a slab (gates as ``test_torch_kernels_cuda_k5_bf16_dsm.py``).
Marked ``cuda``; skips without a CUDA device."""

import pytest

from sdeflow_tpu_torch.models.common import group_count
from test_torch_kernels_cuda import dev  # noqa: F401
from test_torch_kernels_cuda_k5_bf16_dsm import check_k5_bf16
from test_torch_kernels_cuda_k5b_bf16_grf16 import GRF16_SLABS

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("c,s", GRF16_SLABS)
def test_k5_bf16_at_the_grf16_slabs(dev, c, s):
    for b in (1024, 128):
        check_k5_bf16(dev, b, c, s, group_count(c), 32)
