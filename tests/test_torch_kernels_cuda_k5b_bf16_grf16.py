"""K5b bf16 against its plain twin on a card at every GroupNorm slab of
grf16's U-Net, at the SSM step's batch (B = 128): the small plan's lanes
(gates as ``test_torch_kernels_cuda_k5b_bf16_dsm.py``). Marked ``cuda``;
skips without a CUDA device."""

import pytest

from sdeflow_tpu_torch.models.common import group_count
from test_torch_kernels_cuda import dev  # noqa: F401
from test_torch_kernels_cuda_k5b_bf16_dsm import check_k5b_bf16

pytestmark = pytest.mark.cuda

# (C, S) of every GroupNorm of grf16's U-Net (both routes)
GRF16_SLABS = [(32, 64), (32, 256), (64, 16), (64, 64), (64, 256), (96, 64),
               (96, 256), (128, 16), (128, 64), (192, 16), (192, 64),
               (256, 16)]


@pytest.mark.parametrize("c,s", GRF16_SLABS)
def test_k5b_bf16_at_the_grf16_slabs(dev, c, s):
    check_k5b_bf16(dev, 128, c, s, group_count(c), 22)
