"""K5 against its plain version on a card (GN_FWD_SHAPES[14:21], SiLU on and
off). The checks, their tolerances and the case lists are
tests/test_torch_kernels_cuda.py's; every case is marked ``cuda`` and skips
without a CUDA device. Run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py
"""

import pytest

from test_torch_kernels_cuda import (  # noqa: F401
    GN_FWD_SHAPES, check_groupnorm_kernel, dev)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("b,c,s,groups", GN_FWD_SHAPES[14:21])
@pytest.mark.parametrize("silu", [False, True])
def test_groupnorm_kernel_matches_plain(dev, b, c, s, groups, silu):
    check_groupnorm_kernel(dev, b, c, s, groups, silu)
