"""K2 against its plain version on a card (every RK4_SHAPES case, misaligned).
The checks, their tolerances and the case lists are
tests/test_torch_kernels_cuda.py's; every case is marked ``cuda`` and skips
without a CUDA device. Run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py
"""

import pytest

from test_torch_kernels_cuda import (  # noqa: F401
    RK4_SHAPES, check_rk4_kernel, dev)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("aligned", [False])
@pytest.mark.parametrize("shape", RK4_SHAPES)
def test_rk4_kernel_matches_plain(dev, shape, aligned):
    check_rk4_kernel(dev, shape, aligned)
