"""K1 against its plain version on a card (every CIRC_SHAPES case, aligned).
The checks, their tolerances and the case lists are
tests/test_torch_kernels_cuda.py's; every case is marked ``cuda`` and skips
without a CUDA device. Run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py
"""

import pytest

from test_torch_kernels_cuda import (  # noqa: F401
    CIRC_SHAPES, check_circulant_kernel, dev)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("aligned", [True])
@pytest.mark.parametrize("shape", CIRC_SHAPES)
def test_circulant_kernel_matches_plain(dev, shape, aligned):
    check_circulant_kernel(dev, shape, aligned)
