"""K7a and K7b against their plain versions on a card (FLASH_CASES). The
checks, their tolerances and the case lists are
tests/test_torch_kernels_cuda.py's; every case is marked ``cuda`` and skips
without a CUDA device. Run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py
"""

import pytest

from test_torch_kernels_cuda import (  # noqa: F401
    FLASH_CASES, check_flash_pair_kernels, dev)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("b,t,c,heads", FLASH_CASES)
def test_flash_pair_kernels_match_plain(dev, b, t, c, heads):
    check_flash_pair_kernels(dev, b, t, c, heads)
