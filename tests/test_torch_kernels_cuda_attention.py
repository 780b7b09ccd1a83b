"""K6 and K4 against their plain version on a card (ATTENTION_CASES). The
checks, their tolerances and the case lists are
tests/test_torch_kernels_cuda.py's; every case is marked ``cuda`` and skips
without a CUDA device. Run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py
"""

import pytest

from test_torch_kernels_cuda import (  # noqa: F401
    ATTENTION_CASES, check_attention_kernel, dev)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("b,t,c,heads", ATTENTION_CASES)
def test_attention_kernel_matches_plain(dev, b, t, c, heads):
    check_attention_kernel(dev, b, t, c, heads)
