"""K6's short and tiled designs at their edges on a card (SHORT_T at
HEAD_WIDTHS[0:2]). The checks, their tolerances and the case lists are
tests/test_torch_kernels_cuda.py's; every case is marked ``cuda`` and skips
without a CUDA device. Run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py
"""

import pytest

from test_torch_kernels_cuda import (  # noqa: F401
    HEAD_WIDTHS, SHORT_T, check_attention_kernel_edges, dev)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("t", SHORT_T)
@pytest.mark.parametrize("heads,ch", HEAD_WIDTHS[0:2])
def test_attention_kernel_short_and_tiled_edges(dev, t, heads, ch):
    check_attention_kernel_edges(dev, t, heads, ch)
