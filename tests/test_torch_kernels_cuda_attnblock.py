"""K3 against its plain version on a card (K3_CASES and K3_EDGES). The checks,
their tolerances and the case lists are tests/test_torch_kernels_cuda.py's;
every case is marked ``cuda`` and skips without a CUDA device. Run with the
rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py
"""

import pytest

from test_torch_kernels_cuda import (  # noqa: F401
    K3_CASES, K3_EDGES, check_attention_block_kernel, dev)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("b,t,c,heads", K3_CASES)
def test_attention_block_kernel_matches_plain(dev, b, t, c, heads):
    check_attention_block_kernel(dev, b, t, c, heads)


@pytest.mark.parametrize("b,t,c,heads", K3_EDGES)
def test_attention_block_kernel_edges(dev, b, t, c, heads):
    check_attention_block_kernel(dev, b, t, c, heads)
