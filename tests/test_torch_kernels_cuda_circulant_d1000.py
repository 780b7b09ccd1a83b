"""K1, K2 and K2's solve at lorenz63_unet1d's width, d = 1000 (d % 32 != 0:
each takes its general plan), on a card: K1 and K2 at the SSM step's
batch (32) and a request's (1,024), aligned and 4 bytes past a 16-byte
boundary, bit for bit against their plain versions; the 16-step solve at
batches 32 and 256 with mixed, zero and full select counts, bit for bit
against a loop of K2 steps. The checks and their tolerances are
tests/test_torch_kernels_cuda.py's; every case is marked ``cuda`` and
skips without a CUDA device. Run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py
"""

import pytest

from test_torch_kernels_cuda import (  # noqa: F401
    check_circulant_kernel, check_rk4_kernel,
    check_solve_against_the_step_loop, dev)

pytestmark = pytest.mark.cuda
SHAPES = [(32, 1000), (1024, 1000)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_circulant_kernel_matches_plain(dev, shape, aligned):
    check_circulant_kernel(dev, shape, aligned)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_rk4_kernel_matches_plain(dev, shape, aligned):
    check_rk4_kernel(dev, shape, aligned)


@pytest.mark.parametrize("kind", ["mixed", "zeros", "full"])
@pytest.mark.parametrize("n,b,d", [(16, 32, 1000), (16, 256, 1000)])
def test_solve_equals_the_per_step_kernel_loop(dev, n, b, d, kind):
    check_solve_against_the_step_loop(dev, n, b, d, kind)
