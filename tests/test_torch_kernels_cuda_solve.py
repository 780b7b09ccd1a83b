"""K2's solve against a loop of K2 steps on a card (SOLVE_CASES, each with
mixed, zero and full select counts). The checks, their tolerances and the
case lists are tests/test_torch_kernels_cuda.py's; every case is marked
``cuda`` and skips without a CUDA device. Run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py
"""

import pytest

from test_torch_kernels_cuda import (  # noqa: F401
    SOLVE_CASES, check_solve_against_the_step_loop, dev)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("kind", ["mixed", "zeros", "full"])
@pytest.mark.parametrize("n,b,d", SOLVE_CASES)
def test_solve_equals_the_per_step_kernel_loop(dev, n, b, d, kind):
    check_solve_against_the_step_loop(dev, n, b, d, kind)
