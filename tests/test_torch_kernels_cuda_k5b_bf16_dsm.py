"""K5b bf16 (groupnorm.cu ``gn_silu_bwd_kernel_bf16_*`` on the plan of
``choose_bwd_bf16``) against its plain twin on a card, at every GroupNorm
slab (C/G·S elements, 32 groups) of the grf U-Net at 128×128, the bf16 DSM
step's (B cut from 128 to 16: the plan depends on the slab alone, and dγ
and dβ still sum over the batch); ``test_torch_kernels_cuda_k5b_bf16_grf16.py``
holds grf16's slabs and ``..._edges.py`` the plan's edges. Marked
``cuda``; skips without a CUDA device; run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py

Gates, SiLU on and off: dx within 2e-2·max |dx| of the plain twin
(``gn_math_vjp`` on bf16: the fp32 closed form on the widened inputs, dx
rounded once) and no farther from the unrounded fp32 vjp than 1.5× the
twin's own distance plus 1e-3·max; dγ and dβ within 1e-3·max of the
float64 vjp; every output equal bit for bit on a second run (each sum in
one fixed order, no atomics)."""

import numpy as np
import pytest
import torch

from sdeflow_tpu_torch.models.common import group_count
from sdeflow_tpu_torch.ops.kernels.groupnorm import K5B, gn_math_vjp
from sdeflow_tpu_torch.ops.kernels.groupnorm import _launch_vjp as launch_k5b
from test_torch_kernels_cuda import _rand, dev  # noqa: F401

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
PLAIN_TOL, PARAM_TOL = 2e-2, 1e-3

# (C, S) of every GroupNorm of the grf U-Net at 128x128
DSM_SLABS = [(32, 4096), (32, 16384), (64, 1024), (64, 4096), (64, 16384),
             (96, 4096), (96, 16384), (128, 1024), (128, 4096), (192, 1024),
             (192, 4096), (256, 1024)]


def _rel(a, ref):
    return ((a.to(ref.dtype) - ref).abs().max() / ref.abs().max()).item()


def _same(a, b):
    if a.dtype == BF:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def check_k5b_bf16(dev, b, c, s, groups, seed, x=None, dy=None):
    """Both gates, the parameters' and a repeat, SiLU on and off."""
    rng = np.random.default_rng(seed)
    if x is None:
        x = (3.0 * _rand(rng, b, c, s) + 1.0).to(dev, BF)
        dy = _rand(rng, b, c, s).to(dev, BF)
    gamma = (1.0 + 0.5 * _rand(rng, c)).to(dev)
    beta = (0.5 * _rand(rng, c)).to(dev)
    for silu in (False, True):
        with torch.no_grad():
            before = K5B.launches
            got = launch_k5b(x, gamma, beta, groups, silu, dy)
            again = launch_k5b(x, gamma, beta, groups, silu, dy)
            torch.cuda.synchronize()
            assert K5B.launches == before + 2
            assert all(_same(u, v) for u, v in zip(got, again)), silu
            dx, dgamma, dbeta = got
            assert dx.dtype == BF and dgamma.dtype == torch.float32
            twin = gn_math_vjp(x, gamma, beta, groups, silu, dy)[0].float()
            fp32 = gn_math_vjp(x.float(), gamma, beta, groups, silu,
                               dy.float())[0]
            ref64 = gn_math_vjp(x.double(), gamma.double(), beta.double(),
                                groups, silu, dy.double())
        assert torch.isfinite(dx.float()).all()
        assert _rel(dx, twin) <= PLAIN_TOL, silu
        mine = (dx.float() - fp32).abs().max().item()
        theirs = (twin - fp32).abs().max().item()
        assert mine <= 1.5 * theirs + 1e-3 * fp32.abs().max().item(), (
            silu, mine, theirs)
        assert _rel(dgamma, ref64[1]) <= PARAM_TOL, silu
        assert _rel(dbeta, ref64[2]) <= PARAM_TOL, silu


@pytest.mark.parametrize("c,s", DSM_SLABS)
def test_k5b_bf16_at_the_dsm_slabs(dev, c, s):
    check_k5b_bf16(dev, 16, c, s, group_count(c), 21)
