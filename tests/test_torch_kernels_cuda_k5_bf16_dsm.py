"""K5 bf16 (groupnorm.cu ``gn_silu_kernel_bf16_*`` on the plan of
``choose_fwd_bf16``) against its plain twin on a card, at every (C, S,
SiLU) of the bf16 DSM step's GroupNorm mix (the grf U-Net at 128×128,
32 groups) at its batch, B = 128: one block a slab up to 16,384 elements
and clusters of 2 and 4 blocks above; ``test_torch_kernels_cuda_k5_bf16_grf16.py``
holds grf16's slabs and ``..._edges.py`` the plan's edges. Marked
``cuda``; skips without a CUDA device; run with the rest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda*.py

Gates: within 1.6e-2·max |twin| of the plain twin (``gn_math`` on bf16,
two bf16 ulps: the kernel's sums run in another order, so mean and rstd
differ in their last fp32 bits and a rounding to bf16 may fall the other
way) and no farther from the fp32 plain version on the widened input than
1.5× the twin's own distance plus 1e-3·max; equal bit for bit on a second
run (each sum in one fixed order)."""

import numpy as np
import pytest
import torch

from sdeflow_tpu_torch.models.common import group_count
from sdeflow_tpu_torch.ops.kernels.groupnorm import K5, gn_math
from sdeflow_tpu_torch.ops.kernels.groupnorm import _launch as launch_k5
from test_torch_kernels_cuda import _rand, dev  # noqa: F401

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
K5_BF16_TOL = 1.6e-2

# (C, S, silu) of every GroupNorm of the grf U-Net at 128x128 (SGM_GN_MIX)
DSM_MIX = [(32, 4096, True), (32, 16384, True), (64, 1024, True),
           (64, 4096, False), (64, 4096, True), (64, 16384, True),
           (96, 4096, True), (96, 16384, True), (128, 1024, False),
           (128, 1024, True), (128, 4096, True), (192, 1024, True),
           (192, 4096, True), (256, 1024, True)]


def _same(a, b):
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def check_k5_bf16(dev, b, c, s, groups, seed, silus=(False, True), x=None):
    """Both gates and a repeat."""
    rng = np.random.default_rng(seed)
    if x is None:
        x = (3.0 * _rand(rng, b, c, s) + 1.0).to(dev, BF)
    gamma = (1.0 + 0.5 * _rand(rng, c)).to(dev)
    beta = (0.5 * _rand(rng, c)).to(dev)
    for silu in silus:
        with torch.no_grad():
            before = K5.launches
            out = launch_k5(x, gamma, beta, groups, silu)
            again = launch_k5(x, gamma, beta, groups, silu)
            torch.cuda.synchronize()
            assert K5.launches == before + 2
            assert out.dtype == BF and _same(out, again), silu
            twin = gn_math(x, gamma, beta, groups, silu).float()
            fp32 = gn_math(x.float(), gamma, beta, groups, silu)
        got = out.float()
        assert torch.isfinite(got).all()
        assert ((got - twin).abs().max()
                <= K5_BF16_TOL * twin.abs().max()), silu
        mine = (got - fp32).abs().max().item()
        theirs = (twin - fp32).abs().max().item()
        assert mine <= 1.5 * theirs + 1e-3 * fp32.abs().max().item(), (
            silu, mine, theirs)
        del out, again, twin, fp32, got


@pytest.mark.parametrize("c,s,silu", DSM_MIX)
def test_k5_bf16_at_the_dsm_mix(dev, c, s, silu):
    check_k5_bf16(dev, 128, c, s, group_count(c), 31, (silu,))
    torch.cuda.empty_cache()


def test_k5_bf16_silu_at_every_bf16_input(dev):
    """Every bf16 value x of magnitude below 128 (±0 and the subnormals
    among them) through K5 bf16 with scale 1 and shift 0: one slab of ±x
    pairs, whose sums return to 0 after each pair in any thread's order,
    so the mean is 0, and γ = sqrt(var + eps), so bf16(rstd·γ) = 1. The
    output is PyTorch's x·1 + 0 in bf16 without SiLU and, with it, h·σ(h)
    bit for bit at every h, the plain version's SiLU (the kernel's fast
    sigmoid rounds as PyTorch's accurate one; __fdividef's reciprocal,
    which gives 0 past 2^126, did not at three h near -87.5)."""
    pos = torch.arange(0, 0x4300, dtype=torch.int32)  # bf16 bits, 0 ≤ x < 128
    pairs = torch.stack([pos, pos - 0x8000], dim=1).reshape(-1)  # +x, -x
    x = pairs.to(torch.int16).view(BF).to(dev).view(1, 1, -1)
    var = (x.double() ** 2).mean().item()
    gamma = torch.tensor([(var + 1e-5) ** 0.5], dtype=torch.float32,
                         device=dev)
    beta = torch.zeros(1, device=dev)
    one, zero = (torch.tensor(v, dtype=BF, device=dev) for v in (1.0, 0.0))
    h = x * one + zero
    with torch.no_grad():
        for silu, want in ((False, h), (True, h * torch.sigmoid(h))):
            got = launch_k5(x, gamma, beta, 1, silu)
            bad = (got.view(torch.int16) != want.view(torch.int16)).nonzero()
            assert bad.numel() == 0, (silu, len(bad), [
                (h.flatten()[i].item(), got.flatten()[i].item(),
                 want.flatten()[i].item()) for i in bad[:5, 2].tolist()])
