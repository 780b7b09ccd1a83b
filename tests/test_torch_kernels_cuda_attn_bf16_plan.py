"""K3 bf16's launch plan against the C entry's own check, on a card:
``attn_block_bf16`` refuses (cudaErrorInvalidValue) a shared-memory size
other than its own ``bf::Dims::smem``, and a plan it does not take, before
it launches. At the plan's edges (the widest C the previous bf16 design
took at several T, the T = 256 multi-head blocks, every choice of chunk,
residency, x buffers and warpgroups), the size that ``block_plan(...,
torch.bfloat16)`` and ``_smem_bytes_bf16`` give is taken and the kernel
runs, finite; the same size ± 1,024 bytes is refused; and the plan with
one warpgroup more than the kernel's registers allow is refused. Marked
``cuda``; skips without a CUDA device (tests/test_torch_attn_bf16_plan.py
holds the same mirror to the source on the CPU)."""

import ctypes
import math

import pytest
import torch

from sdeflow_tpu_torch.ops.kernels import attnblock as ab
from sdeflow_tpu_torch.ops.kernels import common
from test_torch_kernels_cuda import dev  # noqa: F401

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
INVALID = 1  # cudaErrorInvalidValue

# (T, C, groups, heads): grf16's two shapes; the T = 256 blocks with 8
# heads; streamed weights at the widest C of T = 1, 16, 33 and 128 and of
# T = 256 with one head (chunk 16); chunk 16 with three heads at T = 100;
# 9 samples a unit at T = 7; 3 at T = 17
EDGES = [(64, 64, 32, 1), (16, 128, 32, 1), (256, 32, 32, 8),
         (256, 64, 32, 8), (1, 1232, 28, 1), (16, 1016, 8, 1),
         (33, 449, 1, 1), (128, 144, 144, 1), (256, 71, 71, 1),
         (100, 96, 32, 3), (7, 24, 24, 3), (17, 32, 32, 4)]


def _call(dev, t, c, groups, heads, plan, smem):
    x = torch.randn(1, t, c, device=dev).to(BF)
    out = torch.empty_like(x)
    vecs = [torch.ones(c, device=dev), torch.zeros(c, device=dev)]
    wqkv = torch.randn(c, 3 * c, device=dev) / c**0.5
    bqkv = torch.zeros(3 * c, device=dev)
    wproj = torch.randn(c, c, device=dev) / c**0.5
    bproj = torch.zeros(c, device=dev)
    scale = float(torch.tensor(1.0 / math.sqrt(math.sqrt(c // heads)),
                               dtype=BF))
    lib = ab.K3.lib()
    rc = lib.attn_block_bf16(
        *map(common.ptr, (x, *vecs, wqkv, bqkv, wproj, bproj, out)), 1, t, c,
        groups, heads, *plan, smem, ctypes.c_float(scale),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    return rc, out


@pytest.mark.parametrize("t,c,groups,heads", EDGES)
def test_bf16_smem_mirror_matches_the_entry(dev, t, c, groups, heads):
    plan = ab.block_plan(t, c, groups, heads, BF)
    assert plan is not None
    smem = ab._smem_bytes_bf16(t, c, groups, heads, plan)
    rc, out = _call(dev, t, c, groups, heads, plan, smem)
    assert rc == 0 and torch.isfinite(out.float()).all()
    for off in (-1024, 1024):
        assert _call(dev, t, c, groups, heads, plan, smem + off)[0] == INVALID
    keys = ab._bf16_dims(t, c, heads, plan.samples, plan.chunk)[3]
    more = plan._replace(warpgroups=ab._bf16_max_warpgroups(keys) + 1)
    assert _call(dev, t, c, groups, heads, more,
                 ab._smem_bytes_bf16(t, c, groups, heads, more))[0] == INVALID
