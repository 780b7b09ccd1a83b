"""K3's launch plan (``attnblock.block_plan``) on the CPU: found, and
within one block's 232,448 bytes of shared memory, at every
(T, C, groups, heads) that the CUDA-core design K3 replaced took (T ≤ 256,
heads 1–8), and at none that it did not, so that no "auto" AttentionBlock
changes route; the GroupNorm's channel sums fit the weight ring below
mode 2. The CUDA-core design's shapes are tests/test_torch_attn_tc.py's
``_cuda_core_query_chunk``."""

import pytest

from sdeflow_tpu_torch.ops.kernels import attnblock as K3
from test_torch_attn_tc import SMEM_LIMIT, _cuda_core_query_chunk


@pytest.mark.parametrize("t", [1, 3, 4, 7, 8, 15, 16, 17, 32, 49, 64, 100,
                               128, 255, 256])
def test_k3_plans_every_shape_the_cuda_core_kernel_took(t):
    ring = K3._STAGES * K3._KC * (K3._NC + K3._PAD_W)
    seen = 0
    for c in range(1, 12_000):
        small = [g for g in range(1, 33) if c % g == 0]
        for groups in {1, max(small), c}:
            took = _cuda_core_query_chunk(t, c, groups) is not None
            for heads in [h for h in range(1, K3.MAX_HEADS + 1) if c % h == 0]:
                plan = K3.block_plan(t, c, groups, heads)
                assert (plan is not None) == took, (t, c, groups, heads)
                if plan is None:
                    continue
                seen += 1
                samples, mode = plan
                assert K3.smem_bytes(t, c, groups, heads, samples,
                                     mode) <= SMEM_LIMIT
                # the GroupNorm's channel sums fit the ring below mode 2
                assert mode == 2 or samples * c <= ring
        if _cuda_core_query_chunk(t, c, 1) is None:
            break  # wider C does not fit either
    assert seen > 100
