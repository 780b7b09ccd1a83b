"""GroupNorm(+SiLU), plain fp32 version.

Port of ``_gn_math``'s fp32 branch (sdeflow_tpu/ops/pallas/groupnorm.py:
36-75): statistics over (S, C/G) per group, eps 1e-5, two-pass variance.
The JAX package's GroupNorm kernel (K5, ``_gn_pallas`` :111-136) is opt-in
there and not ported yet (ROADMAP Queue 2); the bf16 branch comes with
bf16 compute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


def gn_math(x, gamma, beta, groups, silu):
    """x (B, S, C) channels-last, gamma/beta (C,); fp32 only."""
    if x.dtype != torch.float32:
        raise NotImplementedError(
            "GroupNorm runs in float32 only (bf16: ROADMAP Queue 1 item 8)")
    b, s, c = x.shape
    xg = x.reshape(b, s, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    h = (xg - mean) * torch.rsqrt(var + EPS)
    h = h.reshape(b, s, c) * gamma + beta
    if silu:
        h = F.silu(h)
    return h
