"""Shared neural-net primitives for the score networks.

Port of sdeflow_tpu/models/common.py:29-94: the NormalizeLogRadius map, the
[cos | sin] sinusoidal embedding and GroupNorm32. Activations here are
channels-first (N, C, H, W), PyTorch's convolution layout; the JAX package
is channels-last, and models/convert.py maps its weights.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sdeflow_tpu_torch.ops.kernels.groupnorm import gn_math


def normalize_log_radius(x, eps=1e-6):
    """x ↦ (x/‖x‖, log‖x‖), norms over the last axis."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps
    return x / norm, torch.log(norm)


def timestep_embedding(timesteps, dim, max_period=10000):
    """Sinusoidal embeddings, [cos | sin]; timesteps (B,) -> (B, dim) fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half)
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def group_count(channels):
    """min(32, C), lowered to the largest divisor of C that is ≤ 32."""
    groups = min(channels, 32)
    while channels % groups:
        groups -= 1
    return groups


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics over ``group_count(C)`` groups,
    optionally followed by SiLU; parameters named like flax's
    (``scale``, ``bias``)."""

    def __init__(self, channels, silu=False):
        super().__init__()
        self.groups = group_count(channels)
        self.silu = silu
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        """x (N, C, *spatial) -> same shape."""
        n, c = x.shape[:2]
        h = gn_math(x.reshape(n, c, -1).transpose(1, 2), self.scale,
                    self.bias, self.groups, self.silu)
        return h.transpose(1, 2).reshape(x.shape)
