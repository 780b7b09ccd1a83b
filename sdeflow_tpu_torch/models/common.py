"""Shared neural-net primitives for the score networks.

Port of sdeflow_tpu/models/common.py:29-110: the NormalizeLogRadius map, the
[cos | sin] sinusoidal embedding, ``mean_flat``, GroupNorm32 and the
two-layer TimeMLP; and what flax gives every layer: its default init
(``flax_init_``: lecun_normal kernels, zero biases; ``zero_init_`` for the
zero-initialized layers) and its ``dtype=`` compute casts (``Linear``).
Activations of the convolutional nets are channels-first (N, C, H, W),
PyTorch's convolution layout; the JAX package is channels-last, and
models/convert.py maps its weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sdeflow_tpu_torch.ops.kernels.groupnorm import group_norm_silu


def normalize_log_radius(x, eps=1e-6):
    """x ↦ (x/‖x‖, log‖x‖), norms over the last axis."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps
    return x / norm, torch.log(norm)


def mean_flat(tensor):
    """Mean over every non-batch dimension."""
    return tensor.mean(dim=tuple(range(1, tensor.ndim)))


def _lecun_normal_(weight, fan_in):
    """flax's default kernel init, lecun_normal: a normal truncated at ±2σ,
    scaled to variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def flax_init_(module):
    """A Conv2d or Linear initialized as flax's nn.Conv and nn.Dense are:
    lecun_normal over the weight's fan-in (input channels × kernel size)
    and zero bias; returns the module."""
    with torch.no_grad():
        _lecun_normal_(module.weight, module.weight[0].numel())
        if module.bias is not None:
            nn.init.zeros_(module.bias)
    return module


def zero_init_(module):
    """Every parameter of `module` set to zero (flax's ``zero_init()``
    kernel and bias initializers); returns the module."""
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


def cast(t, dtype):
    """t in `dtype`: t itself where it already is (no cast in a traced
    program), else ``t.to(dtype)``."""
    return t if t.dtype == dtype else t.to(dtype)


class Linear(nn.Linear):
    """nn.Linear computing in ``compute_dtype`` (flax's ``nn.Dense`` with
    ``dtype=``): its input and its fp32 parameters are cast at each call."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight, dt),
                        cast(self.bias, dt))


def dense(in_features, features, dtype=torch.float32, zero=False):
    """flax's ``nn.Dense(features, dtype=dtype)`` on `in_features` inputs,
    with flax's init (zero with `zero`)."""
    layer = Linear(in_features, features, compute_dtype=dtype)
    return zero_init_(layer) if zero else flax_init_(layer)


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
    optionally followed by SiLU, as kernel K5 (ops/kernels/groupnorm.py);
    parameters named like flax's (``scale``, ``bias``)."""

    def __init__(self, channels, silu=False):
        super().__init__()
        self.groups = group_count(channels)
        self.silu = silu
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        """x (N, C, *spatial) -> same shape."""
        n, c = x.shape[:2]
        return group_norm_silu(x.reshape(n, c, -1), self.scale, self.bias,
                               self.groups, self.silu).reshape(x.shape)


class TimeMLP(nn.Module):
    """The two-layer time/scale embedding MLP: Dense → act → Dense, each
    of width emb_dim in ``dtype``; act "silu" or "gelu" (flax's nn.gelu,
    the tanh form)."""

    def __init__(self, in_features, emb_dim, act="silu", dtype=torch.float32):
        super().__init__()
        if act not in ("silu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.dense0 = dense(in_features, emb_dim, dtype)
        self.dense1 = dense(emb_dim, emb_dim, dtype)

    def forward(self, h):
        h = self.dense0(h)
        h = F.silu(h) if self.act == "silu" else F.gelu(h, approximate="tanh")
        return self.dense1(h)
