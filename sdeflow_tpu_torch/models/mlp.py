"""MLP score network over flat (B, d) states.

Port of sdeflow_tpu/models/mlp.py:19-50: three Dense(hidden) layers with
swish, then ``dense_out``; the input is concat(x, t) or, with the
NormalizeLogRadius premodule, concat(x/‖x‖, log‖x‖, t). ``dtype`` is the
compute dtype (float32 or bfloat16, parameters fp32); the output head runs
in fp32 (the JAX default ``fp32_head``, which no preset turns off). Layers
carry flax's names, so models/convert.py maps a flax tree unchanged.
Plain products: the JAX MLP reaches no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sdeflow_tpu_torch.models.common import dense, normalize_log_radius


class MLP(nn.Module):
    """net(x: (B, d), t: (B,)) -> (B, d) fp32."""

    def __init__(self, input_dim: int = 2, hidden_dim: int = 128,
                 premodule: Optional[str] = None, dtype=torch.float32):
        super().__init__()
        if premodule not in (None, "NormalizeLogRadius"):
            raise ValueError(f"unknown premodule {premodule!r}")
        self.input_dim = input_dim
        self.premodule = premodule
        self.compute_dtype = dtype
        width = input_dim + (premodule is not None) + 1  # the time
        for i in range(3):
            self.add_module(f"dense{i}", dense(width, hidden_dim, dtype))
            width = hidden_dim
        self.dense_out = dense(hidden_dim, input_dim, torch.float32)

    def forward(self, x, t):
        sz = x.shape
        x = x.reshape(-1, self.input_dim)
        t = t.reshape(-1, 1).to(x.dtype)
        if self.premodule == "NormalizeLogRadius":
            h, log_norm = normalize_log_radius(x)
            x = torch.cat([h, log_norm], dim=-1)
        h = torch.cat([x, t], dim=1).to(self.compute_dtype)
        for i in range(3):
            h = F.silu(getattr(self, f"dense{i}")(h))
        return self.dense_out(h).to(torch.float32).reshape(sz)
