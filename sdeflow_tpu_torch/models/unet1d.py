"""1D convolutional U-Net score net over flat (B, d) signals (d ~ 100–1000).

Port of sdeflow_tpu/models/unet1d.py:20-113: a GELU TimeMLP embedding of
the raw t, plus, with the NormalizeLogRadius premodule, a GELU TimeMLP
embedding of log‖x‖ (the input then x/‖x‖·√L); an encoder of ConvBlock1D
and stride-2 convolutions, a middle ConvBlock1D, and a decoder of stride-2
transposed convolutions and ConvBlock1D on [h, skip], with the time
embedding concatenated as channels at every position of every block's
input; a 1×1 output convolution in fp32. The JAX module is channels-last
(B, L, C); this one is channels-first (B, C, L), and models/convert.py maps
its weights, flipping the transposed convolutions' kernels (flax's
``nn.ConvTranspose`` does not flip them, ``nn.ConvTranspose1d`` does).
``dtype`` is the compute dtype (float32 or bfloat16, parameters fp32); the
norms of the premodule and the output head stay fp32. GELU is the tanh
form, flax's ``nn.gelu``. Plain cuDNN convolutions: the JAX UNet1D reaches
no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sdeflow_tpu_torch.models.common import (
    TimeMLP, _lecun_normal_, cast, normalize_log_radius)
from sdeflow_tpu_torch.models.unet2d import _conv


class ConvTranspose1d(nn.ConvTranspose1d):
    """nn.ConvTranspose1d computing in ``compute_dtype`` (its input and its
    fp32 parameters cast at each call), initialized as flax's
    ``nn.ConvTranspose``: lecun_normal over kernel size × input channels,
    zero bias."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        with torch.no_grad():
            _lecun_normal_(self.weight,
                           self.in_channels * self.kernel_size[0])
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose1d(
            cast(x, dt), cast(self.weight, dt), cast(self.bias, dt),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)


class ConvBlock1D(nn.Module):
    """[3-tap convolution → GELU] × 2."""

    def __init__(self, in_ch, out_ch, dtype=torch.float32):
        super().__init__()
        self.conv0 = _conv(1, in_ch, out_ch, 3, padding=1, dtype=dtype)
        self.conv1 = _conv(1, out_ch, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, x):
        x = F.gelu(self.conv0(x), approximate="tanh")
        return F.gelu(self.conv1(x), approximate="tanh")


class UNet1D(nn.Module):
    """net(x: (B, L) or (B, L, 1), t: (B,) or (B, 1)) -> (B, L) fp32."""

    def __init__(self, input_dim: int, base_channels: int = 32,
                 channel_mults: Tuple[int, ...] = (1, 2, 4),
                 premodule: Optional[str] = None, emb_dim: int = 128,
                 dtype=torch.float32):
        super().__init__()
        if premodule not in (None, "NormalizeLogRadius"):
            raise ValueError(f"unknown premodule {premodule!r}")
        self.input_dim = input_dim
        self.premodule = premodule
        self.compute_dtype = dtype
        self.time_mlp = TimeMLP(1, emb_dim, act="gelu", dtype=dtype)
        if premodule == "NormalizeLogRadius":
            self.scale_embed = TimeMLP(1, emb_dim, act="gelu", dtype=dtype)
        chs = [base_channels * m for m in channel_mults]
        self.depth = len(chs)
        cin = 1
        for i, ch in enumerate(chs):
            self.add_module(f"enc{i}", ConvBlock1D(cin + emb_dim, ch, dtype))
            self.add_module(f"down{i}", _conv(1, ch, ch, 4, stride=2,
                                              padding=1, dtype=dtype))
            cin = ch
        self.middle = ConvBlock1D(chs[-1] + emb_dim, chs[-1], dtype)
        for i, ch in enumerate(reversed(chs)):
            self.add_module(f"up{i}", ConvTranspose1d(
                cin, ch, 4, stride=2, padding=1, compute_dtype=dtype))
            self.add_module(f"dec{i}", ConvBlock1D(2 * ch + emb_dim, ch,
                                                   dtype))
            cin = ch
        self.final = _conv(1, chs[0], 1, 1)

    def forward(self, x, t):
        if x.ndim == 3:
            x = x[..., 0]
        t = t.reshape(-1, 1).to(torch.float32)
        t_emb = self.time_mlp(t)  # (B, E)
        if self.premodule == "NormalizeLogRadius":
            x, log_norm = normalize_log_radius(x)
            x = x * math.sqrt(x.shape[-1])
            t_emb = t_emb + self.scale_embed(log_norm)
        h = cast(x, self.compute_dtype)[:, None, :]  # (B, 1, L)

        def with_emb(h):  # the embedding as channels at every position
            e = t_emb[:, :, None].expand(-1, -1, h.shape[-1])
            return torch.cat([h, e], dim=1)

        skips = []
        for i in range(self.depth):
            h = getattr(self, f"enc{i}")(with_emb(h))
            skips.append(h)
            h = getattr(self, f"down{i}")(h)
        h = self.middle(with_emb(h))
        for i in range(self.depth):
            h = getattr(self, f"up{i}")(h)
            skip = skips.pop()
            if h.shape[-1] != skip.shape[-1]:  # odd lengths
                h = F.pad(h, (0, skip.shape[-1] - h.shape[-1]))
            h = getattr(self, f"dec{i}")(with_emb(torch.cat([h, skip], 1)))
        return self.final(h)[:, 0]  # the fp32 head
