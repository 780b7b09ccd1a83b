"""2D-image score net over the flat (B, d) API: the VorticityUNet wrapper.

Port of sdeflow_tpu/models/vorticity.py:24-159 for the serve path: the
``net(x: (B, d), t: (B,)) -> (B, d)`` call over a UNetModel, with flat↔image
reshapes in C or F order, the /5 value rescale, and the optional
NormalizeLogRadius premodule whose log‖x‖ is sinusoidally embedded and added
to the time embedding. ``flat_to_img`` and ``img_to_flat`` keep the JAX
package's channels-last (B, H, W, 1) images; the U-Net runs channels-first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.nn.functional as F
from torch import nn

from sdeflow_tpu_torch.models.common import (
    normalize_log_radius, timestep_embedding)
from sdeflow_tpu_torch.models.unet2d import UNetModel

SCALE_IMAGE = 5.0


def flat_to_img(x, H, W, order="C"):
    """(B, d=H·W) -> (B, H, W, 1), rescaled by 1/5. Order "F": the flat
    vector is column-major."""
    B, d = x.shape
    if d != H * W:
        raise ValueError(f"Expected d={H * W}, got {d}")
    x = x / SCALE_IMAGE
    img = x.reshape(B, H, W) if order == "C" else x.reshape(B, W, H).transpose(1, 2)
    return img[..., None]


def img_to_flat(y, order="C"):
    """(B, H, W, 1) -> (B, H·W), rescaled by 5."""
    B, H, W, C = y.shape
    if C != 1:
        raise ValueError(f"Expected 1 channel, got {C}")
    y = SCALE_IMAGE * y[..., 0]
    if order == "C":
        return y.reshape(B, H * W)
    return y.transpose(1, 2).reshape(B, H * W)


class VorticityUNet(nn.Module):
    """Flat-vector wrapper around the attention U-Net.

    premodule: None (raw x, time-only conditioning) or "NormalizeLogRadius"
    (x/‖x‖·√d, time + log‖x‖ conditioning). attention_impl: the
    AttentionBlocks' route, "auto" or "unfused" (models/unet2d.py)."""

    def __init__(self, base_channels: int = 32,
                 channel_mults: Tuple[int, ...] = (1, 2, 4),
                 num_res_blocks: int = 2, premodule: Optional[str] = None,
                 in_space: int = 16,
                 attention_resolutions: Tuple[int, ...] = (2, 4),
                 conv_resample: bool = True, num_heads: int = 1,
                 use_checkpoint: bool = False, learn_potential: bool = False,
                 flatten_order: str = "C", attention_impl: str = "auto"):
        super().__init__()
        if premodule not in (None, "NormalizeLogRadius"):
            raise ValueError(f"unknown premodule {premodule!r}")
        if flatten_order not in ("C", "F"):
            raise ValueError(f"unknown flatten_order {flatten_order!r}")
        self.premodule = premodule
        self.in_space = in_space
        self.base_channels = base_channels
        self.flatten_order = flatten_order
        if premodule == "NormalizeLogRadius":
            temb = base_channels * 4
            self.scale_embed_0 = nn.Linear(base_channels, temb)
            self.scale_embed_1 = nn.Linear(temb, temb)
        self.core = UNetModel(
            in_channels=1, model_channels=base_channels, out_channels=1,
            in_space=in_space, num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions,
            channel_mult=tuple(channel_mults), conv_resample=conv_resample,
            num_heads=num_heads, use_checkpoint=use_checkpoint,
            learn_potential=learn_potential, attention_impl=attention_impl)

    def forward(self, x, t):
        """x: (B, d=H·W); t: (B,) or (B, 1) -> (B, d)."""
        t = t.reshape(-1)
        extra_emb = None
        if self.premodule == "NormalizeLogRadius":
            x, log_norm = normalize_log_radius(x)
            x = x * float(x.shape[-1]) ** 0.5
            emb_in = timestep_embedding(log_norm.reshape(-1),
                                        self.base_channels)
            extra_emb = self.scale_embed_1(F.silu(self.scale_embed_0(emb_in)))
        img = flat_to_img(x, self.in_space, self.in_space,
                          order=self.flatten_order)
        y = self.core(img.permute(0, 3, 1, 2), t, extra_emb=extra_emb)
        return img_to_flat(y.permute(0, 2, 3, 1), order=self.flatten_order)
