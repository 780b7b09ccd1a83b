"""ADM-style 2D U-Net with attention and timestep embedding.

Port of sdeflow_tpu/models/unet2d.py for the serve path: 2D, no class
labels, no learned potential, no checkpointing, fp32. Activations are
channels-first (N, C, H, W). Submodules and parameters carry the flax names
(``down_res0.in_conv``, ``mid_attn.qkv.kernel``, ...) so that
models/convert.py maps a flax tree by name. Every GroupNorm is kernel K5
(ops/kernels/groupnorm.py). An AttentionBlock on the ``"auto"`` route with
at most 8 heads, whose shape kernel K3 takes (``block_plan``: T ≤ 256 and
a working set that fits one block's shared memory), is K3
(ops/kernels/attnblock.py);
otherwise it runs the unfused composition with the attention core
K6/K4, or K7a/K7b under autograd above T = 1024
(ops/kernels/attention.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sdeflow_tpu_torch.models.common import (
    GroupNorm32, timestep_embedding)
from sdeflow_tpu_torch.ops.kernels.attention import attention_core
from sdeflow_tpu_torch.ops.kernels.attnblock import (
    MAX_HEADS, block_plan, fused_attention_block)


def _conv3(cin, cout, stride=1, bias=True):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


def _zero_(module):
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


class Upsample(nn.Module):
    """Nearest-neighbour ×2, then a 3×3 conv; crops the last row and column
    when the target size is odd."""

    def __init__(self, channels, use_conv, odd_size=False):
        super().__init__()
        self.odd_size = odd_size
        if use_conv:
            self.conv = _conv3(channels, channels)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        if hasattr(self, "conv"):
            x = self.conv(x)
        if self.odd_size:
            x = x[:, :, :-1, :-1]
        return x


class Downsample(nn.Module):
    """Stride-2 3×3 conv with padding 1, or 2×2 average pooling."""

    def __init__(self, channels, use_conv):
        super().__init__()
        if use_conv:
            self.op = _conv3(channels, channels, stride=2)

    def forward(self, x):
        if hasattr(self, "op"):
            return self.op(x)
        return F.avg_pool2d(x, 2)


class ResBlock(nn.Module):
    """Residual block conditioned on a timestep embedding."""

    def __init__(self, channels, emb_channels, out_channels=None,
                 use_conv=False, no_bias_last_layer=False):
        super().__init__()
        out_ch = out_channels or channels
        self.in_norm = GroupNorm32(channels, silu=True)
        self.in_conv = _conv3(channels, out_ch)
        self.emb_dense = nn.Linear(emb_channels, out_ch)
        self.out_norm = GroupNorm32(out_ch, silu=True)
        self.out_conv = _zero_(_conv3(out_ch, out_ch,
                                      bias=not no_bias_last_layer))
        if out_ch != channels:
            self.skip_conv = (
                _conv3(channels, out_ch) if use_conv else
                nn.Conv2d(channels, out_ch, 1, bias=not no_bias_last_layer))

    def forward(self, x, emb):
        h = self.in_conv(self.in_norm(x))
        h = h + self.emb_dense(F.silu(emb))[:, :, None, None]
        h = self.out_conv(self.out_norm(h))
        skip = self.skip_conv(x) if hasattr(self, "skip_conv") else x
        return skip + h


class DenseParams(nn.Module):
    """Dense parameters kept in flax's (in, out) layout, which kernel K3
    reads directly and the unfused route multiplies by."""

    def __init__(self, in_features, features, zero=False):
        super().__init__()
        kernel = torch.empty(in_features, features)
        if zero:
            nn.init.zeros_(kernel)
        else:  # flax's lecun_normal: normal truncated at ±2σ, variance 1/in
            std = (1.0 / in_features) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(kernel, std=std, a=-2 * std, b=2 * std)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(features))


class AttentionBlock(nn.Module):
    """Spatial self-attention over the flattened feature map: GroupNorm →
    qkv → attention → proj → residual (sdeflow_tpu/models/unet2d.py:
    227-272). ``attention_impl="auto"`` with at most 8 heads (``fused``)
    runs the whole block as one call of kernel K3 when K3 holds the shape:
    ``block_plan`` finds one (T ≤ 256 and the working set of the
    CUDA-core design it replaced within one block). Otherwise, and on
    ``"unfused"``, it runs module by module: GroupNorm32 (K5), the qkv
    product, the attention core (ops/kernels/attention.py) and the output
    product, the same function as the JAX package's plain composition for
    "auto" blocks beyond its kernel (ops/pallas/attnblock.py:253-265). The
    choice depends on the shape only, never on the device. Both routes hold
    the same parameters."""

    def __init__(self, channels, num_heads=1, attention_impl="auto"):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels, {num_heads} heads")
        if attention_impl == "ring":
            raise NotImplementedError(
                'attention_impl="ring": ROADMAP Queue 1 item 14')
        if attention_impl not in ("auto", "unfused"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        self.num_heads = num_heads
        self.fused = attention_impl == "auto" and num_heads <= MAX_HEADS
        self.norm = GroupNorm32(channels)
        self.qkv = DenseParams(channels, 3 * channels)
        self.proj_out = DenseParams(channels, channels, zero=True)

    def forward(self, x):
        n, c, h, w = x.shape
        t = h * w
        if (self.fused and block_plan(t, c, self.norm.groups,
                                      self.num_heads) is not None):
            x_flat = x.reshape(n, c, t).transpose(1, 2)  # (N, T, C)
            out = fused_attention_block(
                x_flat, self.norm.scale, self.norm.bias, self.qkv.kernel,
                self.qkv.bias, self.proj_out.kernel, self.proj_out.bias,
                self.norm.groups, self.num_heads)
            return out.transpose(1, 2).reshape(n, c, h, w)
        hn = self.norm(x).reshape(n, c, t).transpose(1, 2)  # (N, T, C)
        qkv = hn @ self.qkv.kernel + self.qkv.bias
        out = (attention_core(qkv, self.num_heads) @ self.proj_out.kernel
               + self.proj_out.bias)
        return x + out.transpose(1, 2).reshape(n, c, h, w)


class UNetModel(nn.Module):
    """The U-Net with attention and timestep embedding; x (N, C_in, H, W),
    timesteps (N,) -> (N, C_out, H, W) float32."""

    def __init__(self, in_channels: int, model_channels: int,
                 out_channels: int, in_space: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int],
                 channel_mult: Tuple[int, ...] = (1, 2, 4, 8),
                 conv_resample: bool = True, num_heads: int = 1,
                 num_heads_upsample: int = -1, num_classes=None,
                 use_checkpoint: bool = False, learn_potential: bool = False,
                 attention_impl: str = "auto"):
        super().__init__()
        if num_classes is not None or use_checkpoint or learn_potential:
            raise NotImplementedError(
                "class labels, checkpointing and the learned potential come "
                "with the training slice (ROADMAP Queue 1 item 8)")
        self.model_channels = model_channels
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        temb = model_channels * 4
        self.time_embed_0 = nn.Linear(model_channels, temb)
        self.time_embed_1 = nn.Linear(temb, temb)
        # forward plan after conv_in: ("res", name) | ("mod", name) |
        # ("push", None) saves a skip | ("cat", None) concatenates one back
        plan = []

        def add(op, name, module):
            self.add_module(name, module)
            plan.append((op, name))

        ch = model_channels * channel_mult[0]
        self.conv_in = _conv3(in_channels, ch)
        skips = [ch]
        ds = 1
        block_id = 0
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                out = mult * model_channels
                add("res", f"down_res{block_id}", ResBlock(ch, temb, out))
                ch = out
                if ds in attention_resolutions:
                    add("mod", f"down_attn{block_id}",
                        AttentionBlock(ch, num_heads, attention_impl))
                plan.append(("push", None))
                skips.append(ch)
                block_id += 1
            if level != len(channel_mult) - 1:
                add("mod", f"down_ds{level}", Downsample(ch, conv_resample))
                plan.append(("push", None))
                skips.append(ch)
                ds *= 2

        add("res", "mid_res0", ResBlock(ch, temb))
        add("mod", "mid_attn", AttentionBlock(ch, num_heads, attention_impl))
        add("res", "mid_res1", ResBlock(ch, temb))

        shapes = [in_space]
        for _ in channel_mult:
            shapes.append(shapes[-1] // 2)
        block_id = 0
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                out = model_channels * mult
                plan.append(("cat", None))
                add("res", f"up_res{block_id}",
                    ResBlock(ch + skips.pop(), temb, out))
                ch = out
                if ds in attention_resolutions:
                    add("mod", f"up_attn{block_id}",
                        AttentionBlock(ch, heads_up, attention_impl))
                if level and i == num_res_blocks:
                    add("mod", f"up_us{level}",
                        Upsample(ch, conv_resample,
                                 odd_size=shapes[level] % 2 == 1))
                    ds //= 2
                block_id += 1

        self.out_norm = GroupNorm32(ch, silu=True)
        self.conv_out = _zero_(_conv3(ch, out_channels))
        self._plan = tuple(plan)

    def forward(self, x, timesteps, extra_emb=None):
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_1(F.silu(self.time_embed_0(emb)))
        if extra_emb is not None:
            emb = emb + extra_emb
        h = self.conv_in(x)
        hs = [h]
        for op, name in self._plan:
            if op == "push":
                hs.append(h)
            elif op == "cat":
                h = torch.cat([h, hs.pop()], dim=1)
            elif op == "res":
                h = getattr(self, name)(h, emb)
            else:
                h = getattr(self, name)(h)
        return self.conv_out(self.out_norm(h)).to(torch.float32)
