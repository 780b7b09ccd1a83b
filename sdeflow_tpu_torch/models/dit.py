"""DiT-style transformer score networks over flat signals and images.

Port of sdeflow_tpu/models/dit.py:51-274: ``DiTBlock`` (pre-LN, adaLN-Zero
conditioning of the attention and MLP sublayers), ``DiT1D`` (a flat (B, d)
signal cut into patches of ``patch`` values, zero-padded to a multiple of
it and cropped on the way out) and ``DiT2D`` (a square image cut into p×p
patches, with VorticityUNet's outer contract: flat C- or F-order input
through models/vorticity.py's ``flat_to_img`` / ``img_to_flat``, the /5
value rescale, or (B, H, W, 1) images). With premodule
"NormalizeLogRadius" the input is projected to the sphere (times √d) and
an embedding of log‖x‖ (``norm_embed``) is added to the conditioning.

Rounding points follow the JAX module: LayerNorm is affine-free with fp32
statistics and the population variance (eps 1e-6 inside the rsqrt); scores
are divided by √hd in the compute dtype and the softmax runs in fp32,
cast back; gelu is the tanh form; the MLP sublayer is 4× the width.
``time_mlp`` and ``norm_embed`` compute in fp32 whatever ``dtype`` is, and
so do the final adaLN and ``head_out`` (the JAX default ``fp32_head``,
which no preset turns off), so the score leaves the net as fp32.
``ada_mod``, ``ada_out`` and ``head_out`` start at zero (the score is 0 at
init); ``pos_emb`` is drawn from normal(0.02) in fp32 on the root module,
with every other layer carrying its flax name, so models/convert.py maps a
flax tree unchanged. Attention is plain products and a softmax: the JAX
DiT reaches no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sdeflow_tpu_torch.models.common import (
    TimeMLP, dense, normalize_log_radius, timestep_embedding)
from sdeflow_tpu_torch.models.vorticity import (
    SCALE_IMAGE, flat_to_img, img_to_flat)

MLP_RATIO = 4  # the MLP sublayer's width over the model's


def _ln(h):
    """Affine-free LayerNorm over the last axis with fp32 statistics and
    the population variance, cast back to h's dtype."""
    h32 = h.to(torch.float32)
    mean = h32.mean(dim=-1, keepdim=True)
    var = torch.var(h32, dim=-1, keepdim=True, correction=0)
    return ((h32 - mean) * torch.rsqrt(var + 1e-6)).to(h.dtype)


class DiTBlock(nn.Module):
    """h (B, T, W) tokens, c (B, W) conditioning -> (B, T, W)."""

    def __init__(self, width, heads, dtype=torch.float32):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width}, {heads} heads")
        self.heads = heads
        self.ada_mod = dense(width, 6 * width, dtype, zero=True)
        self.qkv = dense(width, 3 * width, dtype)
        self.proj_out = dense(width, width, dtype)
        self.mlp_in = dense(width, MLP_RATIO * width, dtype)
        self.mlp_out = dense(MLP_RATIO * width, width, dtype)

    def forward(self, h, c):
        mod = self.ada_mod(F.silu(c))[:, None, :]  # (B, 1, 6W)
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)

        # attention sublayer
        x = _ln(h) * (1.0 + sc1) + sh1
        b, t, w = x.shape
        hd = w // self.heads
        q, k, v = (z.reshape(b, t, self.heads, hd).transpose(1, 2)
                   for z in self.qkv(x).chunk(3, dim=-1))  # (B, H, T, hd)
        scale = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(x.dtype)
        att = (q @ k.transpose(-1, -2)) / scale
        att = torch.softmax(att.to(torch.float32), dim=-1).to(x.dtype)
        o = (att @ v).transpose(1, 2).reshape(b, t, w)
        h = h + g1 * self.proj_out(o)

        # MLP sublayer
        x = _ln(h) * (1.0 + sc2) + sh2
        x = F.gelu(self.mlp_in(x), approximate="tanh")
        return h + g2 * self.mlp_out(x)


class _DiT(nn.Module):
    """The parts DiT1D and DiT2D share, on the root module under flax's
    names: the conditioning (``time_mlp``, ``norm_embed``), the patch
    embedding with ``pos_emb``, the blocks and the adaLN-Zero head."""

    def __init__(self, n_tok, patch_dim, width, depth, heads, premodule,
                 dtype):
        super().__init__()
        if premodule not in (None, "NormalizeLogRadius"):
            raise ValueError(f"unknown premodule {premodule!r}")
        self.premodule, self.width = premodule, width
        self.compute_dtype = dtype
        self.time_mlp = TimeMLP(width, width, act="silu")
        if premodule == "NormalizeLogRadius":
            self.norm_embed = TimeMLP(1, width, act="silu")
        self.patch_embed = dense(patch_dim, width, dtype)
        self.pos_emb = nn.Parameter(torch.randn(n_tok, width) * 0.02)
        for i in range(depth):
            self.add_module(f"block{i}",
                            DiTBlock(width, heads, dtype))
        self.depth = depth
        self.ada_out = dense(width, 2 * width, torch.float32, zero=True)
        self.head_out = dense(width, patch_dim, torch.float32, zero=True)

    def condition(self, flat, t):
        """(flat input, conditioning c (B, W) fp32): the time embedding
        and, under the premodule, flat projected to the sphere times √d
        with the log-norm embedding added to c."""
        t = t.reshape(-1).to(torch.float32)
        c = self.time_mlp(timestep_embedding(t, self.width))
        if self.premodule == "NormalizeLogRadius":
            unit, log_norm = normalize_log_radius(flat)
            flat = unit * float(flat.shape[-1]) ** 0.5
            c = c + self.norm_embed(log_norm.reshape(-1, 1))
        return flat, c

    def tokens(self, h, c):
        """Patches h (B, T, patch_dim) -> head outputs (B, T, patch_dim)."""
        h = self.patch_embed(h.to(self.compute_dtype))
        h = h + self.pos_emb.to(self.compute_dtype)[None]
        c = c.to(self.compute_dtype)
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h, c)
        mod = self.ada_out(F.silu(c))[:, None, :]
        sh, sc = mod.chunk(2, dim=-1)
        return self.head_out(_ln(h) * (1.0 + sc) + sh)


class DiT1D(_DiT):
    """Transformer score net over flat (B, d) signals: net(x, t) -> (B, d)
    fp32."""

    def __init__(self, input_dim: int, patch: int = 16, width: int = 512,
                 depth: int = 6, heads: int = 4,
                 premodule: Optional[str] = None, dtype=torch.float32):
        pad = (-input_dim) % patch
        n_tok = (input_dim + pad) // patch
        super().__init__(n_tok, patch, width, depth, heads, premodule, dtype)
        self.input_dim, self.patch, self.n_tok = input_dim, patch, n_tok
        self.pad = pad

    def forward(self, x, t):
        sz = x.shape
        x, c = self.condition(x.reshape(-1, self.input_dim), t)
        if self.pad:
            x = F.pad(x, (0, self.pad))
        h = self.tokens(x.reshape(-1, self.n_tok, self.patch), c)
        out = h.reshape(-1, self.n_tok * self.patch)[:, :self.input_dim]
        return out.to(torch.float32).reshape(sz)


class DiT2D(_DiT):
    """Transformer score net over square images, flat (B, H·W) in C or F
    order or (B, H, W, 1): net(x, t) -> the same shape, fp32."""

    def __init__(self, in_space: int = 16, patch: int = 4, width: int = 512,
                 depth: int = 6, heads: int = 4,
                 premodule: Optional[str] = None, flatten_order: str = "C",
                 dtype=torch.float32):
        if flatten_order not in ("C", "F"):
            raise ValueError(f"unknown flatten_order {flatten_order!r}")
        if in_space % patch:
            raise ValueError(f"patch {patch} must divide in_space {in_space}")
        n_side = in_space // patch
        super().__init__(n_side * n_side, patch * patch, width, depth, heads,
                         premodule, dtype)
        self.in_space, self.patch = in_space, patch
        self.flatten_order = flatten_order

    def forward(self, x, t):
        H = W = self.in_space
        p = self.patch
        need_flat = x.ndim == 2
        if not need_flat and (x.ndim != 4 or x.shape[-1] != 1):
            raise ValueError(f"Expected (B, d) or (B, H, W, 1), got "
                             f"{tuple(x.shape)}")
        flat, c = self.condition(x.reshape(x.shape[0], -1), t)
        if need_flat:
            x_img = flat_to_img(flat, H, W, order=self.flatten_order)
        else:
            x_img = flat.reshape(x.shape) / SCALE_IMAGE

        # p×p patchify: (B, H, W, 1) -> (B, (H/p)·(W/p), p²)
        b = x_img.shape[0]
        hp, wp = H // p, W // p
        h = x_img[..., 0].reshape(b, hp, p, wp, p).permute(0, 1, 3, 2, 4)
        h = self.tokens(h.reshape(b, hp * wp, p * p), c)
        y = h.reshape(b, hp, wp, p, p).permute(0, 1, 3, 2, 4)
        y = y.reshape(b, H, W, 1).to(torch.float32)
        if need_flat:
            return img_to_flat(y, order=self.flatten_order)
        return y * SCALE_IMAGE
