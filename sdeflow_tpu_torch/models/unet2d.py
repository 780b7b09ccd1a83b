"""ADM-style U-Net with attention and timestep embedding.

Port of sdeflow_tpu/models/unet2d.py: ``UNetModel`` with every option of
the JAX module (class labels, activation checkpointing, ``dims`` 1, 2 or
3, dropout, scale-shift norm, the learned potential and the features
mode), ``potential_score`` and ``ConditionalModel``. Activations are
channels-first (N, C, *spatial). ``dtype`` is the compute dtype in flax's
sense (float32 or bfloat16, sdeflow_tpu/models/unet2d.py:301-305): the
parameters stay fp32 and every convolution and dense layer casts them, and
its input, to ``dtype`` at each call (``Conv1d``/``Conv2d``/``Conv3d``,
``Linear``; explicit casts, not ``torch.autocast``, whose own lists would
keep GroupNorm and softmax in fp32 and round elsewhere than the JAX
package); GroupNorm keeps fp32 statistics, and the output head runs in fp32
(the JAX package's default ``fp32_head``, which no preset turns off), so
the score leaves the net as fp32. Submodules and parameters carry the flax
names (``down_res0.in_conv``, ``mid_attn.qkv.kernel``, ...) so that
models/convert.py maps a flax tree by name, and start from flax's default
init (``flax_init_``: lecun_normal kernels, zero biases; the zero-init
layers zero). As in flax, a branch that a configuration never runs
creates no parameters: with ``learn_potential`` there is no decoder. Every
GroupNorm is kernel K5 (ops/kernels/groupnorm.py). An AttentionBlock on
the ``"auto"`` route with at most 8 heads, whose shape kernel K3 takes
(``block_plan``: T ≤ 256 and a working set that fits one block's shared
memory), is K3 (ops/kernels/attnblock.py); otherwise it runs the unfused
composition with the attention core K6/K4, or K7a/K7b under autograd above
T = 1024 (ops/kernels/attention.py). The attention flattens any spatial
rank to T.

Dropout mirrors flax's ``nn.Dropout``: off unless the call passes
``deterministic=False``, and then its masks come from the ``generator``
that the call passes (never the global RNG), kept where a uniform draw is
below 1 − p and scaled by 1/(1 − p).

``use_checkpoint`` rematerializes every ResBlock and AttentionBlock as the
JAX package's ``nn.remat`` does (unet2d.py:313-332), with
``torch.utils.checkpoint`` (non-reentrant) when autograd records the call:
the backward reruns the block's forward, so the loss and gradients are
those without it. ``torch.utils.checkpoint`` refuses forward-mode
transforms (``torch.func.jvp``, ``torch.autograd.forward_ad``) and
``torch.func``'s reverse transforms, so while one is active (the SSM
loss's JVP, ``potential_score`` inside it) the blocks run without remat,
with the same values, and a warning says so once per model (ROADMAP
Queue 1 item 19).
"""

from __future__ import annotations

import math
import warnings
from typing import Sequence, Tuple

import torch
import torch.autograd.forward_ad as forward_ad
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sdeflow_tpu_torch.models.common import (
    GroupNorm32, _lecun_normal_, cast, dense, flax_init_,
    timestep_embedding, zero_init_)
from sdeflow_tpu_torch.ops.kernels.attention import attention_core
from sdeflow_tpu_torch.ops.kernels.attnblock import (
    MAX_HEADS, block_plan, fused_attention_block)


class _CastConv:
    """A convolution computing in ``compute_dtype``, as flax's ``nn.Conv``
    with ``dtype=`` does: its input and its fp32 parameters are cast at
    each call."""

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(
            cast(x, dt), cast(self.weight, dt),
            None if self.bias is None else cast(self.bias, dt))


class Conv1d(_CastConv, nn.Conv1d):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype


class Conv2d(_CastConv, nn.Conv2d):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype


class Conv3d(_CastConv, nn.Conv3d):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype


CONV = {1: Conv1d, 2: Conv2d, 3: Conv3d}


def _conv(dims, cin, cout, k, stride=1, padding=0, bias=True,
          dtype=torch.float32):
    return flax_init_(CONV[dims](cin, cout, k, stride=stride,
                                 padding=padding, bias=bias,
                                 compute_dtype=dtype))


def _conv3(dims, cin, cout, stride=1, bias=True, dtype=torch.float32):
    return _conv(dims, cin, cout, 3, stride, 1, bias, dtype)


def transform_active():
    """True while a ``torch.func`` transform or forward-mode AD is active
    (``torch.utils.checkpoint`` refuses both)."""
    return (torch._C._functorch.peek_interpreter_stack() is not None
            or forward_ad._current_level >= 0)


class Upsample(nn.Module):
    """Nearest-neighbour ×2 on every spatial axis, then a 3-wide conv;
    crops the last entry of every spatial axis when the target size is
    odd."""

    def __init__(self, channels, use_conv, dims=2, odd_size=False,
                 dtype=torch.float32):
        super().__init__()
        self.dims = dims
        self.odd_size = odd_size
        if use_conv:
            self.conv = _conv3(dims, channels, channels, dtype=dtype)

    def forward(self, x):
        for axis in range(2, 2 + self.dims):
            x = x.repeat_interleave(2, dim=axis)
        if hasattr(self, "conv"):
            x = self.conv(x)
        if self.odd_size:
            x = x[(slice(None), slice(None))
                  + (slice(None, -1),) * self.dims]
        return x


class Downsample(nn.Module):
    """Stride-2 3-wide conv with padding 1, or 2-wide average pooling."""

    def __init__(self, channels, use_conv, dims=2, dtype=torch.float32):
        super().__init__()
        self.dims = dims
        if use_conv:
            self.op = _conv3(dims, channels, channels, stride=2, dtype=dtype)

    def forward(self, x):
        if hasattr(self, "op"):
            return self.op(x)
        return (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[self.dims - 1](x, 2)


class ResBlock(nn.Module):
    """Residual block conditioned on a timestep embedding
    (sdeflow_tpu/models/unet2d.py:89-154). ``keep``, if given, is the
    dropout's boolean keep mask of h's shape."""

    def __init__(self, channels, emb_channels, out_channels=None,
                 use_conv=False, no_bias_last_layer=False,
                 dtype=torch.float32, dims=2, dropout=0.0,
                 use_scale_shift_norm=False):
        super().__init__()
        out_ch = out_channels or channels
        self.out_ch, self.dims, self.dropout = out_ch, dims, dropout
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(channels, silu=True)
        self.in_conv = _conv3(dims, channels, out_ch, dtype=dtype)
        self.emb_dense = dense(emb_channels,
                               2 * out_ch if use_scale_shift_norm else out_ch,
                               dtype)
        # with scale-shift the affine from the embedding sits between the
        # norm and the SiLU, so K5 runs without its SiLU (:119-124)
        self.out_norm = GroupNorm32(out_ch, silu=not use_scale_shift_norm)
        self.out_conv = zero_init_(_conv3(dims, out_ch, out_ch,
                                          bias=not no_bias_last_layer,
                                          dtype=dtype))
        if out_ch != channels:
            self.skip_conv = (
                _conv3(dims, channels, out_ch, dtype=dtype) if use_conv else
                _conv(dims, channels, out_ch, 1,
                      bias=not no_bias_last_layer, dtype=dtype))

    def forward(self, x, emb, keep=None):
        h = self.in_conv(self.in_norm(x))
        # emb may be fp32 (the scale embedding promotes it); the dense
        # layer casts it to the compute dtype (unet2d.py:116)
        e = self.emb_dense(F.silu(emb))
        e = e.reshape(*e.shape, *([1] * self.dims))
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = F.silu(self.out_norm(h) * (1 + scale) + shift)
        else:
            h = self.out_norm(h + e)
        if keep is not None:
            p = 1.0 - self.dropout
            h = (torch.where(keep, h / p, torch.zeros_like(h)) if p > 0
                 else torch.zeros_like(h))
        h = self.out_conv(h)
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
        else:
            _lecun_normal_(kernel, in_features)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(features))


class AttentionBlock(nn.Module):
    """Spatial self-attention over the flattened feature map: GroupNorm →
    qkv → attention → proj → residual (sdeflow_tpu/models/unet2d.py:
    227-272), over any spatial rank. ``attention_impl="auto"`` with at
    most 8 heads (``fused``) runs the whole block as one call of kernel K3
    when K3 holds the shape in x's dtype: ``block_plan`` finds one (T ≤ 256
    and the working set of the CUDA-core design it replaced within one
    block; in bf16, a launch plan of the wgmma body, which holds the T =
    256 multi-head blocks that fp32 holds with qkv in scratch, but not the
    widest C that fp32 reaches only with h in scratch too). Otherwise, and
    on ``"unfused"``, it runs module by module: GroupNorm32 (K5), the qkv
    product, the attention core (ops/kernels/attention.py) and the output
    product, the same function as the JAX package's plain composition for
    "auto" blocks beyond its kernel (ops/pallas/attnblock.py:253-265). The
    choice depends on the shape and dtype only, never on the device. Both
    routes hold the same parameters."""

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
        n, c = x.shape[:2]
        t = math.prod(x.shape[2:])
        if (self.fused and block_plan(t, c, self.norm.groups,
                                      self.num_heads, x.dtype) is not None):
            x_flat = x.reshape(n, c, t).transpose(1, 2)  # (N, T, C)
            out = fused_attention_block(
                x_flat, self.norm.scale, self.norm.bias, self.qkv.kernel,
                self.qkv.bias, self.proj_out.kernel, self.proj_out.bias,
                self.norm.groups, self.num_heads)
            return out.transpose(1, 2).reshape(x.shape)
        hn = self.norm(x).reshape(n, c, t).transpose(1, 2)  # (N, T, C)
        dt = hn.dtype  # the Dense layers' compute dtype: x's
        qkv = hn @ cast(self.qkv.kernel, dt) + cast(self.qkv.bias, dt)
        out = (attention_core(qkv, self.num_heads)
               @ cast(self.proj_out.kernel, dt)
               + cast(self.proj_out.bias, dt))
        return x + out.transpose(1, 2).reshape(x.shape)


class UNetModel(nn.Module):
    """The U-Net with attention and timestep embedding
    (sdeflow_tpu/models/unet2d.py:275-456); x (N, C_in, *spatial) with
    ``dims`` spatial axes, timesteps (N,) -> (N, C_out, *spatial) float32,
    computing in ``dtype`` (the output head in fp32).

    Call modes, as the JAX module's: ``potential_only=True`` (or a model
    built with ``learn_potential``) returns the scalar potential, the mean
    of the middle features summed over the batch; ``return_features=True``
    a dict of ``down`` (list), ``middle``, ``up`` (list) and ``out``.
    ``y`` (N,) integer labels with ``num_classes``."""

    def __init__(self, in_channels: int, model_channels: int,
                 out_channels: int, in_space: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int],
                 channel_mult: Tuple[int, ...] = (1, 2, 4, 8),
                 conv_resample: bool = True, num_heads: int = 1,
                 num_heads_upsample: int = -1, num_classes=None,
                 use_checkpoint: bool = False, learn_potential: bool = False,
                 attention_impl: str = "auto", dtype=torch.float32,
                 dims: int = 2, dropout: float = 0.0,
                 use_scale_shift_norm: bool = False):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
        if dims not in CONV:
            raise ValueError(f"dims {dims}: 1, 2 or 3")
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.use_checkpoint = use_checkpoint
        self.learn_potential = learn_potential
        self.dropout = float(dropout)
        self._warned_remat = False
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        temb = model_channels * 4
        self.time_embed_0 = dense(model_channels, temb, dtype)
        self.time_embed_1 = dense(temb, temb, dtype)
        if num_classes is not None:
            # flax's nn.Embed: fp32, normal init of variance 1/features
            self.label_emb = nn.Embedding(num_classes, temb)
            nn.init.normal_(self.label_emb.weight, std=temb ** -0.5)

        def res(cin, cout=None, **kw):
            return ResBlock(cin, temb, cout, dtype=dtype, dims=dims,
                            dropout=dropout,
                            use_scale_shift_norm=use_scale_shift_norm, **kw)

        # forward plan after conv_in: ("res", name) | ("mod", name) |
        # ("push", None) saves a skip | ("cat", None) concatenates one back
        # | ("middle", None) ends the middle | ("up", None) ends a decoder
        # step (a feature of the "up" list)
        plan = []

        def add(op, name, module):
            self.add_module(name, module)
            plan.append((op, name))

        ch = model_channels * channel_mult[0]
        self.conv_in = _conv3(dims, in_channels, ch, dtype=dtype)
        skips = [ch]
        ds = 1
        block_id = 0
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                out = mult * model_channels
                add("res", f"down_res{block_id}", res(ch, out))
                ch = out
                if ds in attention_resolutions:
                    add("mod", f"down_attn{block_id}",
                        AttentionBlock(ch, num_heads, attention_impl))
                plan.append(("push", None))
                skips.append(ch)
                block_id += 1
            if level != len(channel_mult) - 1:
                add("mod", f"down_ds{level}",
                    Downsample(ch, conv_resample, dims, dtype=dtype))
                plan.append(("push", None))
                skips.append(ch)
                ds *= 2

        add("res", "mid_res0", res(ch))
        add("mod", "mid_attn", AttentionBlock(ch, num_heads, attention_impl))
        add("res", "mid_res1", res(ch, 1 if learn_potential else None,
                                   no_bias_last_layer=learn_potential))
        plan.append(("middle", None))
        self._plan = tuple(plan)
        if learn_potential:  # the potential ends at the middle
            return

        shapes = [in_space]
        for _ in channel_mult:
            shapes.append(shapes[-1] // 2)
        block_id = 0
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                out = model_channels * mult
                plan.append(("cat", None))
                add("res", f"up_res{block_id}", res(ch + skips.pop(), out))
                ch = out
                if ds in attention_resolutions:
                    add("mod", f"up_attn{block_id}",
                        AttentionBlock(ch, heads_up, attention_impl))
                if level and i == num_res_blocks:
                    add("mod", f"up_us{level}",
                        Upsample(ch, conv_resample, dims,
                                 odd_size=shapes[level] % 2 == 1,
                                 dtype=dtype))
                    ds //= 2
                plan.append(("up", None))
                block_id += 1

        self.out_norm = GroupNorm32(ch, silu=True)
        self.conv_out = zero_init_(_conv3(dims, ch, out_channels))
        self._plan = tuple(plan)

    def _remat(self):
        """Whether this call rematerializes its blocks (module
        docstring)."""
        if not (self.use_checkpoint and torch.is_grad_enabled()):
            return False
        if transform_active():
            if not self._warned_remat:
                self._warned_remat = True
                warnings.warn(
                    "use_checkpoint: torch.utils.checkpoint refuses "
                    "torch.func and forward-mode transforms, so the blocks "
                    "run without remat under them (same values, no memory "
                    "saved; ROADMAP Queue 1 item 19)",
                    stacklevel=3)
            return False
        return True

    def _block(self, module, remat, *args):
        if remat:
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def forward(self, x, timesteps, y=None, extra_emb=None, *,
                deterministic=True, generator=None, potential_only=False,
                return_features=False):
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_1(F.silu(self.time_embed_0(emb)))
        if self.num_classes is not None:
            if y is None or tuple(y.shape) != (emb.shape[0],):
                raise ValueError(f"num_classes={self.num_classes}: y must "
                                 "be (N,) integer labels")
            emb = emb + self.label_emb(y)
        if extra_emb is not None:
            emb = emb + extra_emb
        drop = not deterministic and self.dropout > 0
        if drop and generator is None:
            raise ValueError("dropout with deterministic=False draws its "
                             "masks from a torch.Generator: pass generator")
        remat = self._remat()
        h = self.conv_in(x)
        hs = [h]
        features = dict(up=[]) if return_features else None
        for op, name in self._plan:
            if op == "push":
                hs.append(h)
            elif op == "cat":
                h = torch.cat([h, hs.pop()], dim=1)
            elif op == "middle":
                if potential_only or self.learn_potential:
                    return h.mean(dim=tuple(range(1, h.ndim))).sum()
                if return_features:
                    features.update(down=list(hs), middle=h)
            elif op == "up":
                if return_features:
                    features["up"].append(h)
            elif op == "res":
                block = getattr(self, name)
                keep = None
                if drop:
                    keep = torch.rand(
                        (h.shape[0], block.out_ch, *h.shape[2:]),
                        generator=generator, device=h.device) < (
                            1.0 - self.dropout)
                h = self._block(block, remat, h, emb, keep)
            elif name.startswith(("down_attn", "mid_attn", "up_attn")):
                h = self._block(getattr(self, name), remat, h)
            else:
                h = getattr(self, name)(h)
        out = cast(self.conv_out(self.out_norm(h)), torch.float32)
        if return_features:
            features["out"] = out
            return features
        return out


def gradient(fn, x):
    """∇ₓ fn(x) of a scalar fn, in the three places a learned potential's
    score is taken: inside a ``torch.func`` transform (the SSM loss's JVP)
    and wherever autograd records (a loss's ``.backward()`` to the
    parameters), ``torch.func.grad``, whose result carries the outer
    tangent and graph; with grad mode off (the sampler), a local
    ``torch.enable_grad()`` and ``torch.autograd.grad`` without a graph,
    whose backward then runs with grad mode off (GroupNorm's backward is
    kernel K5b)."""
    if torch.is_grad_enabled() or transform_active():
        return torch.func.grad(fn)(x)
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        (g,) = torch.autograd.grad(fn(xg), xg)
    return g


def potential_score(model, x, timesteps, y=None, extra_emb=None, **kwargs):
    """Score as the gradient of the learned potential: ∇ₓ Σ_b
    mean(middle_b) (sdeflow_tpu/models/unet2d.py:458-468); see
    ``gradient`` for how it is taken. kwargs go to the model's call
    (deterministic, generator)."""

    def pot(xv):
        return model(xv, timesteps, y=y, extra_emb=extra_emb,
                     potential_only=True, **kwargs)

    return gradient(pot, x)


class ConditionalModel(nn.Module):
    """Conditional denoising: concatenates a same-resolution conditioning
    image along channels before the core U-Net
    (sdeflow_tpu/models/unet2d.py:471-483)."""

    def __init__(self, core: UNetModel):
        super().__init__()
        self.core = core

    def forward(self, x, timesteps, conditional=None, **kwargs):
        if conditional is None:
            raise ValueError("ConditionalModel requires `conditional`")
        return self.core(torch.cat([x, conditional], dim=1), timesteps,
                         **kwargs)
