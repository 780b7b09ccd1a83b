#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sdeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH] [--gn]

Drives the port's paths on the grf16 MSGM arm at full width (the
VorticityUNet score net with random weights from a seed, the circulant MSGM
SDE at d=256 built from 100k SmoothedGRF samples): sampling with
norm-corrected RK4 and SSM training at batch 128, each on the U-Net's
"auto" AttentionBlock route (kernel K3) and on its "unfused" route
(GroupNorm K5, the attention core K6, two products); the unfused
AttentionBlock at a long sequence (kernel K4, and the reverse-mode pair
K7a/K7b under autograd); and denoising-score-matching training of the SGM
arm of the grf U-Net on 128×128 images at batch 128 (K5, K5b, K6, K7a,
K7b; K5b is GroupNorm's backward, run by every training path). It holds
every CUDA kernel of those paths against its plain PyTorch version:

1. prints the card's name and power limit, builds the kernels from
   sdeflow_tpu_torch/csrc with nvcc (one process per source, in parallel);
2. K1 circulant_apply against circ_math, bit for bit, at (1024, 256),
   (1000, 256), (1024, 1024) and the plans' edges (1001, 96) (warp plan,
   3 floats per lane) and (999, 1056) (general plan), the Python plan
   mirror equal to the compiled chooser at each; K1 timed at (1024, 256)
   per call, as a direct launch, its device time from a trace beside the
   smallest PyTorch kernel of the same trace (the launch floor), the bound
   and the plain version;
3. K3 fused_attention_block against attn_block_math at (1024, 64, 64) and
   (1024, 16, 128) with one head and at (1024, 64, 64) with four heads,
   all weights random and non-zero, TF32 off, rtol/atol 1e-5;
4. builds the arm (make_model, build_msgm_arm) on both routes with the same
   weights, and finds the (C, S) of every GroupNorm of one forward;
5. K5 group_norm_silu against gn_math and K5b (its backward,
   group_norm_silu_bwd) against gn_math_vjp at each of those shapes at
   B = 1024, at each of the DSM step's at B = 128, at odd sizes and at the
   launch plans' edges (slabs of 32 to 65,540 floats, S % 4 != 0, the
   stream plan), SiLU on and off: K5 rtol/atol 1e-5, K5b's dx within
   1e-5·max |dx| of the fp32 plain vjp and dγ, dβ (sums of up to 2M terms)
   within 1e-5·max of the float64 one; times both at the auto route's
   shapes beside PyTorch's GroupNorm forward (F.group_norm) and backward
   (aten.native_group_norm_backward, given the forward's statistics; K5b
   also beside the rule it replaced: autograd of the rerun gn_math);
6. K6 qkv_attention against attention_math at (1024, 64, 64) and
   (1024, 16, 128) with one head, (1024, 64, 64) with four and the DSM
   step's (128, 1024, 128) (there against attention_math in float64, since
   the fp32 plain version is itself ~1e-5 off), atol 1e-5,
   and K4 (qkv_attention above T = 1024: the tensor-core kernel
   flash_fwd.cu) at (4, 4096, 64) with one and two heads and
   (2, 2048, 128), atol 2e-5 (the online softmax sums thousands of terms in
   another order than the plain softmax); times both beside
   torch.nn.functional.scaled_dot_product_attention (K6 at the three
   one-head shapes, the DSM step's among them);
7. serves three requests of 1024 samples with 32 RK4 steps each on the
   auto route: finite (1024, 256) samples, every latent norm kept to rtol
   1e-5, and exactly 8·32 launches of K1, 44·32 of K3 and 140·32 of K5 per
   request;
8. replays the last request (same x0 and noise) ten times: plain, twice
   kernel, direct, direct, kernel, then plain. The plain runs put the
   plain versions in place of the kernel wrappers, the direct runs launch
   each kernel without its autograd.Function; max |Δ| ≤ 1e-3·max |x|
   against the request, no launch in a plain run, the exact counts in the
   others;
9. traces a 2-step request with torch.profiler: device time by kernel,
   the device's busy time and idle share;
10. the unfused route: one request on the same x0 and noise (exactly 256
   K1, 184·32 K5 and 44·32 K6 launches, no K3; within 1e-3·max |x| of the
   auto route's), replayed plain, kernel, direct, direct, kernel, plain,
   requests of the two routes in turns (auto, unfused, unfused, auto),
   and a traced 2-step request;
11. K4 on its path: one unfused AttentionBlock at (B = 4, 64×64, C = 64),
   T = 4096: the forward under no_grad, a torch.func.jvp and a gradient
   with the block's parameters requiring grad, each against the plain path
   (output and tangent 2e-5·max |plain|, gradients 1e-4·max |g|); exactly
   3 launches of K5, 1 of K4 (the no-grad forward), 2 of K7a (the jvp, the
   gradient's forward), 1 of K7b and 1 of K5b; and a trace of three no-grad
   forwards;
12. K2 circulant_rk4_step against rk4_math_fwd, bit for bit, at (128, 256),
   (1000, 256), (1024, 1024), (127, 96) and (129, 97), sb3 in [1, 2], the
   plan mirror equal to the compiled chooser, timed at (128, 256) as K1 in
   phase 2; ForwardFlow.rk4_step (kernel K2) against the generic rk4_step
   on the plain versions; K2's solve (circulant_rk4_solve_select, one
   launch for the SSM loss's forward solve) at (64, 128, 256) on grf16's
   SDE with the steps per row from grf16's t draws, all 0 and all 64: bit
   for bit against a loop of ForwardFlow.rk4_step (one K2 launch per step)
   with the masked select and against integrate_select, within 1e-6 of
   rk4_solve_select_math; its device time per case beside the bound (the z
   rows the case reads) and the launch floor; against the loop: per call,
   device time and kernels from traces, and wall time per solve with the
   draws (one randn against 64, the fills and the selects);
13. autograd through the kernels: torch.func.jvp, torch.autograd.grad and
   a double backward (create_graph: the kernel's forward, the plain
   version's differentiable backward) through each kernel's Function
   against the plain version at the paths' shapes (K1, K2 and K2's solve
   over 8 steps 1e-6; K3, K5, K6 1e-5, relative to the largest entry; K5's
   first-order gradients
   through K5b, exactly two launches), and a ResBlock's gradient through
   its JVP on cuDNN and K5 against the CPU (1e-4);
14. training on the auto route: on one batch of 128 with injected draws,
   the loss and every parameter gradient of the kernel path against the
   plain path (loss rtol 1e-4, each gradient max |Δ| ≤ 1e-3·max |g|); three
   steps of the driver's Trainer (train_msgm_arm); 20 timed bare train
   steps with exactly 1 K2 solve, no K2 step, 5 K1, 11 K3, 35 K5 and 35 K5b
   launches each (the loss reads the score as well as its JVP); then a
   train step replayed plain, kernel, kernel, plain; and the forward
   trajectory (sample_scheme_allt, the ssm_intT loss's solve) at batch 128
   with exactly 64 K2 step launches, its last state with injected normals
   equal to K2's solve taking every step;
15. traces one train step with torch.profiler, on the kernel path and on
   the plain path;
16. training on the unfused route: the same agreement check, 10 timed bare
   train steps with exactly 1 K2 solve, 5 K1, 46 K5, 46 K5b and 11 K6
   launches each,
   5 steps of each route in turns (auto, unfused, unfused, auto), and one
   traced step;
17. K7a (flash forward with lse) and K7b (flash backward) against their
   plain versions, TF32 off, at (4, 4096, 64) with one and two heads,
   (2, 2048, 128) and the ragged (2, 1000, 64): the output within
   2e-5·max |plain|, lse within 1e-5, dqkv within 1e-4·max |plain|; their
   times at (4, 4096, 64) per call through FlashAttention (its forward; its
   backward alone) and as a direct launch, beside the plain versions, the
   bound and scaled_dot_product_attention's forward and backward; and the
   direct launches and SDPA's forward and backward at the DSM path's own
   shape (128, 4096, 64), a few calls each;
18. DSM training of the SGM arm of _grf(128) (build_sgm_arm, random
   weights, SmoothedGRF(128, ell 2), lr 1e-4, bare Adam; every AttentionBlock
   on the unfused route: 5 at T = 4096, 6 at T = 1024): K5 and K5b timed
   at the step's GroupNorm shapes at batch 128 beside
   PyTorch's GroupNorm forward and backward, K5b's old rule
   and the bounds; on one batch of 8 with
   injected t and ε, the loss and every parameter gradient against the plain
   path (rtol 1e-4, 1e-3·max |g|) with both paths' peak memory; two
   Trainer(loss="dsm") steps with their ELBO prints; 5 timed bare steps at
   batch 128 with exactly 46 K5, 46 K5b, 6 K6, 5 K7a and 5 K7b launches
   each (no K1-K4); one step of the plain and the kernel path in turns
   (plain, kernel, kernel, plain) at batch 8;
19. traces one DSM step at batch 128 with torch.profiler, with the device
   time under GroupNormSiLUBackward.

Ends with the kernel table as one JSON line (K1, K2, K2's solve, K3, K5,
K5b, K6, K4, K7a, K7b: per call through the autograd.Function and as a
direct launch, device time, bound, plain version, the launch floor for
K1, K2 and the solve, and the library call where one computes the same
function; the
bound is the largest of the bytes over 3.35 TB/s, the matrix-product flops
three times over 494.7 TFLOP/s dense TF32, and the other flops over
67 TFLOP/s fp32), then
{"ok": true, "device": {...}} as the last line. Exits non-zero without a
CUDA device, outside the repository, or when any check fails. With
--record, also writes the full record (every measurement, the profiles'
top kernels) as JSON to PATH. With --gn, only builds the kernels and times
K5 and K5b at both GroupNorm mixes, with one traced DSM step.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

N_SAMPLES, DIM, STEPS, REQUESTS = 1024, 256, 32, 3
PROFILED_STEPS = 2
FORWARDS_PER_STEP = 4  # RK4
K1_PER_STEP = 8
GROUP_NORMS, ATTN_BLOCKS = 35, 11  # per grf16 U-Net forward
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12    # fp32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12  # dense TF32 on the tensor cores
TF32_PASSES = 3  # 3xTF32: fp32 accuracy from three TF32 products
# K1 and K2: the paths' shapes, a warp-plan edge (d = 96: 3 floats per
# lane, no float4), the general plans (d = 1,056 past 1,024; d = 97) and
# B not a multiple of the rows per block
K1_SHAPES = [(1024, 256), (1000, 256), (1024, 1024), (1001, 96),
             (999, 1056)]
K2_SHAPES = [(128, 256), (1000, 256), (1024, 1024), (127, 96), (129, 97)]
TRAIN_BATCH, TRAIN_STEPS = 128, 64  # grf16: batch 128, 64 forward steps
WARM_STEPS, TIMED_STEPS, REPLAY_STEPS = 3, 20, 5
TIMED_STEPS_UNFUSED = 10
# launches per bare train step: K2's solve once (the whole 64-step forward
# solve), K2's step never; K1 four times in the one-step fallback and once
# in the loss field; the U-Net's kernels once per call of the one U-Net
# forward under the JVP (the jvp and backward rules run the plain versions)
K1_PER_TRAIN, K2_PER_TRAIN, K2_SOLVE_PER_TRAIN = 5, 0, 1
K3_SHAPES = [(1024, 64, 64, 1), (1024, 16, 128, 1), (1024, 64, 64, 4)]
BLOCK_MIX = {(64, 64): 5, (16, 128): 6}  # AttentionBlocks per forward
# (B, C, S, groups): slabs of 15, 15 and 8,192 floats (a cluster of two)
K5_ODD = [(3, 5, 7, 5), (2, 10, 3, 2), (2, 64, 4096, 32)]
# the launch plans' edges (groupnorm.launch_plan): slabs of n = S floats
# just below and above each threshold of the lanes per slab (32, 64), the
# vectors per lane (128, 1,024), the cluster size (8,192, 16,384) and the
# stream plan (65,536, beyond a cluster's registers); S % 4 != 0 (1,023,
# 1,025 and 33,333 floats, the last streamed); a cluster block ending inside
# a channel (C/G = 2, S = 4,100); 8-lane slabs past the last whole block
K5_EDGES = [(3, 32, s, 32) for s in (32, 36, 64, 68, 128, 132, 1024, 1028,
                                     8192, 8196, 16384, 16388, 65536, 65540,
                                     1023, 1025, 33333)] + [
    (2, 64, 4100, 32), (3, 10, 16, 5)]
K6_SHAPES = [(1024, 64, 64, 1), (1024, 16, 128, 1), (1024, 64, 64, 4),
             (128, 1024, 128, 1)]
K6_DSM = (1024, 128)  # (T, C) of K6 on the DSM step: its 32x32 level
K4_SHAPES = [(4, 4096, 64, 1), (4, 4096, 64, 2), (2, 2048, 128, 1)]
LONG_BLOCK = (4, 64, 64, 64)  # (B, C, H, W): T = 4096
# K7a/K7b: the T = 4096 blocks' shape, two heads, a head width of 128 and a
# ragged T for the kernels' edge masking
K7_SHAPES = [(4, 4096, 64, 1), (4, 4096, 64, 2), (2, 2048, 128, 1),
             (2, 1000, 64, 1)]
# the SGM DSM slice: the grf U-Net on 128×128 SmoothedGRF images at grf's
# batch; AttentionBlocks per forward at (C, H·W): 5 at T = 4096, 6 at 1024
SGM_NPIXEL, SGM_BATCH, SGM_AGREE_BATCH, SGM_TIMED_STEPS = 128, 128, 8, 5
SGM_BLOCKS = {(64, 4096): 5, (128, 1024): 6}
# (C, S, silu) -> GroupNorm32 calls per forward of that U-Net (32 groups)
SGM_GN_MIX = {(32, 4096, True): 1, (32, 16384, True): 8, (64, 1024, True): 1,
              (64, 4096, False): 5, (64, 4096, True): 6,
              (64, 16384, True): 2, (96, 4096, True): 1,
              (96, 16384, True): 1, (128, 1024, False): 6,
              (128, 1024, True): 10, (128, 4096, True): 1,
              (192, 1024, True): 1, (192, 4096, True): 1,
              (256, 1024, True): 2}
SGM_WANT = {"group_norm_silu": 46, "group_norm_silu_bwd": 46,
            "qkv_attention": 6,
            "qkv_attention_stats": 5, "qkv_attention_bwd": 5}
# kernel symbols in traces (every plan of a kernel); K2's step and its
# solve launch the same kernels (rk4_warp_kernel, rk4_block_kernel); K5b's
# entry launches gn_silu_bwd_kernel_* and then gn_silu_bwd_params (its dγ,
# dβ sums over the batch)
SYMBOL = {"circulant_apply": "circulant_apply", "circulant_rk4_step": "rk4_",
          "circulant_rk4_solve": "rk4_",
          "fused_attention_block": "attn_block_kernel",
          "group_norm_silu": "gn_silu_kernel",
          "group_norm_silu_bwd": "gn_silu_bwd_kernel",
          "qkv_attention": "qkv_attention_kernel",
          "qkv_attention_flash": "flash_fwd_kernel",
          "qkv_attention_stats": "flash_fwd_stats_kernel",
          "qkv_attention_bwd": "flash_bwd_kernel"}
KERNEL_SYMBOLS = (*dict.fromkeys(SYMBOL.values()), "gn_silu_bwd_params")


def log(*a):
    print(*a, flush=True)


def per_forward(route):
    """Kernel launches of one U-Net forward on an AttentionBlock route."""
    fused = route == "auto"
    return {"fused_attention_block": ATTN_BLOCKS if fused else 0,
            "group_norm_silu": GROUP_NORMS + (0 if fused else ATTN_BLOCKS),
            "qkv_attention": 0 if fused else ATTN_BLOCKS,
            "qkv_attention_flash": 0, "qkv_attention_stats": 0,
            "qkv_attention_bwd": 0, "group_norm_silu_bwd": 0}


def serve_want(route):
    forwards = FORWARDS_PER_STEP * STEPS
    return {"circulant_apply": K1_PER_STEP * STEPS, "circulant_rk4_step": 0,
            "circulant_rk4_solve": 0,
            **{k: n * forwards for k, n in per_forward(route).items()}}


def train_want(route):
    # the SSM loss reads the score (the primal) as well as its JVP, so the
    # step's backward runs each GroupNormSiLU's reverse pass once: K5b
    fwd = per_forward(route)
    return {"circulant_apply": K1_PER_TRAIN,
            "circulant_rk4_step": K2_PER_TRAIN,
            "circulant_rk4_solve": K2_SOLVE_PER_TRAIN, **fwd,
            "group_norm_silu_bwd": fwd["group_norm_silu"]}


def cuda_ms(fn, iters=50, warmup=5):
    """Mean milliseconds per call of fn(), from CUDA events around
    `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, product_flops, other_flops):
    """The least time the card could take: the largest of the bytes over
    the memory rate, the matrix-product flops over dense TF32 three times
    over (3xTF32 is how the tensor cores reach fp32 accuracy) and the other
    flops over the fp32 rate outside the tensor cores."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(
                 TF32_PASSES * product_flops / TF32_FLOPS_PER_S,
                 other_flops / FP32_FLOPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


# each cost: (bytes moved, matrix-product flops, other flops)
def k1_cost(b, d):
    # reads sqrt_beta, y, w once and writes out; 6 flops per element
    return 4 * (b + 3 * b * d), 0, 6 * b * d


def k2_cost(b, d):
    # reads sb3, x, w once and writes out; per element 4 stencil stages of
    # 6 flops, 5 for the stage states, 5 for the sum and 2 to combine
    return 4 * (3 * b + 3 * b * d), 0, 36 * b * d


def solve_cost(sel, d, n):
    # what these select counts need: x0 read and kept written once, the z
    # rows of the steps each row takes (sum of sel), the √β table and sel;
    # per element of those steps K2's 36 flops and 1 for the √δ scale
    steps = int(sel.sum().item())
    b = sel.numel()
    return 4 * (steps * d + 2 * b * d + 3 * n) + 8 * b, 0, 37 * steps * d


def k3_cost(b, t, c, heads):
    # products: qkv (2·T·C·3C), q·kᵀ and p·v (4·T²·C), proj (2·T·C²);
    # the GroupNorm, biases, residual (8 per element) and softmax (~5 per
    # score) on the CUDA cores
    nbytes = 4 * (2 * b * t * c + 4 * c * c + 6 * c)
    products = 2 * t * c * 3 * c + 4 * t * t * c + 2 * t * c * c
    return nbytes, b * products, b * (8 * t * c + 5 * heads * t * t)


def k5_cost(b, c, s, silu):
    # reads x, gamma, beta once and writes out; per element 1 flop for the
    # mean, 3 for the variance, 4 for the affine, 4 more for the SiLU
    return 4 * (2 * b * c * s + 2 * c), 0, (8 + 4 * silu) * b * c * s


def k5b_cost(b, c, s, silu):
    # reads x, dy, gamma, beta once, writes dx, dgamma, dbeta; per element
    # 4 flops for the statistics, 4 for x̂ and h, 4 for the sums of g and
    # g·x̂, 6 for d, its sums and dx, 8 more for the SiLU's derivative
    return 4 * (3 * b * c * s + 4 * c), 0, (18 + 8 * silu) * b * c * s


def k6_cost(b, t, c, heads):
    # reads qkv (3C) and writes out (C) per row; 2·T·C each for q·kᵀ and
    # p·v per row; 2 to scale q and k, ~5 per score for the softmax
    return (16 * b * t * c, b * 4 * t * t * c,
            b * (5 * heads * t * t + 2 * t * c))


def k7a_cost(b, t, c, heads):
    # K6's work, and lse written: 4 bytes per head and row
    nbytes, products, other = k6_cost(b, t, c, heads)
    return nbytes + 4 * b * heads * t, products, other


def k7b_cost(b, t, c, heads):
    # reads qkv (3C), dO (C), lse and Δ, writes dqkv (3C) per row;
    # 2·T·ch per score for each of q·kᵀ, dO·vᵀ, pᵀ·dO, dSᵀ·q and dS·k
    # (10·T²·ch per head), ~4 per score for p and dS
    return (4 * b * t * (7 * c + 2 * heads), b * 10 * t * t * c,
            b * 4 * heads * t * t)


def randomize_(module, generator):
    """Random non-zero values for every parameter, in place: weights
    N(0, 1/fan_in), norm scales 1 + N(0, 0.01), biases N(0, 0.01)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            z = torch.randn(p.shape, generator=generator, device=p.device)
            if p.ndim >= 2:
                # DenseParams keep (in, out); Linear and Conv2d lead with out
                fan_in = p.shape[0] if name.endswith(".kernel") else p[0].numel()
                p.copy_(z / fan_in**0.5)
            elif name.endswith("scale"):
                p.copy_(1.0 + 0.1 * z)
            else:
                p.copy_(0.1 * z)


def trace(fn, ops=("GroupNormSiLUBackward",)):
    """Run fn() once (warm) and once under torch.profiler: device time by
    kernel name, the device's busy time (union of kernel intervals), idle
    share of the traced wall time, the device time of PyTorch's own
    elementwise and reduction kernels, and that of the kernels launched
    under each CPU op named in `ops` (outermost spans only)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, without the spans of user annotations (the optimizer
    # step's "Optimizer.step#Adam.step" is recorded on the device's track)
    kernels = [e for e in p.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kernels:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, calls + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    per_launch = {}
    for short in KERNEL_SYMBOLS:
        hits = [(ms, n) for name, (ms, n) in by_name.items() if short in name]
        if hits:
            per_launch[short] = (sum(h[0] for h in hits)
                                 / sum(h[1] for h in hits))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]

    def outermost(e, op):
        parent = e.cpu_parent
        while parent is not None:
            if op in parent.name:
                return False
            parent = parent.cpu_parent
        return op in e.name

    aten_ms = sum(ms for name, (ms, _) in by_name.items()
                  if "at::native::" in name)
    op_ms = {op: sum(e.device_time_total for e in p.events()
                     if e.device_type == DeviceType.CPU and outermost(e, op))
             / 1e3 for op in ops}
    return {
        "wall_ms": wall_ms, "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / 1e3 / wall_ms,
        "kernel_ms_total": sum(ms for ms, _ in by_name.values()),
        "kernel_launches": len(kernels),
        "per_launch_ms": per_launch, "op_device_ms": op_ms,
        "aten_native_ms": aten_ms,
        "top": [{"name": n, "ms": ms, "calls": c} for n, (ms, c) in top],
    }


def log_trace(what, prof):
    log(f"profiled {what}: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms (idle share {prof['idle_share']:.3f}), "
        f"{prof['kernel_launches']} kernels")
    for op, ms in prof["op_device_ms"].items():
        log(f"  {ms:9.3f} ms  device time under {op}")
    log(f"  {prof['aten_native_ms']:9.3f} ms  in PyTorch's own elementwise "
        "and reduction kernels (at::native)")
    for row in prof["top"]:
        log(f"  {row['ms']:9.3f} ms  {row['calls']:5d}x  {row['name'][:90]}")


def kernel_times(fn, reps, tiny=None):
    """Device times (ms) by kernel name over `reps` calls of fn() under
    torch.profiler, each call followed by tiny() if given; one window for
    all calls (a window of a few short kernels can come back empty)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
            if tiny is not None:
                tiny()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(list)
    for e in p.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name].append(e.device_time_total / 1e3)
    return by_name


def device_times(fn, symbol, reps=50):
    """Device time per launch of the kernels whose name holds `symbol`
    over `reps` calls of fn(), each call followed by one tiny PyTorch
    kernel (an add to one float): the smallest PyTorch kernel's mean device
    time in that trace is the card's launch floor for one tiny launch.
    Returns (ms per launch, floor ms, launches per call)."""
    one = torch.zeros(1, device="cuda")
    by_name = kernel_times(fn, reps, lambda: one.add_(1.0))
    mine = [t for name, ts in by_name.items() if symbol in name for t in ts]
    floor = min(sum(ts) / len(ts) for name, ts in by_name.items()
                if "at::native::" in name)
    if not mine:
        raise AssertionError(f"no {symbol} kernel in the trace")
    return sum(mine) / len(mine), floor, len(mine) / reps


def device_per_call(fn, reps):
    """Device time (ms) and kernels per call of fn(), from one trace of
    `reps` calls."""
    by_name = kernel_times(fn, reps)
    return (sum(map(sum, by_name.values())) / reps,
            sum(map(len, by_name.values())) / reps)


@contextlib.contextmanager
def swapped(pairs):
    """Set each (module, name) to its value; restore on exit."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def plain_path():
    """Swap every kernel wrapper for its plain version where the paths
    call it (the plain runs of the replays)."""
    from sdeflow_tpu_torch.models import common as mcommon, unet2d
    from sdeflow_tpu_torch.ops.kernels.attention import attention_math
    from sdeflow_tpu_torch.ops.kernels.attnblock import attn_block_math
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        circ_math, rk4_math_fwd, rk4_solve_select_math)
    from sdeflow_tpu_torch.ops.kernels.groupnorm import gn_math
    from sdeflow_tpu_torch.sde import msgm

    return swapped([(msgm, "circulant_apply", circ_math),
                    (msgm, "circulant_rk4_step", rk4_math_fwd),
                    (msgm, "circulant_rk4_solve_select",
                     rk4_solve_select_math),
                    (unet2d, "fused_attention_block", attn_block_math),
                    (mcommon, "group_norm_silu", gn_math),
                    (unet2d, "attention_core", attention_math)])


def direct_path():
    """Swap every kernel wrapper for a direct launch of its kernel, without
    its autograd.Function, where the serve path calls it (no_grad runs)."""
    from sdeflow_tpu_torch.models import common as mcommon, unet2d
    from sdeflow_tpu_torch.ops.kernels import (
        attention, attnblock, circulant, groupnorm)
    from sdeflow_tpu_torch.sde import msgm

    return swapped([
        (msgm, "circulant_apply", lambda s, y, w: circulant._launch_k1(
            circulant.sqrt_beta_column(s, y), y, w)),
        (unet2d, "fused_attention_block", attnblock._launch),
        (mcommon, "group_norm_silu", groupnorm._launch),
        (unet2d, "attention_core", attention._launch)])


def launch_counts():
    from sdeflow_tpu_torch.ops.kernels import common

    return {k.name: k.launches for k in common.KERNELS.values()}


def gn_mix(model, dev, x=None):
    """(C, S, silu) of every GroupNorm32 call of one forward on x (two
    grf16 latents unless given), counted."""
    from sdeflow_tpu_torch.models.common import GroupNorm32

    seen = collections.Counter()

    def hook(mod, inp):
        seen[(inp[0].shape[1], math.prod(inp[0].shape[2:]), mod.silu)] += 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, GroupNorm32)]
    try:
        with torch.no_grad():
            if x is None:
                x = torch.randn(2, DIM, device=dev)
            model(x, torch.rand(x.shape[0], device=dev))
    finally:
        for h in hooks:
            h.remove()
    return seen


def weighted(rows, key):
    """Mean of rows[i][key] per launch, each row weighted by its calls."""
    n = sum(r["calls_per_forward"] for r in rows)
    return sum(r[key] * r["calls_per_forward"] for r in rows) / n


def gn_args(g, dev, b, c, s, groups):
    return (2.0 * torch.randn(b, c, s, generator=g, device=dev) + 0.5,
            1.0 + 0.1 * torch.randn(c, generator=g, device=dev),
            0.1 * torch.randn(c, generator=g, device=dev), groups)


def k5_rows(g, dev, mix, b, iters=50):
    """K5's times at each (C, S, silu) of a forward's GroupNorm mix at
    batch b, beside its plain version, torch.nn.functional.group_norm and
    the bound."""
    from sdeflow_tpu_torch.models.common import group_count
    from sdeflow_tpu_torch.ops.kernels import groupnorm as gnk

    rows = []
    with torch.no_grad():
        for (c, s, silu), n in sorted(mix.items()):
            torch.cuda.empty_cache()  # each shape from a released cache
            x, gamma, beta, groups = a = gn_args(g, dev, b, c, s,
                                                 group_count(c))
            bound, by = bound_ms(*k5_cost(b, c, s, silu))
            rows.append({
                "shape": [b, c, s], "silu": silu, "calls_per_forward": n,
                "ms": cuda_ms(lambda: gnk.group_norm_silu(*a, silu), iters),
                "direct_ms": cuda_ms(lambda: gnk._launch(*a, silu), iters),
                "plain_ms": cuda_ms(lambda: gnk.gn_math(*a, silu), iters),
                "library_ms": cuda_ms(lambda: torch.nn.functional.group_norm(
                    x, groups, gamma, beta, eps=1e-5), iters),
                "bound_ms": bound, "bound_by": by})
            del x, gamma, beta, a
    return rows


def k5b_rows(g, dev, mix, b, iters=20):
    """K5's backward at each (C, S, silu) of a forward's GroupNorm mix at
    batch b: GroupNormSiLU's backward alone on a retained graph (kernel
    K5b), K5b as a direct launch, its plain version gn_math_vjp, the rule
    it replaced (autograd of the plain forward rerun on detached inputs),
    PyTorch's GroupNorm backward (aten.native_group_norm_backward, given
    the forward's statistics, without the SiLU) and the bound."""
    from sdeflow_tpu_torch.models.common import group_count
    from sdeflow_tpu_torch.ops.kernels import groupnorm as gnk

    aten = torch.ops.aten
    rows = []
    for (c, s, silu), n in sorted(mix.items()):
        torch.cuda.empty_cache()  # each shape from a released cache
        x, gamma, beta, groups = gn_args(g, dev, b, c, s, group_count(c))
        dy = torch.randn(x.shape, generator=g, device=dev)
        ts = [t.requires_grad_() for t in (x, gamma, beta)]
        y = gnk.group_norm_silu(*ts, groups, silu)
        # PyTorch's GroupNorm backward as one call, given the forward's
        # statistics (no SiLU)
        _, mean, rstd = aten.native_group_norm(x.detach(), gamma.detach(),
                                               beta.detach(), b, c, s,
                                               groups, 1e-5)

        def old():
            d = [t.detach().requires_grad_() for t in ts]
            return torch.autograd.grad(gnk.gn_math(*d, groups, silu), d, dy)

        bound, by = bound_ms(*k5b_cost(b, c, s, silu))
        row = {"shape": [b, c, s], "silu": silu, "calls_per_forward": n,
               "ms": cuda_ms(lambda: torch.autograd.grad(
                   y, ts, dy, retain_graph=True), iters),
               "old_ms": cuda_ms(old, iters),
               "bound_ms": bound, "bound_by": by}
        with torch.no_grad():
            row["library_ms"] = cuda_ms(
                lambda: aten.native_group_norm_backward(
                    dy, x, mean, rstd, gamma, b, c, s, groups,
                    [True, True, True]), iters)
            row["direct_ms"] = cuda_ms(lambda: gnk._launch_vjp(
                x, gamma, beta, groups, silu, dy), iters)
            row["plain_ms"] = cuda_ms(lambda: gnk.gn_math_vjp(
                x, gamma, beta, groups, silu, dy), iters)
        rows.append(row)
        del x, gamma, beta, dy, ts, y, mean, rstd
    return rows


def log_k5_rows(what, rows):
    for r in rows:
        old = f"old rule {r['old_ms']:.4f}, " if "old_ms" in r else ""
        log(f"{what} at {r['shape']} silu={r['silu']} "
            f"x{r['calls_per_forward']}: per call {r['ms']:.4f} ms, direct "
            f"{r['direct_ms']:.4f}, plain {r['plain_ms']:.4f}, {old}"
            f"PyTorch's {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
            "ms")


def check_k5(g, dev, mixes):
    """Phase 5: K5 against gn_math and K5b against gn_math_vjp at every
    GroupNorm shape of both grf16 routes (B = 1024) and of the DSM step
    (B = 128), and at odd sizes and the launch plans' edges; both timed at
    the auto route's shapes."""
    from sdeflow_tpu_torch.models.common import group_count
    from sdeflow_tpu_torch.ops.kernels import groupnorm as gnk

    grf = sorted({(c, s) for mix in mixes for c, s, _ in mix})
    dsm = sorted({(c, s) for c, s, _ in SGM_GN_MIX})
    cases = ([(N_SAMPLES, c, s, group_count(c)) for c, s in grf]
             + [(SGM_BATCH, c, s, group_count(c)) for c, s in dsm]
             + K5_ODD + K5_EDGES)
    worst = dict.fromkeys(("out", "dx", "dgamma", "dbeta", "dx_abs"), 0.0)
    with torch.no_grad():
        for b, c, s, groups in cases:
            a = gn_args(g, dev, b, c, s, groups)
            dy = torch.randn(b, c, s, generator=g, device=dev)
            for silu in (False, True):
                out = gnk.group_norm_silu(*a, silu)
                grads = gnk._launch_vjp(*a, silu, dy)
                torch.cuda.synchronize()
                ref = gnk.gn_math(*a, silu)
                torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
                worst["out"] = max(worst["out"],
                                   (out - ref).abs().max().item())
                del out, ref
                # dx against the fp32 plain vjp; dγ, dβ (sums of B·S terms)
                # against the float64 one
                ref_dx = gnk.gn_math_vjp(*a, silu, dy)[0]
                ref64 = gnk.gn_math_vjp(*(t.double() for t in a[:3]),
                                        groups, silu, dy.double())[1:]
                for name, got, want in zip(("dx", "dgamma", "dbeta"), grads,
                                           (ref_dx, *ref64)):
                    scale = want.abs().max().item()
                    torch.testing.assert_close(
                        got.to(want.dtype), want, rtol=1e-5,
                        atol=1e-5 * scale)
                    err = (got.to(want.dtype) - want).abs().max().item()
                    worst[name] = max(worst[name], err / scale)
                    if name == "dx":
                        worst["dx_abs"] = max(worst["dx_abs"], err)
                del grads, ref_dx, ref64
            del a, dy
    log(f"K5 and K5b at {len(cases)} shapes (B = {N_SAMPLES}: {grf}; B = "
        f"{SGM_BATCH}: {dsm}; odd {K5_ODD}; edges {K5_EDGES}), SiLU on and "
        f"off: K5 max |kernel - plain| = {worst['out']:.3g} (tolerance "
        f"1e-5); K5b max |Δ| / max |plain|: dx {worst['dx']:.3g}, dγ "
        f"{worst['dgamma']:.3g} and dβ {worst['dbeta']:.3g} against the "
        "float64 plain vjp (tolerance 1e-5)")
    rows = k5_rows(g, dev, mixes[0], N_SAMPLES)
    log_k5_rows("K5", rows)
    rows_b = k5b_rows(g, dev, mixes[0], N_SAMPLES)
    log_k5_rows("K5b", rows_b)
    return {"max_abs_err": worst["out"], "per_shape": rows,
            "bwd_max_abs_err": worst["dx_abs"],
            "bwd_max_rel_err": {k: worst[k] for k in ("dx", "dgamma",
                                                      "dbeta")},
            "bwd_per_shape": rows_b}


def sdpa_args(qkv, heads):
    """q, k, v as (B, H, T, ch) from the interleaved qkv (B, T, 3C)."""
    b, t, c3 = qkv.shape
    ch = c3 // 3 // heads
    return [a.permute(0, 2, 1, 3).contiguous() for a in
            qkv.reshape(b, t, heads, 3 * ch).split(ch, dim=-1)]


def check_k6(g, dev):
    """Phase 6: K6 (and K4, T > 1024) against attention_math; times with
    one head at the path's shapes and at (4, 4096, 64)."""
    from sdeflow_tpu_torch.ops.kernels import attention as ak

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, long_err = {}, 0.0
    with torch.no_grad():
        for b, t, c, heads in K6_SHAPES + K4_SHAPES:
            qkv = 1.5 * torch.randn(b, t, 3 * c, generator=g, device=dev)
            out = ak.qkv_attention(qkv, heads)
            torch.cuda.synchronize()
            ref = ak.attention_math(qkv, heads)
            tol = 2e-5 if t > 1024 else 1e-5
            if (t, c) == K6_DSM:
                # here the fp32 plain version is itself about 1e-5 from the
                # float64 one: hold the kernel to the plain version run in
                # float64, and print how far the fp32 one is
                ref32 = ref
                ref = ak.attention_math(qkv.double(), heads).float()
                log(f"  plain fp32 at {[b, t, c]}: max |plain - float64| = "
                    f"{(ref32 - ref).abs().max().item():.3g}")
                del ref32
            torch.testing.assert_close(out, ref, rtol=0, atol=tol)
            err = (out - ref).abs().max().item()
            if t > 1024:
                long_err = max(long_err, err)
            log(f"{'K4' if t > 1024 else 'K6'} ({b}, {t}, {c}) heads={heads}:"
                f" max |kernel - plain| = {err:.3g} (tolerance {tol:g})")
            if heads != 1 or (b, t, c, heads) == K4_SHAPES[2]:
                continue
            iters = 50 if b * t * t <= 2**24 else 10
            q, k, v = sdpa_args(qkv, heads)
            lib = sdpa(q, k, v).permute(0, 2, 1, 3).reshape(b, t, c)
            bound, by = bound_ms(*k6_cost(b, t, c, heads))
            rows[(t, c)] = {
                "shape": [b, t, c], "heads": heads, "max_abs_err": err,
                "library_max_abs_diff": (lib - ref).abs().max().item(),
                "ms": cuda_ms(lambda: ak.qkv_attention(qkv, heads), iters),
                "direct_ms": cuda_ms(lambda: ak._launch(qkv, heads), iters),
                "plain_ms": cuda_ms(lambda: ak.attention_math(qkv, heads),
                                    iters),
                "library_ms": cuda_ms(lambda: sdpa(q, k, v), iters),
                "bound_ms": bound, "bound_by": by}
            r = rows[(t, c)]
            log(f"{'K4' if t > 1024 else 'K6'} at {[b, t, c]}: direct "
                f"{r['direct_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
    rows[K4_SHAPES[0][1:3]]["max_abs_err"] = long_err  # over every K4 shape
    return rows


def check_k1(g, dev):
    """Phase 2: K1 against its plain version at every plan's edge, bit for
    bit, with the Python plan mirror held to the compiled chooser; its
    times at the serve shape."""
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        K1, _launch_k1, circ_math, circulant_apply, circulant_plan,
        kernel_plan)

    row = {}
    with torch.no_grad():
        for b, d in K1_SHAPES:
            plan = circulant_plan(b, d)
            if kernel_plan(K1, b, d) != plan:
                raise AssertionError(f"K1 ({b}, {d}): plan mirror {plan} != "
                                     f"{kernel_plan(K1, b, d)}")
            y = torch.randn(b, d, generator=g, device=dev)
            w = torch.randn(b, d, generator=g, device=dev)
            sb = 1.0 + torch.rand(b, 1, generator=g, device=dev)
            out = circulant_apply(sb, y, w)
            torch.cuda.synchronize()
            ref = circ_math(sb, y, w)
            err = (out - ref).abs().max().item()
            log(f"K1 ({b}, {d}) {plan.kind} plan ({plan.per_lane} floats per "
                f"lane, vec {plan.vec}): max |kernel - plain| = {err:.3g}")
            if not torch.equal(out, ref):
                raise AssertionError(f"K1 ({b}, {d}) differs from circ_math")
            if (b, d) == (N_SAMPLES, DIM):
                dev_ms, floor, _ = device_times(lambda: _launch_k1(sb, y, w),
                                                SYMBOL[K1.name])
                bound = bound_ms(*k1_cost(b, d))
                row = {"max_abs_err": err, "shape": [b, d],
                       "plan": plan._asdict(),
                       "ms": cuda_ms(lambda: circulant_apply(sb, y, w), 200),
                       "direct_ms": cuda_ms(lambda: _launch_k1(sb, y, w),
                                            200),
                       "plain_ms": cuda_ms(lambda: circ_math(sb, y, w), 200),
                       "device_ms_alone": dev_ms, "floor_ms": floor,
                       "bound_ms": bound[0], "bound_by": bound[1]}
    log(f"K1 at {row['shape']}: device {row['device_ms_alone']:.5f} ms "
        f"(launch floor {row['floor_ms']:.5f} ms), bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}), per call "
        f"{row['ms']:.4f} ms, direct {row['direct_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms")
    return row


def forward_select(gen, g, b, n):
    """Steps per sample of the SSM loss's forward solve, from the arm's t
    draws as sample_scheme makes them."""
    t = gen.sample_t(g, b)
    sel = torch.clamp(torch.floor(n * t / gen.base_sde.T).long(), 0, n)
    return torch.where(t >= gen.base_sde.T, n, sel)


def step_loop(flow, x0, g, n, sel, z=None):
    """integrate_select's per-step loop as it ran before the whole-solve
    override: per step a draw of normals (unless z gives them), the √δ
    scale, ForwardFlow.rk4_step (three fills of sb3 and kernel K2) and the
    masked select."""
    delta = float(flow.T) / n
    sqrt_delta = delta ** 0.5
    sel = sel.reshape(-1, 1)
    x = kept = x0
    for i in range(n):
        zi = z[i] if z is not None else torch.randn(
            x0.shape, generator=g, device=x0.device)
        x = flow.rk4_step(i * delta, x, delta, sqrt_delta * zi)
        kept = torch.where(sel == i + 1, x, kept)
    return kept


def check_k2(gen, g, dev):
    """Phase 12: K2 against its plain version at every plan's edge, bit for
    bit, with the plan mirror held to the compiled chooser, its times at
    the training shape, the forward flow's fused step against the generic
    stages on the plain versions, and K2's solve (check_solve)."""
    from sdeflow_tpu_torch.ops.integrators import rk4_step
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        K2, _launch_k2, circulant_rk4_step, kernel_plan, rk4_math_fwd,
        rk4_plan)
    from sdeflow_tpu_torch.sde import ForwardFlow

    row = {}
    delta = 1.0 / TRAIN_STEPS
    with torch.no_grad():
        for b, d in K2_SHAPES:
            plan = rk4_plan(b, d)
            if kernel_plan(K2, b, d) != plan:
                raise AssertionError(f"K2 ({b}, {d}): plan mirror {plan} != "
                                     f"{kernel_plan(K2, b, d)}")
            x = torch.randn(b, d, generator=g, device=dev)
            w = delta**0.5 * torch.randn(b, d, generator=g, device=dev)
            sb3 = 1.0 + torch.rand(b, 3, generator=g, device=dev)
            out = circulant_rk4_step(sb3, x, w)
            torch.cuda.synchronize()
            ref = rk4_math_fwd(sb3, x, w)
            err = (out - ref).abs().max().item()
            log(f"K2 ({b}, {d}) {plan.kind} plan ({plan.per_lane} floats per "
                f"lane, vec {plan.vec}): max |kernel - plain| = {err:.3g}")
            if not torch.equal(out, ref):
                raise AssertionError(f"K2 ({b}, {d}) differs from "
                                     "rk4_math_fwd")
            if (b, d) == (TRAIN_BATCH, DIM):
                dev_ms, floor, _ = device_times(
                    lambda: _launch_k2(sb3, x, w), SYMBOL[K2.name])
                bound = bound_ms(*k2_cost(b, d))
                row = {"max_abs_err": err, "shape": [b, d],
                       "plan": plan._asdict(),
                       "ms": cuda_ms(lambda: circulant_rk4_step(sb3, x, w),
                                     200),
                       "plain_ms": cuda_ms(lambda: rk4_math_fwd(sb3, x, w),
                                           200),
                       "direct_ms": cuda_ms(lambda: _launch_k2(sb3, x, w),
                                            200),
                       "device_ms_alone": dev_ms, "floor_ms": floor,
                       "bound_ms": bound[0], "bound_by": bound[1]}
        log(f"K2 at {row['shape']}: device {row['device_ms_alone']:.5f} ms "
            f"(launch floor {row['floor_ms']:.5f} ms), bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}), per call "
            f"{row['ms']:.4f} ms, direct {row['direct_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms")
        flow = ForwardFlow(base_sde=gen.base_sde, T=gen.base_sde.T)
        x = gen.latent_sample(g, TRAIN_BATCH)
        dw = delta**0.5 * torch.randn(x.shape, generator=g, device=dev)
        for t in (0.0, 0.5, 1.0 - delta):
            fused = flow.rk4_step(t, x, delta, dw)
            with plain_path():
                generic = rk4_step(flow, t, x, delta, dw)
            torch.testing.assert_close(fused, generic, rtol=1e-6, atol=1e-6)
            log(f"ForwardFlow.rk4_step at t={t:.4f} (K2) vs generic stages "
                f"(plain): max |Δ| = {(fused - generic).abs().max().item():.3g}")
    return row, check_solve(gen, g, dev)


def check_solve(gen, g, dev):
    """K2's solve at the SSM loss's (64, 128, 256) on the grf16 SDE, with
    the steps per row from grf16's t draws and the edge cases (all 0, all
    64): bit for bit against step_loop on the same normals (a K2 launch
    per step), within 1e-6 of rk4_solve_select_math; its device time per
    select case (the per-row step counts beside it: rows near 64 set a
    latency-bound launch); then against the loop: device time from traces
    and wall time per solve with the loop's draws, fills and selects."""
    from sdeflow_tpu_torch.ops.integrators import integrate_select
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        K2, K2_SOLVE, _launch_solve, circulant_rk4_solve_select, kernel_plan,
        rk4_plan, rk4_solve_select_math)
    from sdeflow_tpu_torch.sde import ForwardFlow
    from sdeflow_tpu_torch.sde.msgm import sqrt_beta_table

    sde = gen.base_sde
    n, b = sde.num_steps_forward, TRAIN_BATCH
    if n != TRAIN_STEPS:
        raise AssertionError(f"grf16's forward solve takes {n} steps")
    if kernel_plan(K2, b, DIM) != rk4_plan(b, DIM):
        raise AssertionError("K2's plan mirror differs at the solve's shape")
    flow = ForwardFlow(base_sde=sde, T=sde.T)
    delta = float(sde.T) / n
    sd = delta ** 0.5
    sb = sqrt_beta_table(sde.beta_min, sde.beta_max, delta, n, dev,
                         torch.float32)
    x0 = gen.latent_sample(g, b)
    z = torch.randn(n, b, DIM, generator=g, device=dev)
    cases = {"grf16 t draws": forward_select(gen, g, b, n),
             "all 0": torch.zeros(b, dtype=torch.int64, device=dev),
             f"all {n}": torch.full((b,), n, dtype=torch.int64, device=dev)}
    rec = {"shape": [n, b, DIM], "cases": {}}
    with torch.no_grad():
        for name, sel in cases.items():
            before = K2_SOLVE.launches
            got = circulant_rk4_solve_select(x0, z, sb, sel, sd)
            torch.cuda.synchronize()
            if K2_SOLVE.launches != before + 1:
                raise AssertionError("the solve did not launch once")
            loop = step_loop(flow, x0, None, n, sel, z)
            via = integrate_select(flow, x0, None, n, sel, noise=z)
            plain = rk4_solve_select_math(x0, z, sb, sel, sd)
            err_loop = (got - loop).abs().max().item()
            err_plain = (got - plain).abs().max().item()
            if not (torch.equal(got, loop) and torch.equal(via, got)):
                raise AssertionError(f"solve ({name}) differs from the K2 "
                                     f"loop: {err_loop:.3g}")
            torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)
            dev_ms, floor, _ = device_times(
                lambda: _launch_solve(x0, z, sb, sel, sd), SYMBOL[K2_SOLVE.name])
            bound = bound_ms(*solve_cost(sel, DIM, n))
            rec["cases"][name] = {
                "max_abs_err_loop": err_loop, "max_abs_err": err_plain,
                "steps_max": int(sel.max().item()),
                "steps_mean": sel.double().mean().item(),
                "device_ms": dev_ms, "floor_ms": floor,
                "bound_ms": bound[0], "bound_by": bound[1]}
            log(f"K2 solve {tuple(rec['shape'])}, {name} (steps per row: max "
                f"{int(sel.max())}, mean {sel.double().mean().item():.2f}): "
                f"max |solve - K2 loop| = {err_loop:.3g}, max |solve - plain| "
                f"= {err_plain:.3g}; device {dev_ms:.5f} ms (launch floor "
                f"{floor:.5f} ms), bound {bound[0]:.5f} ms ({bound[1]})")
        sel = cases["grf16 t draws"]
        rec.update(rec["cases"]["grf16 t draws"])
        rec["ms"] = cuda_ms(lambda: circulant_rk4_solve_select(
            x0, z, sb, sel, sd), 100)
        rec["direct_ms"] = cuda_ms(lambda: _launch_solve(x0, z, sb, sel, sd),
                                   100)
        rec["plain_ms"] = cuda_ms(lambda: rk4_solve_select_math(
            x0, z, sb, sel, sd), 5, 1)
        rec["loop_ms"] = cuda_ms(lambda: step_loop(flow, x0, None, n, sel, z),
                                 5, 1)
        # with the draws: the override's one randn, the loop's 64
        rec["solve_wall_ms"] = cuda_ms(lambda: integrate_select(
            flow, x0, g, n, sel), 20, 2)
        rec["loop_wall_ms"] = cuda_ms(lambda: step_loop(flow, x0, g, n, sel),
                                      5, 1)
        # device time and kernels per solve, with the draws
        rec["solve_device_ms"], rec["solve_kernels"] = device_per_call(
            lambda: integrate_select(flow, x0, g, n, sel), 20)
        rec["loop_device_ms"], rec["loop_kernels"] = device_per_call(
            lambda: step_loop(flow, x0, g, n, sel), 5)
    log(f"K2 solve vs the per-step K2 loop on the same normals: per call "
        f"{rec['ms']:.4f} ms (direct {rec['direct_ms']:.4f}), loop "
        f"{rec['loop_ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms; with the "
        f"draws {rec['solve_wall_ms']:.4f} against {rec['loop_wall_ms']:.3f} "
        f"ms per solve, device time {rec['solve_device_ms']:.4f} ms in "
        f"{rec['solve_kernels']:g} kernels against "
        f"{rec['loop_device_ms']:.4f} ms in {rec['loop_kernels']:g}")
    return rec


def check_trajectory(gen, g, dev):
    """Phase 14's forward trajectory (sample_scheme_allt, the ssm_intT
    loss's solve, K2's step path) at batch 128: exactly one K2 step launch
    per forward step and no solve; with injected normals its last state
    equals K2's solve taking every step, bit for bit."""
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        circulant_rk4_solve_select)
    from sdeflow_tpu_torch.sde.msgm import sqrt_beta_table

    sde = gen.base_sde
    n, b = sde.num_steps_forward, TRAIN_BATCH
    x0 = gen.latent_sample(g, b)
    want = {k.name: 0 for k in common.KERNELS.values()}
    want["circulant_rk4_step"] = n
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = sde.sample_scheme_allt(g, x0, include_t0=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    if counts != want:
        raise AssertionError(f"forward trajectory launched {counts}")
    if tuple(traj.shape) != (n, b, DIM) or not torch.isfinite(traj).all():
        raise AssertionError(f"bad trajectory {tuple(traj.shape)}")
    z = torch.randn(n, b, DIM, generator=g, device=dev)
    delta = float(sde.T) / n
    with torch.no_grad():
        last = sde.sample_scheme_allt(None, x0, include_t0=False, noise=z)[-1]
        solve = circulant_rk4_solve_select(
            x0, z, sqrt_beta_table(sde.beta_min, sde.beta_max, delta, n, dev,
                                   torch.float32),
            torch.full((b,), n, dtype=torch.int64, device=dev), delta ** 0.5)
    if not torch.equal(last, solve):
        raise AssertionError("the trajectory's last state differs from the "
                             "solve's")
    log(f"forward trajectory ({n}, {b}, {DIM}): {dt * 1e3:.2f} ms, launches "
        f"{counts}, last state equal to K2's solve")
    return {"ms": dt * 1e3, "launches": counts}


def through_autograd(fn, args, seed):
    """fn's jvp (random tangents on every argument) and the gradients of
    sum(fn(args)·c) for a random cotangent c."""
    gen = torch.Generator(device=args[0].device).manual_seed(seed)

    def draw(a):
        return torch.randn(a.shape, generator=gen, device=a.device)

    out, tan = torch.func.jvp(fn, tuple(args), tuple(map(draw, args)))
    diff = [a.detach().requires_grad_() for a in args]
    grads = torch.autograd.grad((fn(*diff) * draw(out)).sum(), diff)
    return (out, tan, *grads)


def block_args(g, dev, b, t, c):
    return [2.0 * torch.randn(b, t, c, generator=g, device=dev) + 0.5,
            1.0 + 0.1 * torch.randn(c, generator=g, device=dev),
            0.1 * torch.randn(c, generator=g, device=dev),
            torch.randn(c, 3 * c, generator=g, device=dev) / c**0.5,
            0.1 * torch.randn(3 * c, generator=g, device=dev),
            torch.randn(c, c, generator=g, device=dev) / c**0.5,
            0.1 * torch.randn(c, generator=g, device=dev)]


def double_backward(fn, args, seed):
    """∂/∂args of <∂L/∂args[0], v> with L = Σ c·fn(args)² (c, v random):
    a second reverse pass, through create_graph."""
    gen = torch.Generator(device=args[0].device).manual_seed(seed)
    xs = [a.detach().requires_grad_() for a in args]
    out = fn(*xs)
    cot = torch.randn(out.shape, generator=gen, device=out.device)
    (g0,) = torch.autograd.grad((cot * out**2).sum(), xs[0],
                                create_graph=True)
    v = torch.randn(g0.shape, generator=gen, device=g0.device)
    return torch.autograd.grad((g0 * v).sum(), xs, allow_unused=True,
                               materialize_grads=True)


def check_autograd(g, dev):
    """Phase 13: jvp, grad and a double backward through each kernel's
    Function (kernel forward, plain rules; the second pass through the
    differentiable plain backward) against the plain version; a ResBlock's
    gradient through its JVP on cuDNN and K5 against the CPU."""
    from sdeflow_tpu_torch.models.unet2d import ResBlock
    from sdeflow_tpu_torch.ops.kernels.attention import (
        attention_math, qkv_attention)
    from sdeflow_tpu_torch.ops.kernels.attnblock import (
        attn_block_math, fused_attention_block)
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        circ_math, circulant_apply, circulant_rk4_solve_select,
        circulant_rk4_step, rk4_math_fwd, rk4_solve_select_math)
    from sdeflow_tpu_torch.ops.kernels.groupnorm import (
        K5B, gn_math, group_norm_silu)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    b, d = TRAIN_BATCH, DIM
    cases = [
        ("K1", circulant_apply, circ_math,
         [1.0 + rnd(b, 1).abs(), rnd(b, d), rnd(b, d)], 1e-6),
        ("K2", circulant_rk4_step, rk4_math_fwd,
         [1.0 + rnd(b, 3).abs(), rnd(b, d), 0.125 * rnd(b, d)], 1e-6)]
    # K2's solve over 8 steps, rows taking 0 to 8 of them
    sel = torch.randint(0, 9, (b,), generator=g, device=dev)
    cases.append(("K2 solve",
                  lambda *a: circulant_rk4_solve_select(*a, sel, 0.125),
                  lambda *a: rk4_solve_select_math(*a, sel, 0.125),
                  [rnd(b, d), rnd(8, b, d), 1.0 + rnd(8, 3).abs()], 1e-6))
    for t, c in BLOCK_MIX:
        cases.append((f"K3 ({b}, {t}, {c})",
                      lambda *a: fused_attention_block(*a, 32, 1),
                      lambda *a: attn_block_math(*a, 32, 1),
                      block_args(g, dev, b, t, c), 1e-5))
        cases.append((f"K6 ({b}, {t}, {c})",
                      lambda q: qkv_attention(q, 1),
                      lambda q: attention_math(q, 1),
                      [1.5 * rnd(b, t, 3 * c)], 1e-5))
    for c, s, silu in [(32, 256, True), (192, 16, True), (64, 64, False)]:
        cases.append((f"K5 ({b}, {c}, {s}) silu={silu}",
                      lambda *a, silu=silu: group_norm_silu(*a, 32, silu),
                      lambda *a, silu=silu: gn_math(*a, 32, silu),
                      [2.0 * rnd(b, c, s) + 0.5, 1.0 + 0.1 * rnd(c),
                       0.1 * rnd(c)], 1e-5))
    errs = {}
    for name, kern, plain, args, tol in cases:
        before = K5B.launches
        got = through_autograd(kern, args, 1) + double_backward(kern, args, 2)
        # K5's gradient (grad mode off) through K5b, and the double
        # backward's second pass, which reaches the Function's output
        # through the cotangent c·2·out (its own second-order terms run
        # through the plain version's differentiable vjp)
        if K5B.launches - before != 2 * name.startswith("K5"):
            raise AssertionError(f"{name}: K5b launched "
                                 f"{K5B.launches - before} times")
        want = (through_autograd(plain, args, 1)
                + double_backward(plain, args, 2))
        worst = 0.0
        for a, w in zip(got, want):  # output, tangent, gradients, second
            scale = max(w.abs().max().item(), 1e-30)
            torch.testing.assert_close(a, w, rtol=tol, atol=tol * scale)
            worst = max(worst, (a - w).abs().max().item() / scale)
        errs[name] = worst
        log(f"{name} through jvp, grad and double backward: max |Δ| / "
            f"max |plain| = {worst:.3g} (tolerance {tol:g})")
    # reverse over forward through cuDNN's convolutions and K5, fp32
    # without TF32
    torch.manual_seed(0)
    block = ResBlock(64, 128)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    xs, emb = torch.randn(16, 64, 8, 8), torch.randn(16, 128)
    vs = torch.randn_like(xs)

    def grads(m, *a):
        _, tan = torch.func.jvp(lambda z: m(z, a[1]), (a[0],), (a[2],))
        return torch.autograd.grad((tan * a[2]).sum(), list(m.parameters()),
                                   allow_unused=True, materialize_grads=True)

    ref = grads(block, xs, emb, vs)
    got = grads(block.to(dev), xs.to(dev), emb.to(dev), vs.to(dev))
    gmax = max(r.abs().max().item() for r in ref)
    # the output bias does not reach the tangent: its gradient is 0
    worst = max((a.cpu() - r).abs().max().item()
                / max(r.abs().max().item(), 1e-6 * gmax)
                for a, r in zip(got, ref))
    log(f"ResBlock grad of its JVP, cuDNN and K5 vs CPU: max |Δ| / max |g| "
        f"= {worst:.3g} (tolerance 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError(f"ResBlock reverse over forward: {worst:.3g}")
    errs["ResBlock"] = worst
    return errs


def train_draws(gen, sampler, g, dev):
    from sdeflow_tpu_torch.ops.hutchinson import sample_v

    b = TRAIN_BATCH
    x = sampler.sample(g, b)
    return x, dict(
        t=gen.sample_t(g, b),
        noise=torch.randn(TRAIN_STEPS, b, DIM, generator=g, device=dev),
        noise_one=torch.randn(b, DIM, generator=g, device=dev),
        v=sample_v(g, (b, DIM), gen.vtype, device=dev))


def train_agreement(model, per_sample, g, x, draws, want):
    """On one batch with injected draws: the kernel path's loss
    (per_sample(g, x, **draws).mean(), the SSM or DSM loss) and every
    parameter gradient against the plain path's, the kernel path's exact
    launch counts, and each path's peak memory."""
    from sdeflow_tpu_torch.ops.kernels import common

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = per_sample(g, x, **draws).mean()
        loss.backward()
        torch.cuda.synchronize()
        peak.append(torch.cuda.max_memory_allocated())
        return loss.detach(), {n: p.grad.detach().clone()
                               for n, p in model.named_parameters()}

    peak = []
    common.reset_launches()
    loss_k, grads_k = loss_and_grads()
    if launch_counts() != want:
        raise AssertionError(f"kernel loss launched {launch_counts()}")
    common.reset_launches()
    with plain_path():
        loss_p, grads_p = loss_and_grads()
    if any(launch_counts().values()):
        raise AssertionError(f"plain loss launched {launch_counts()}")
    model.zero_grad(set_to_none=True)
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    gmax = max(v.abs().max().item() for v in grads_p.values())
    worst, worst_name, dead = 0.0, None, 0
    for n, gp in grads_p.items():
        scale = gp.abs().max().item()
        if scale < 1e-6 * gmax:  # no gradient in exact arithmetic
            scale, dead = gmax, dead + 1
        ratio = (grads_k[n] - gp).abs().max().item() / scale
        if ratio > worst:
            worst, worst_name = ratio, n
    log(f"train loss kernel {loss_k.item():.6f}, plain {loss_p.item():.6f} "
        f"(rel {rel_loss:.3g}, tolerance 1e-4); worst gradient max |Δ| / "
        f"max |g| = {worst:.3g} at {worst_name} (tolerance 1e-3; {dead} of "
        f"{len(grads_p)} tensors have no gradient in exact arithmetic); "
        f"peak memory kernel {peak[0] / 2**20:.1f} MiB, plain "
        f"{peak[1] / 2**20:.1f} MiB")
    if not (torch.isfinite(loss_k) and rel_loss <= 1e-4 and worst <= 1e-3):
        raise AssertionError("kernel and plain training paths disagree")
    return {"loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
            "loss_rel": rel_loss, "grad_worst_rel": worst,
            "grad_worst": worst_name, "grad_tensors": len(grads_p),
            "grad_tensors_zero": dead, "peak_memory_kernel": peak[0],
            "peak_memory_plain": peak[1]}


def timed_train_steps(step, model, n, want, batch=TRAIN_BATCH):
    """n bare train steps, each with exactly `want` launches; ms per step,
    peak memory, the losses, and that the parameters moved."""
    from sdeflow_tpu_torch.ops.kernels import common

    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    losses, counts = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(step())
        counts.append(launch_counts())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    if any(c != want for c in per_step):
        raise AssertionError(f"launches per train step {per_step} != {want}")
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError("non-finite training loss")
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(model.parameters(), before))
    if not moved > 0:
        raise AssertionError("the parameters did not move")
    rec = dict(ms_per_step=dt * 1e3 / n, steps_per_s=n / dt,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches_per_step=per_step[-1],
               losses=[v.item() for v in losses], param_moved=moved)
    log(f"{n} train steps at batch {batch}: {rec['ms_per_step']:.2f} "
        f"ms/step, {rec['steps_per_s']:.2f} steps/s, peak memory "
        f"{rec['max_memory_allocated'] / 2**20:.1f} MiB, launches per step "
        f"{per_step[-1]}, loss {losses[0].item():.3f} -> "
        f"{losses[-1].item():.3f}")
    return rec


def check_training(cfg, model, gen, g, dev):
    """Phase 14: the kernel path against the plain path on one batch, the
    driver's Trainer, timed bare train steps with their launch counts, and
    the plain, kernel, kernel, plain replay of a train step."""
    from sdeflow_tpu_torch import train_msgm_arm
    from sdeflow_tpu_torch.experiments.driver import make_data_sampler
    from sdeflow_tpu_torch.ops.kernels import common

    b = cfg.sweep.batch_sizes[0]
    if (b, cfg.train.num_steps_forward) != (TRAIN_BATCH, TRAIN_STEPS):
        raise AssertionError("grf16 trains at batch 128 with 64 steps")
    want = train_want("auto")
    assert set(want) == set(common.KERNELS)
    sampler = make_data_sampler(cfg, DIM, dev)
    x, draws = train_draws(gen, sampler, g, dev)
    rec = {"agreement": train_agreement(model, gen.ssm, g, x, draws, want)}

    # the driver's Trainer: three steps with ELBO prints at 1 and 3
    t0 = time.perf_counter()
    trainer, _, loss = train_msgm_arm(cfg, g, iterations=WARM_STEPS,
                                      arm=(model, gen), x_test=x, device=dev,
                                      log_fn=log)
    torch.cuda.synchronize()
    rec["trainer_s"] = time.perf_counter() - t0
    if not (trainer.state.step == WARM_STEPS and math.isfinite(loss)):
        raise AssertionError(f"Trainer: step {trainer.state.step}, {loss}")

    def step():
        xb = sampler.sample(g, b)
        return trainer.train_step(trainer.state, g, xb)[1]

    rec.update(timed_train_steps(step, model, TIMED_STEPS, want))

    replay = []
    for mode in ("plain", "kernel", "kernel", "plain"):
        ctx = plain_path() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            common.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REPLAY_STEPS):
                step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        expect = {k: (n * REPLAY_STEPS if mode == "kernel" else 0)
                  for k, n in want.items()}
        if launch_counts() != expect:
            raise AssertionError(f"{mode} replay launched {launch_counts()}")
        replay.append({"mode": mode, "ms_per_step": dt * 1e3 / REPLAY_STEPS})
        log(f"{mode} train replay: {dt * 1e3 / REPLAY_STEPS:.2f} ms/step")
    rec["replay"] = replay
    return rec, step


def serve_runs(sample, g, x0, noise, ref, modes, want):
    """Runs of `sample` on x0 and noise in the given modes ("kernel",
    "direct", "plain"): launches exactly `want` (none when plain), and
    max |ref - run| ≤ 1e-3·max |run|."""
    from sdeflow_tpu_torch.ops.kernels import common

    swaps = {"plain": plain_path, "direct": direct_path,
             "kernel": contextlib.nullcontext}
    runs = []
    for mode in modes:
        with swaps[mode]():
            common.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_r = sample(g, x0=x0, noise=noise)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launched = launch_counts()
        if launched != (want if mode != "plain" else
                        {k: 0 for k in launched}):
            raise AssertionError(f"{mode} replay launched {launched}")
        rel = ((ref - x_r).abs().max() / x_r.abs().max()).item()
        log(f"{mode} replay: {dt * 1e3:.1f} ms; max |request - replay| / "
            f"max |x| = {rel:.3g}")
        if not rel <= 1e-3:
            raise AssertionError(f"{mode} replay disagrees: {rel:.3g}")
        runs.append({"mode": mode, "ms": dt * 1e3, "rel_err": rel})
    return runs


def in_turns(fns, reps=1):
    """Wall ms per call of fns["auto"] and fns["unfused"], in the turns
    auto, unfused, unfused, auto (each turn `reps` calls)."""
    out = {k: [] for k in fns}
    for k in ("auto", "unfused", "unfused", "auto"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fns[k]()
        torch.cuda.synchronize()
        out[k].append((time.perf_counter() - t0) * 1e3 / reps)
    log(f"in turns, ms per call: auto {out['auto']}, unfused "
        f"{out['unfused']}")
    return out


def serve_unfused(cfg, gen_u, g, dev, x0, noise, x_auto, sample_auto):
    """Phase 10: one request on the unfused route, its replays, the two
    routes' requests in turns, and a traced 2-step request."""
    from sdeflow_tpu_torch import make_sampler_fn
    from sdeflow_tpu_torch.ops.kernels import common

    want = serve_want("unfused")
    sample = make_sampler_fn(gen_u, N_SAMPLES, DIM, STEPS,
                             method=cfg.sweep.backward_method,
                             norm_correction=True, device=dev)
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = sample(g, x0=x0, noise=noise)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    if not torch.isfinite(x).all() or tuple(x.shape) != (N_SAMPLES, DIM):
        raise AssertionError(f"unfused request: bad samples {tuple(x.shape)}")
    torch.testing.assert_close(x.norm(dim=1), x0.norm(dim=1), rtol=1e-5,
                               atol=0)
    if launches != want:
        raise AssertionError(f"unfused request: launches {launches} != {want}")
    rel = ((x - x_auto).abs().max() / x_auto.abs().max()).item()
    log(f"unfused request: {dt * 1e3:.1f} ms, {N_SAMPLES / dt:.1f} samples/s,"
        f" launches {launches}; max |unfused - auto| / max |x| = {rel:.3g}")
    if not rel <= 1e-3:
        raise AssertionError(f"the unfused and auto routes disagree: {rel:.3g}")
    rec = {"request": {"ms": dt * 1e3, "samples_per_s": N_SAMPLES / dt,
                       "launches": launches, "rel_to_auto": rel}}
    rec["replay"] = serve_runs(sample, g, x0, noise, x, (
        "plain", "kernel", "direct", "direct", "kernel", "plain"), want)
    rec["in_turns"] = in_turns({
        "auto": lambda: sample_auto(g, x0=x0, noise=noise),
        "unfused": lambda: sample(g, x0=x0, noise=noise)})
    sample2 = make_sampler_fn(gen_u, N_SAMPLES, DIM, PROFILED_STEPS,
                              method="rk4", norm_correction=True, device=dev)
    rec["profile"] = dict(trace(lambda: sample2(g)), steps=PROFILED_STEPS)
    log_trace(f"{PROFILED_STEPS} unfused RK4 steps", rec["profile"])
    return rec


def train_unfused(cfg, model_u, gen_u, g, dev, step_auto):
    """Phase 16: the unfused route's training: agreement with the plain
    path, timed bare train steps, steps of both routes in turns and a
    traced step."""
    from sdeflow_tpu_torch.experiments.driver import (
        make_data_sampler, make_trainer)

    want = train_want("unfused")
    sampler = make_data_sampler(cfg, DIM, dev)
    x, draws = train_draws(gen_u, sampler, g, dev)
    rec = {"agreement": train_agreement(model_u, gen_u.ssm, g, x, draws,
                                        want)}
    trainer = make_trainer(cfg, gen_u, sampler, TRAIN_BATCH, log_fn=log)

    def step():
        xb = sampler.sample(g, TRAIN_BATCH)
        return trainer.train_step(trainer.state, g, xb)[1]

    step()  # warm
    rec.update(timed_train_steps(step, model_u, TIMED_STEPS_UNFUSED, want))
    rec["in_turns"] = in_turns({"auto": step_auto, "unfused": step},
                               REPLAY_STEPS)
    rec["profile"] = trace(step)
    log_trace("one unfused train step", rec["profile"])
    return rec


def check_long_attention(g, dev):
    """Phase 11: one unfused AttentionBlock at T = 4096: the forward under
    no_grad (the attention core K4), a jvp and a gradient with the block's
    parameters requiring grad (the pair K7a/K7b) against the plain path,
    with their launch counts, and a trace of three no-grad forwards."""
    from sdeflow_tpu_torch.models.unet2d import AttentionBlock
    from sdeflow_tpu_torch.ops.kernels import common

    b, c, h, w = LONG_BLOCK
    block = AttentionBlock(c, 1, "unfused").to(dev)
    randomize_(block, g)
    x = 2.0 * torch.randn(b, c, h, w, generator=g, device=dev) + 0.5
    v = torch.randn(x.shape, generator=g, device=dev)
    cot = torch.randn(x.shape, generator=g, device=dev)
    params = list(block.parameters())

    def run():
        with torch.no_grad():
            out = block(x)
        _, tan = torch.func.jvp(block, (x,), (v,))
        xg = x.detach().requires_grad_()
        grads = torch.autograd.grad((block(xg) * cot).sum(), [xg, *params])
        return out, tan, grads

    common.reset_launches()
    out, tan, grads = run()
    torch.cuda.synchronize()
    launched = launch_counts()
    want = {k: 0 for k in launched}
    # K5 in each of the three; K4 in the no-grad forward; K7a in the jvp
    # and in the gradient's forward; K7b and K5b in the gradient's backward
    want.update(group_norm_silu=3, qkv_attention_flash=1,
                qkv_attention_stats=2, qkv_attention_bwd=1,
                group_norm_silu_bwd=1)
    if launched != want:
        raise AssertionError(f"long attention launched {launched} != {want}")
    with plain_path():
        out_p, tan_p, grads_p = run()
    errs = {}
    for name, a, r, tol in [("output", out, out_p, 2e-5),
                            ("tangent", tan, tan_p, 2e-5),
                            *[(f"grad {i}", a, r, 1e-4) for i, (a, r)
                              in enumerate(zip(grads, grads_p))]]:
        errs[name] = (a - r).abs().max().item() / r.abs().max().item()
        if not errs[name] <= tol:
            raise AssertionError(f"long attention {name}: {errs[name]:.3g}")
    log(f"unfused AttentionBlock at (B, C, H, W) = {LONG_BLOCK}, T = {h * w}:"
        f" launches {launched}; max |Δ| / max |plain|: output "
        f"{errs['output']:.3g}, tangent {errs['tangent']:.3g} (tolerance "
        f"2e-5), gradients {max(v for k, v in errs.items() if 'grad' in k):.3g}"
        " (tolerance 1e-4)")
    with torch.no_grad():
        prof = trace(lambda: [block(x) for _ in range(3)])
    log_trace("three forwards of the T = 4096 block", prof)
    return {"launches": launched, "rel_err": errs, "profile": prof}


def check_flash(g, dev):
    """Phase 17: K7a and K7b against their plain versions at K7_SHAPES, and
    their times at the first beside the bound and SDPA's forward and
    backward."""
    from sdeflow_tpu_torch.ops.kernels import attention as ak

    sdpa = torch.nn.functional.scaled_dot_product_attention
    errs = {"out": 0.0, "lse": 0.0, "dqkv": 0.0}
    rows = {}
    for b, t, c, heads in K7_SHAPES:
        qkv = 1.5 * torch.randn(b, t, 3 * c, generator=g, device=dev)
        dout = torch.randn(b, t, c, generator=g, device=dev)
        with torch.no_grad():
            out, lse = ak._launch_stats(qkv, heads)
            torch.cuda.synchronize()
            out_p, lse_p = ak.attention_flash_stats_math(qkv, heads)
            delta = (ak._heads(dout, heads) * ak._heads(out_p, heads)).sum(-1)
            dqkv = ak._launch_bwd(qkv, dout, lse_p, delta, heads)
            torch.cuda.synchronize()
            dqkv_p = ak.attention_flash_bwd_math(qkv, dout, lse_p, delta,
                                                 heads)
        e = {"out": ((out - out_p).abs().max() / out_p.abs().max()).item(),
             "lse": (lse - lse_p).abs().max().item(),
             "dqkv": ((dqkv - dqkv_p).abs().max()
                      / dqkv_p.abs().max()).item()}
        log(f"K7a/K7b ({b}, {t}, {c}) heads={heads}: max |Δ| / max |plain| "
            f"out {e['out']:.3g} (tolerance 2e-5), lse max |Δ| "
            f"{e['lse']:.3g} (1e-5), dqkv {e['dqkv']:.3g} (1e-4)")
        if not (e["out"] <= 2e-5 and e["lse"] <= 1e-5 and e["dqkv"] <= 1e-4):
            raise AssertionError(f"K7a/K7b disagree with plain: {e}")
        errs = {k: max(v, e[k]) for k, v in errs.items()}
        if (b, t, c, heads) != K7_SHAPES[0]:
            continue
        # per call through the Function: its forward (no_grad), and its
        # backward alone (Δ, then K7b) on a retained graph
        x = qkv.detach().requires_grad_()
        y = ak.flash_attention_vjp(x, heads)
        q, k, v = (a.requires_grad_() for a in sdpa_args(qkv, heads))
        o = sdpa(q, k, v)
        do = ak._heads(dout, heads).contiguous()
        bound_7a = bound_ms(*k7a_cost(b, t, c, heads))
        bound_7b = bound_ms(*k7b_cost(b, t, c, heads))
        with torch.no_grad():
            rows["K7a"] = {
                "shape": [b, t, c], "heads": heads,
                "ms": cuda_ms(lambda: ak.flash_attention_vjp(qkv, heads)),
                "direct_ms": cuda_ms(lambda: ak._launch_stats(qkv, heads)),
                "plain_ms": cuda_ms(
                    lambda: ak.attention_flash_stats_math(qkv, heads)),
                "library_ms": cuda_ms(lambda: sdpa(q, k, v)),
                "bound_ms": bound_7a[0], "bound_by": bound_7a[1]}
            rows["K7b"] = {
                "shape": [b, t, c], "heads": heads,
                "direct_ms": cuda_ms(lambda: ak._launch_bwd(
                    qkv, dout, lse_p, delta, heads)),
                "plain_ms": cuda_ms(lambda: ak.attention_flash_bwd_math(
                    qkv, dout, lse_p, delta, heads), 10),
                "bound_ms": bound_7b[0], "bound_by": bound_7b[1]}
        rows["K7b"]["ms"] = cuda_ms(lambda: torch.autograd.grad(
            y, x, dout, retain_graph=True))
        rows["K7b"]["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o, (q, k, v), do, retain_graph=True))
    rows["K7a"].update(max_abs_err=errs["out"], lse_max_abs_err=errs["lse"])
    rows["K7b"]["max_abs_err"] = errs["dqkv"]
    # at the DSM path's own shape: direct launches beside SDPA, few calls
    b, t, c = SGM_BATCH, 4096, 64
    qkv = 1.5 * torch.randn(b, t, 3 * c, generator=g, device=dev)
    dout = torch.randn(b, t, c, generator=g, device=dev)
    q, k, v = (a.requires_grad_() for a in sdpa_args(qkv, 1))
    o = sdpa(q, k, v)
    do = ak._heads(dout, 1).contiguous()
    with torch.no_grad():
        out, lse = ak._launch_stats(qkv, 1)
        delta = (ak._heads(dout, 1) * ak._heads(out, 1)).sum(-1)
        k7a_ms = cuda_ms(lambda: ak._launch_stats(qkv, 1), 5, 1)
        k7b_ms = cuda_ms(lambda: ak._launch_bwd(qkv, dout, lse, delta, 1),
                         3, 1)
        fwd_ms = cuda_ms(lambda: sdpa(q, k, v), 5, 1)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), do,
                                                 retain_graph=True), 3, 1)
    for name, ms, lib, cost in [("K7a", k7a_ms, fwd_ms, k7a_cost),
                                ("K7b", k7b_ms, bwd_ms, k7b_cost)]:
        bound, by = bound_ms(*cost(b, t, c, 1))
        rows[name]["dsm_shape"] = {"shape": [b, t, c], "heads": 1,
                                   "direct_ms": ms, "library_ms": lib,
                                   "bound_ms": bound, "bound_by": by}
        log(f"{name} at the DSM shape {[b, t, c]}: direct {ms:.3f} ms, SDPA "
            f"{lib:.3f} ms, bound {bound:.3f} ms ({by})")
    for name, r in rows.items():
        log(f"{name} at {r['shape']}: {r['ms']:.4f} ms per call (direct "
            f"{r['direct_ms']:.4f}), plain {r['plain_ms']:.4f}, SDPA "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return rows


def sgm_arm(g, dev):
    """The SGM arm of _grf(128) with random weights: its train config, the
    U-Net, the reverse SDE and the SmoothedGRF sampler."""
    from sdeflow_tpu_torch import build_sgm_arm
    from sdeflow_tpu_torch.configs import _grf
    from sdeflow_tpu_torch.experiments.driver import make_data_sampler

    cfg = _grf(SGM_NPIXEL)
    tc = cfg.train
    if (cfg.sweep.batch_sizes[0], tc.lr, tc.attention_impl) != (
            SGM_BATCH, 1e-4, "auto"):
        raise AssertionError("grf trains at batch 128, lr 1e-4, auto route")
    model, gen = build_sgm_arm(cfg, g, device=dev)
    randomize_(model, g)
    with torch.no_grad():  # a gentler score head, as for the MSGM arm
        model.core.conv_out.weight.mul_(0.1)
    return tc, model, gen, make_data_sampler(cfg, SGM_NPIXEL**2, dev)


def check_sgm_training(g, dev):
    """Phases 18 and 19: the SGM arm of _grf(128) (the grf U-Net at full
    width on 128×128 SmoothedGRF images, every AttentionBlock on the
    unfused route) trained by DSM: the kernel path against the plain path
    at batch 8, two Trainer steps, timed bare steps at batch 128 with their
    launch counts, the kernel and plain paths in turns at batch 8, and a
    traced step at batch 128."""
    from sdeflow_tpu_torch import Trainer
    from sdeflow_tpu_torch.models.unet2d import AttentionBlock
    from sdeflow_tpu_torch.ops.kernels import common

    tc, model, gen, sampler = sgm_arm(g, dev)
    dim = SGM_NPIXEL**2
    want = {k: SGM_WANT.get(k, 0) for k in common.KERNELS}
    seen = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.update([(inp[0].shape[1],
                                       math.prod(inp[0].shape[2:]))]))
        for m in model.modules() if isinstance(m, AttentionBlock)]
    with torch.no_grad():
        model(sampler.sample(g, 2), torch.rand(2, device=dev))
    for h in hooks:
        h.remove()
    if dict(seen) != SGM_BLOCKS:
        raise AssertionError(f"AttentionBlocks at (C, T): {dict(seen)}")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"SGM arm of grf{SGM_NPIXEL}: AttentionBlocks (C, T) {dict(seen)}, "
        f"all on the unfused route; {n_params} parameters")
    # K5 and K5b at the step's own GroupNorm mix, beside PyTorch's GroupNorm
    # forward and backward and the bound
    mix = gn_mix(model, dev, sampler.sample(g, 2))
    if dict(mix) != SGM_GN_MIX:
        raise AssertionError(f"DSM GroupNorms per forward: {dict(mix)}")
    k5_dsm = k5_rows(g, dev, mix, SGM_BATCH, iters=5)
    log_k5_rows("K5", k5_dsm)
    k5b_dsm = k5b_rows(g, dev, mix, SGM_BATCH, iters=5)
    log_k5_rows("K5b", k5b_dsm)

    # (a) the kernel path against the plain path on one batch of 8
    b = SGM_AGREE_BATCH
    x = sampler.sample(g, b)
    draws = dict(t=gen.sample_t(g, b),
                 noise=torch.randn(b, dim, generator=g, device=dev))
    rec = {"agreement": train_agreement(model, gen.dsm, g, x, draws, want),
           "k5_dsm": k5_dsm, "k5b_dsm": k5b_dsm}

    # (b) the Trainer: two DSM steps with ELBO prints (SSM under no_grad)
    t0 = time.perf_counter()
    trainer = Trainer(gen, sampler, lr=tc.lr, batch_size=SGM_BATCH,
                      loss="dsm", log_fn=log)
    state, loss = trainer.run(g, 2, x_test=sampler.sample(g, SGM_BATCH))
    torch.cuda.synchronize()
    rec["trainer_s"] = time.perf_counter() - t0
    if not (state.step == 2 and math.isfinite(loss)
            and all(math.isfinite(h["elbo"]) for h in trainer.history)):
        raise AssertionError(f"SGM Trainer: step {state.step}, {loss}, "
                             f"{trainer.history}")

    def step(batch=SGM_BATCH):
        return trainer.train_step(trainer.state, g,
                                  sampler.sample(g, batch))[1]

    # (c) timed bare steps at grf's batch
    rec.update(timed_train_steps(step, model, SGM_TIMED_STEPS, want,
                                 SGM_BATCH))

    # (d) the kernel and the plain path in turns at batch 8
    turns = []
    for mode in ("plain", "kernel", "kernel", "plain"):
        with plain_path() if mode == "plain" else contextlib.nullcontext():
            common.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(SGM_AGREE_BATCH)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        if launch_counts() != (want if mode == "kernel" else
                               {k: 0 for k in want}):
            raise AssertionError(f"{mode} DSM step launched "
                                 f"{launch_counts()}")
        turns.append({"mode": mode, "ms": ms})
        log(f"{mode} DSM step at batch {SGM_AGREE_BATCH}: {ms:.1f} ms")
    rec["turns"] = turns

    # 19. where one DSM step's time goes at batch 128
    rec["profile"] = trace(step)
    log_trace(f"one DSM step at batch {SGM_BATCH}", rec["profile"])
    return rec


def gn_timing(g, dev, record):
    """--gn: K5 and its backward timed at grf16's GroupNorm mix (B = 1024)
    and at the DSM step's (B = 128), and one traced DSM step at batch 128
    with the device time under GroupNormSiLUBackward."""
    from sdeflow_tpu_torch import Trainer, build_msgm_arm, get_preset

    model, _ = build_msgm_arm(get_preset("grf16"), g, device=dev)
    mix = gn_mix(model, dev)
    for name, mx, b, iters in [("grf16", mix, N_SAMPLES, 20),
                               ("dsm", SGM_GN_MIX, SGM_BATCH, 5)]:
        record[f"k5_{name}"] = k5_rows(g, dev, mx, b, iters)
        log_k5_rows(f"K5 ({name})", record[f"k5_{name}"])
        record[f"k5b_{name}"] = k5b_rows(g, dev, mx, b, iters)
        log_k5_rows(f"K5b ({name})", record[f"k5b_{name}"])
    tc, model, gen, sampler = sgm_arm(g, dev)
    trainer = Trainer(gen, sampler, lr=tc.lr, batch_size=SGM_BATCH,
                      loss="dsm")
    record["dsm_profile"] = trace(lambda: trainer.train_step(
        trainer.state, g, sampler.sample(g, SGM_BATCH)))
    log_trace(f"one DSM step at batch {SGM_BATCH}", record["dsm_profile"])


def write_record(path, record):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", metavar="PATH",
                    help="write the full record as JSON to PATH")
    ap.add_argument("--gn", action="store_true",
                    help="only build the kernels and time K5 and K5b at "
                    "both GroupNorm mixes, with a traced DSM step")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sdeflow_tpu_torch import build_msgm_arm, get_preset, make_sampler_fn
    from sdeflow_tpu_torch.experiments.driver import make_model
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.ops.kernels.attnblock import (
        K3, _launch, attn_block_math, fused_attention_block)
    from sdeflow_tpu_torch.ops.kernels.circulant import K1, K2, K2_SOLVE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "phase_start_s": {}}
    start = time.perf_counter()

    def phase(label):  # seconds from the build's start to each phase
        record["phase_start_s"][label] = time.perf_counter() - start

    phase("1")
    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    common.build_all()
    record["build_s"] = time.perf_counter() - t0
    log(f"kernels built in {record['build_s']:.1f} s: {sorted(common.KERNELS)}")

    g = torch.Generator(device=dev).manual_seed(0)
    if opts.gn:
        gn_timing(g, dev, record)
        write_record(opts.record, record)
        return 0

    phase("2")
    # -- 2. K1 against its plain version ------------------------------------
    k1 = check_k1(g, dev)
    record["k1"] = k1

    phase("3")
    # -- 3. K3 against its plain version ------------------------------------
    k3 = {}
    with torch.no_grad():
        for b, t, c, heads in K3_SHAPES:
            args = block_args(g, dev, b, t, c)
            out = fused_attention_block(*args, 32, heads)
            torch.cuda.synchronize()
            ref = attn_block_math(*args, 32, heads)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
            err = (out - ref).abs().max().item()
            log(f"K3 ({b}, {t}, {c}) heads={heads}: "
                f"max |kernel - plain| = {err:.3g}")
            if heads == 1:
                bound = bound_ms(*k3_cost(b, t, c, heads))
                k3[(t, c)] = {
                    "shape": [b, t, c], "heads": heads, "max_abs_err": err,
                    "calls_per_forward": BLOCK_MIX[(t, c)],
                    "ms": cuda_ms(lambda: fused_attention_block(
                        *args, 32, heads)),
                    "plain_ms": cuda_ms(lambda: attn_block_math(
                        *args, 32, heads)),
                    "direct_ms": cuda_ms(lambda: _launch(*args, 32, heads)),
                    "bound_ms": bound[0], "bound_by": bound[1],
                }

    phase("4")
    # -- 4. the arm on both routes, and the GroupNorm shapes of a forward ----
    cfg = get_preset("grf16")
    if STEPS not in cfg.sweep.num_stepss_backward:
        raise AssertionError(f"{STEPS} steps is not a grf16 setting")
    t0 = time.perf_counter()
    model, gen = build_msgm_arm(cfg, g, device=dev)
    randomize_(model, g)
    with torch.no_grad():  # a gentler score head: |a| ~ 1 instead of ~10
        model.core.conv_out.weight.mul_(0.1)
    sample = make_sampler_fn(gen, N_SAMPLES, DIM, STEPS,
                             method=cfg.sweep.backward_method,
                             norm_correction=True, device=dev)
    torch.cuda.synchronize()
    record["setup_s"] = time.perf_counter() - t0
    cfg_u = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, attention_impl="unfused"))
    model_u = make_model(cfg_u, DIM, "NormalizeLogRadius", device=dev)
    model_u.load_state_dict(model.state_dict())
    gen_u = dataclasses.replace(gen, score_net=model_u)
    mixes = [gn_mix(model, dev), gn_mix(model_u, dev)]
    for route, mix in zip(("auto", "unfused"), mixes):
        n = sum(mix.values())
        if n != per_forward(route)["group_norm_silu"]:
            raise AssertionError(f"{route}: {n} GroupNorms per forward")
        log(f"{route} route: {n} GroupNorms per forward, (C, S, silu): "
            f"{dict(sorted(mix.items()))}")

    phase("5")
    # -- 5. K5 against its plain version ------------------------------------
    k5 = check_k5(g, dev, mixes)
    record["k5"] = k5

    phase("6")
    # -- 6. K6 and K4 against their plain version ----------------------------
    k6 = check_k6(g, dev)
    record["k6"] = {f"{t}x{c}": v for (t, c), v in k6.items()}

    phase("7")
    # -- 7. serve three requests on the main path ------------------------------
    want = serve_want("auto")
    requests = []
    for r in range(REQUESTS):
        noise = torch.randn(STEPS, N_SAMPLES, DIM, generator=g, device=dev)
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x0 = gen.latent_sample(g, N_SAMPLES, DIM)
        x = sample(g, x0=x0, noise=noise)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        if not torch.isfinite(x).all() or tuple(x.shape) != (N_SAMPLES, DIM):
            raise AssertionError(f"request {r}: bad samples {tuple(x.shape)}")
        torch.testing.assert_close(x.norm(dim=1), x0.norm(dim=1), rtol=1e-5,
                                   atol=0)
        if launches != want:
            raise AssertionError(f"request {r}: launches {launches} != {want}")
        if (x - x0).abs().max().item() < 0.1:
            raise AssertionError(f"request {r}: the solve did not move x0")
        requests.append({"ms": dt * 1e3, "samples_per_s": N_SAMPLES / dt,
                         "launches": launches})
        log(f"request {r}: {dt * 1e3:.1f} ms, {N_SAMPLES / dt:.1f} samples/s,"
            f" launches {launches}")
    record["requests"] = requests

    phase("8")
    # -- 8. replay the last request: plain, (kernel, direct, direct, kernel)
    # twice, plain; the plain runs swap the kernel wrappers for their plain
    # versions where the path calls them, the direct runs for launches
    # without the autograd.Function; the mirrored order keeps drift out of
    # the comparison
    record["replay"] = serve_runs(
        sample, g, x0, noise, x,
        ("plain", *("kernel", "direct", "direct", "kernel") * 2, "plain"),
        want)

    phase("9")
    # -- 9. where one request's time goes: a torch.profiler trace -------------
    sample2 = make_sampler_fn(gen, N_SAMPLES, DIM, PROFILED_STEPS,
                              method="rk4", norm_correction=True, device=dev)
    prof = dict(trace(lambda: sample2(g)), steps=PROFILED_STEPS)
    record["profile"] = prof
    log_trace(f"{PROFILED_STEPS} RK4 steps", prof)

    phase("10")
    # -- 10. the unfused route's serving ---------------------------------------
    unfused = {"serve": serve_unfused(cfg, gen_u, g, dev, x0, noise, x,
                                      sample)}
    record["unfused"] = unfused

    phase("11")
    # -- 11. K4 on the unfused block at T = 4096 ------------------------------
    long = check_long_attention(g, dev)
    record["long_attention"] = long

    phase("12")
    # -- 12. K2 and its solve against their plain versions -------------------
    k2, solve = check_k2(gen, g, dev)
    record["k2"], record["k2_solve"] = k2, solve

    phase("13")
    # -- 13. autograd through the kernels -------------------------------------
    record["autograd"] = check_autograd(g, dev)

    phase("14")
    # -- 14. training at full width ------------------------------------------
    train, step = check_training(cfg, model, gen, g, dev)
    record["train"] = train
    record["trajectory"] = check_trajectory(gen, g, dev)

    phase("15")
    # -- 15. where one train step's time goes ---------------------------------
    prof_train = trace(step)
    record["train_profile"] = prof_train
    log_trace("one train step", prof_train)
    with plain_path():
        prof_plain = trace(step)
    record["train_profile_plain"] = prof_plain
    log_trace("one plain train step", prof_plain)

    phase("16")
    # -- 16. the unfused route's training ---------------------------------------
    unfused["train"] = train_unfused(cfg_u, model_u, gen_u, g, dev, step)

    phase("17")
    # -- 17. K7a and K7b against their plain versions ------------------------
    k7 = check_flash(g, dev)
    record["k7"] = k7

    phase("18, 19")
    # -- 18, 19. DSM training of the SGM arm at 128×128 ----------------------
    sgm = check_sgm_training(g, dev)
    record["sgm_train"] = sgm

    phase("table")
    # -- the kernel table ----------------------------------------------------
    k3_rows = list(k3.values())
    k6_rows = [k6[s] for s in BLOCK_MIX]
    for r in k6_rows:
        r["calls_per_forward"] = BLOCK_MIX[(r["shape"][1], r["shape"][2])]
    k4 = k6[(K4_SHAPES[0][1], K4_SHAPES[0][2])]
    serve_k = requests[-1]["launches"]
    serve_u = unfused["serve"]["request"]["launches"]
    train_u = unfused["train"]["launches_per_step"]

    def mixed(rows, **extra):  # per launch, over the main path's mix
        keys = ("ms", "direct_ms", "plain_ms", "bound_ms")
        out = {k: weighted(rows, k) for k in keys}
        if "library_ms" in rows[0]:
            out["library_ms"] = weighted(rows, "library_ms")
        out["bound_by"] = ("operations" if all(
            r["bound_by"] == "operations" for r in rows) else "bytes")
        out["per_shape"] = rows
        return dict(out, **extra)

    kernels = [
        dict(k1, name=K1.name, id="K1", route="cuda",
             source="sdeflow_tpu_torch/csrc/circulant.cu",
             replaces="sdeflow_tpu/ops/pallas/circulant.py:47",
             launches=serve_k[K1.name], launches_per="serve request",
             library_ms=None,
             device_ms=prof["per_launch_ms"].get(SYMBOL[K1.name]),
             train_launches_per_step=train["launches_per_step"][K1.name],
             train_device_ms=prof_train["per_launch_ms"].get(
                 SYMBOL[K1.name])),
        dict(k2, name=K2.name, id="K2", route="cuda",
             source="sdeflow_tpu_torch/csrc/rk4.cu",
             replaces="sdeflow_tpu/ops/pallas/circulant.py:118",
             launches=record["trajectory"]["launches"][K2.name],
             launches_per="forward trajectory (sample_scheme_allt, batch "
             f"{TRAIN_BATCH}; 0 per SSM step)", library_ms=None,
             device_ms=k2["device_ms_alone"]),
        dict(solve, name=K2_SOLVE.name, id="K2 solve", route="cuda",
             source="sdeflow_tpu_torch/csrc/rk4.cu",
             replaces="sdeflow_tpu/ops/pallas/circulant.py:118 in the "
             "lax.scan of sdeflow_tpu/ops/integrators.py:232-243",
             launches=train["launches_per_step"][K2_SOLVE.name],
             launches_per="SSM train step", library_ms=None,
             train_device_ms=prof_train["per_launch_ms"].get(
                 SYMBOL[K2_SOLVE.name])),
        dict(mixed(k3_rows), name=K3.name, id="K3", route="cuda",
             source="sdeflow_tpu_torch/csrc/attnblock.cu",
             replaces="sdeflow_tpu/ops/pallas/attnblock.py:188",
             launches=serve_k[K3.name], launches_per="serve request",
             max_abs_err=max(r["max_abs_err"] for r in k3_rows),
             library_ms=None,
             device_ms=prof["per_launch_ms"].get(SYMBOL[K3.name]),
             train_launches_per_step=train["launches_per_step"][K3.name],
             train_device_ms=prof_train["per_launch_ms"].get(
                 SYMBOL[K3.name])),
        dict(mixed(k5["per_shape"]), name="group_norm_silu", id="K5",
             dsm_mix=dict(mixed(sgm["k5_dsm"]),
                          launches_per_step=sgm["launches_per_step"][
                              "group_norm_silu"]),
             route="cuda", source="sdeflow_tpu_torch/csrc/groupnorm.cu",
             replaces="sdeflow_tpu/ops/pallas/groupnorm.py:111",
             launches=serve_k["group_norm_silu"],
             launches_per="serve request (auto route)",
             launches_unfused=serve_u["group_norm_silu"],
             max_abs_err=k5["max_abs_err"],
             device_ms=prof["per_launch_ms"].get(SYMBOL["group_norm_silu"]),
             train_launches_per_step=train["launches_per_step"][
                 "group_norm_silu"],
             train_device_ms=prof_train["per_launch_ms"].get(
                 SYMBOL["group_norm_silu"])),
        dict(mixed(sgm["k5b_dsm"], old_ms=weighted(sgm["k5b_dsm"], "old_ms"),
                   grf16_mix=mixed(k5["bwd_per_shape"],
                                   old_ms=weighted(k5["bwd_per_shape"],
                                                   "old_ms"))),
             name="group_norm_silu_bwd", id="K5b", route="cuda",
             source="sdeflow_tpu_torch/csrc/groupnorm.cu",
             replaces="the backward of group_norm_silu (no Pallas kernel; "
             "the custom_jvp rule's transpose, "
             "sdeflow_tpu/ops/pallas/groupnorm.py:147-151)",
             launches=sgm["launches_per_step"]["group_norm_silu_bwd"],
             launches_per=f"DSM train step (grf U-Net, {SGM_NPIXEL}x"
             f"{SGM_NPIXEL}, batch {SGM_BATCH})",
             ssm_launches_per_step=train["launches_per_step"][
                 "group_norm_silu_bwd"],
             ssm_launches_per_step_unfused=train_u["group_norm_silu_bwd"],
             max_abs_err=k5["bwd_max_abs_err"],
             max_rel_err=k5["bwd_max_rel_err"],
             device_ms=sum(sgm["profile"]["per_launch_ms"].get(k, 0) for k in
                           ("gn_silu_bwd_kernel", "gn_silu_bwd_params")),
             device_ms_under_backward=sgm["profile"]["op_device_ms"].get(
                 "GroupNormSiLUBackward")),
        dict(mixed(k6_rows), name="qkv_attention", id="K6", route="cuda",
             dsm_shape=dict(k6[K6_DSM], launches_per_step=sgm[
                 "launches_per_step"]["qkv_attention"]),
             source="sdeflow_tpu_torch/csrc/attention.cu",
             replaces="sdeflow_tpu/ops/pallas/attention.py:225",
             launches=serve_u["qkv_attention"],
             launches_per="serve request (unfused route)",
             max_abs_err=max(r["max_abs_err"] for r in k6_rows),
             device_ms=unfused["serve"]["profile"]["per_launch_ms"].get(
                 SYMBOL["qkv_attention"]),
             train_launches_per_step=train_u["qkv_attention"],
             train_device_ms=unfused["train"]["profile"][
                 "per_launch_ms"].get(SYMBOL["qkv_attention"])),
        dict(k4, name="qkv_attention_flash", id="K4", route="cuda",
             source="sdeflow_tpu_torch/csrc/flash_fwd.cu",
             replaces="sdeflow_tpu/ops/pallas/attention.py:201",
             launches=long["launches"]["qkv_attention_flash"],
             launches_per="T = 4096 AttentionBlock: no-grad forward, jvp "
             "and grad (the jvp and grad take K7a/K7b)",
             device_ms=long["profile"]["per_launch_ms"].get(
                 SYMBOL["qkv_attention_flash"])),
        *[dict(k7[i], name=name, id=i, route="cuda",
               source=f"sdeflow_tpu_torch/csrc/{src}",
               replaces=f"sdeflow_tpu/ops/pallas/attention.py:{line}",
               launches=sgm["launches_per_step"][name],
               launches_per=f"DSM train step (grf U-Net, {SGM_NPIXEL}x"
               f"{SGM_NPIXEL}, batch {SGM_BATCH})",
               device_ms=sgm["profile"]["per_launch_ms"].get(SYMBOL[name]),
               device_shape=[SGM_BATCH, 4096, 64])
          for i, name, src, line in [
              ("K7a", "qkv_attention_stats", "flash_fwd.cu", 344),
              ("K7b", "qkv_attention_bwd", "attention_bwd.cu", 436)]],
    ]
    for k in kernels:
        missing = {"name", "route", "source", "replaces", "launches",
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms"} - set(k)
        if missing:
            raise AssertionError(f"{k['id']} lacks {sorted(missing)}")
        lib = ("no single PyTorch call computes it" if k["library_ms"] is None
               else f"library call {k['library_ms']:.4f} ms")
        log(f"{k['id']} {k['name']}: {k['ms']:.4f} ms per call (direct "
            f"launch {k['direct_ms']:.4f} ms, device {k['device_ms']} ms), "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), plain version "
            f"{k['plain_ms']:.4f} ms; {lib}; {k['launches']} launches per "
            f"{k['launches_per']}")
    record["kernels"] = kernels
    phase("end")
    log("phases start at (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in record["phase_start_s"].items()))
    write_record(opts.record, record)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
