#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sdeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Drives the port's two paths on the grf16 MSGM arm at full width (the
VorticityUNet score net with random weights from a seed, the circulant MSGM
SDE at d=256 built from 100k SmoothedGRF samples): sampling with
norm-corrected RK4, and SSM training at batch 128. It holds every CUDA
kernel of those paths against its plain PyTorch version:

1. prints the card's name and power limit, builds the kernels from
   sdeflow_tpu_torch/csrc with nvcc (one process per source, in parallel);
2. K1 circulant_apply against circ_math at (1024, 256), (1000, 256) and
   (1024, 1024), rtol/atol 1e-6;
3. K3 fused_attention_block against attn_block_math at (1024, 64, 64) and
   (1024, 16, 128) with one head and at (1024, 64, 64) with four heads,
   all weights random and non-zero, TF32 off, rtol/atol 1e-5;
4. serves three requests of 1024 samples with 32 RK4 steps each: finite
   (1024, 256) samples, every latent norm kept to rtol 1e-5, and exactly
   8·32 launches of K1 and 44·32 of K3 per request;
5. replays the last request (same x0 and noise) ten times: plain, twice
   kernel, direct, direct, kernel, then plain. The plain runs put the
   plain versions in place of the kernel wrappers, the direct runs launch
   each kernel without its autograd.Function; max |Δ| ≤ 1e-3·max |x|
   against the request, no launch in a plain run, the exact counts in the
   others;
6. traces a 2-step request with torch.profiler: device time by kernel,
   the device's busy time and idle share;
7. times each kernel (CUDA events around back-to-back wrapper calls, and
   its device time from the trace) beside its bound, its plain version and
   a direct launch without the autograd.Function (direct_ms, under
   no_grad). No single PyTorch call computes K1, K2 or K3, so library_ms
   is null;
8. K2 circulant_rk4_step against rk4_math_fwd at (128, 256), (1000, 256)
   and (1024, 1024), sb3 in [1, 2], rtol/atol 1e-6, and
   ForwardFlow.rk4_step (kernel K2) against the generic rk4_step on the
   plain versions;
9. autograd through the kernels: torch.func.jvp and torch.autograd.grad
   through each kernel's Function against the plain version at the paths'
   shapes (K1, K2 1e-6; K3 1e-5), and a ResBlock's gradient through its
   JVP on cuDNN against the CPU (1e-4);
10. training: on one batch of 128 with injected draws, the loss and every
   parameter gradient of the kernel path against the plain path (loss
   rtol 1e-4, each gradient max |Δ| ≤ 1e-3·max |g|); three steps of the
   driver's Trainer (train_msgm_arm); 20 timed bare train steps with
   exactly 64 K2, 5 K1 and 11 K3 launches each; then a train step
   replayed plain, kernel, kernel, plain;
11. traces one train step with torch.profiler, on the kernel path and on
   the plain path.

Ends with the kernel table as one JSON line, then
{"ok": true, "device": {...}} as the last line. Exits non-zero without a
CUDA device, outside the repository, or when any check fails. With
--record, also writes the full record (every measurement, the profile's
top kernels) as JSON to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
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
K1_PER_STEP, K3_PER_STEP = 8, 44
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12    # fp32 outside the tensor cores
K1_SHAPES = [(1024, 256), (1000, 256), (1024, 1024)]
K2_SHAPES = [(128, 256), (1000, 256), (1024, 1024)]
TRAIN_BATCH, TRAIN_STEPS = 128, 64  # grf16: batch 128, 64 forward steps
WARM_STEPS, TIMED_STEPS, REPLAY_STEPS = 3, 20, 5
# launches per bare train step: K2 once per forward step; K1 four times
# in the one-step fallback and once in the loss field; K3 once per
# AttentionBlock of the one U-Net forward under the JVP (the jvp and
# backward rules run the plain versions)
K1_PER_TRAIN, K2_PER_TRAIN, K3_PER_TRAIN = 5, 64, 11
K3_SHAPES = [(1024, 64, 64, 1), (1024, 16, 128, 1), (1024, 64, 64, 4)]
K3_PATH_MIX = {(64, 64): 5, (16, 128): 6}  # blocks per U-Net forward


def log(*a):
    print(*a, flush=True)


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


def bound_ms(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def k1_cost(b, d):
    # reads sqrt_beta, y, w once and writes out; 6 flops per element
    return 4 * (b + 3 * b * d), 6 * b * d


def k2_cost(b, d):
    # reads sb3, x, w once and writes out; per element 4 stencil stages of
    # 6 flops, 5 for the stage states, 5 for the sum and 2 to combine
    return 4 * (3 * b + 3 * b * d), 36 * b * d


def k3_cost(b, t, c, heads):
    nbytes = 4 * (2 * b * t * c + 4 * c * c + 6 * c)
    per_sample = (2 * t * c * 3 * c + 4 * t * t * c + 2 * t * c * c
                  + 8 * t * c + 5 * heads * t * t)
    return nbytes, b * per_sample


def randomize_(model, generator):
    """Random non-zero values for every parameter, in place: weights
    N(0, 1/fan_in), norm scales 1 + N(0, 0.01), biases N(0, 0.01)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=generator, device=p.device)
            if p.ndim >= 2:
                # DenseParams keep (in, out); Linear and Conv2d lead with out
                fan_in = p.shape[0] if name.endswith(".kernel") else p[0].numel()
                p.copy_(z / fan_in**0.5)
            elif name.endswith("scale"):
                p.copy_(1.0 + 0.1 * z)
            else:
                p.copy_(0.1 * z)
        # a gentler score head: |a| ~ 1 instead of ~10
        model.core.conv_out.weight.mul_(0.1)


KERNEL_SYMBOLS = ("circulant_apply_kernel", "rk4_step_kernel",
                  "attn_block_kernel")


def trace(fn):
    """Run fn() once (warm) and once under torch.profiler: device time by
    kernel name, the device's busy time (union of kernel intervals) and
    idle share of the traced wall time."""
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
            per_launch[short] = sum(h[0] for h in hits) / sum(h[1] for h in hits)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "wall_ms": wall_ms, "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / 1e3 / wall_ms,
        "kernel_ms_total": sum(ms for ms, _ in by_name.values()),
        "kernel_launches": len(kernels),
        "per_launch_ms": per_launch,
        "top": [{"name": n, "ms": ms, "calls": c} for n, (ms, c) in top],
    }


@contextlib.contextmanager
def plain_path():
    """Swap every kernel wrapper for its plain version where the paths
    call it (the plain runs of the replays)."""
    from sdeflow_tpu_torch.models import unet2d
    from sdeflow_tpu_torch.ops.kernels.attnblock import (
        attn_block_math, fused_attention_block)
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        circ_math, circulant_apply, circulant_rk4_step, rk4_math_fwd)
    from sdeflow_tpu_torch.sde import msgm

    msgm.circulant_apply, msgm.circulant_rk4_step = circ_math, rk4_math_fwd
    unet2d.fused_attention_block = attn_block_math
    try:
        yield
    finally:
        msgm.circulant_apply = circulant_apply
        msgm.circulant_rk4_step = circulant_rk4_step
        unet2d.fused_attention_block = fused_attention_block


@contextlib.contextmanager
def direct_path():
    """Swap every kernel wrapper for a direct launch of its kernel, without
    its autograd.Function, where the serve path calls it (no_grad runs)."""
    from sdeflow_tpu_torch.models import unet2d
    from sdeflow_tpu_torch.ops.kernels import attnblock, circulant
    from sdeflow_tpu_torch.sde import msgm

    msgm.circulant_apply = lambda s, y, w: circulant._launch_k1(
        circulant.sqrt_beta_column(s, y), y, w)
    unet2d.fused_attention_block = attnblock._launch
    try:
        yield
    finally:
        msgm.circulant_apply = circulant.circulant_apply
        unet2d.fused_attention_block = attnblock.fused_attention_block


def launch_counts():
    from sdeflow_tpu_torch.ops.kernels import common

    return {k.name: k.launches for k in common.KERNELS.values()}


def check_k2(gen, g, dev):
    """Phase 8: K2 against its plain version, and the forward flow's fused
    step against the generic stages on the plain versions."""
    from sdeflow_tpu_torch.ops.integrators import rk4_step
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        _launch_k2, circulant_rk4_step, rk4_math_fwd)
    from sdeflow_tpu_torch.sde import ForwardFlow

    row = {}
    delta = 1.0 / TRAIN_STEPS
    with torch.no_grad():
        for b, d in K2_SHAPES:
            x = torch.randn(b, d, generator=g, device=dev)
            w = delta**0.5 * torch.randn(b, d, generator=g, device=dev)
            sb3 = 1.0 + torch.rand(b, 3, generator=g, device=dev)
            out = circulant_rk4_step(sb3, x, w)
            torch.cuda.synchronize()
            ref = rk4_math_fwd(sb3, x, w)
            torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
            err = (out - ref).abs().max().item()
            log(f"K2 ({b}, {d}): max |kernel - plain| = {err:.3g}")
            if (b, d) == (TRAIN_BATCH, DIM):
                row = {"max_abs_err": err, "shape": [b, d],
                       "ms": cuda_ms(lambda: circulant_rk4_step(sb3, x, w),
                                     200),
                       "plain_ms": cuda_ms(lambda: rk4_math_fwd(sb3, x, w),
                                           200),
                       "direct_ms": cuda_ms(lambda: _launch_k2(sb3, x, w),
                                            200)}
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
    return row


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


def check_autograd(g, dev):
    """Phase 9: jvp and grad through each kernel's Function (kernel
    forward, plain rules) against the plain version; a ResBlock's gradient
    through its JVP on cuDNN against the CPU."""
    from sdeflow_tpu_torch.models.unet2d import ResBlock
    from sdeflow_tpu_torch.ops.kernels.attnblock import (
        attn_block_math, fused_attention_block)
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        circ_math, circulant_apply, circulant_rk4_step, rk4_math_fwd)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    b, d = TRAIN_BATCH, DIM
    cases = [
        ("K1", circulant_apply, circ_math,
         [1.0 + rnd(b, 1).abs(), rnd(b, d), rnd(b, d)], 1e-6),
        ("K2", circulant_rk4_step, rk4_math_fwd,
         [1.0 + rnd(b, 3).abs(), rnd(b, d), 0.125 * rnd(b, d)], 1e-6)]
    for t, c in K3_PATH_MIX:
        cases.append((f"K3 ({b}, {t}, {c})",
                      lambda *a: fused_attention_block(*a, 32, 1),
                      lambda *a: attn_block_math(*a, 32, 1),
                      block_args(g, dev, b, t, c), 1e-5))
    errs = {}
    for name, kern, plain, args, tol in cases:
        got = through_autograd(kern, args, 1)
        want = through_autograd(plain, args, 1)
        worst = 0.0
        for a, w in zip(got, want):  # output, tangent, each gradient
            scale = w.abs().max().item()
            torch.testing.assert_close(a, w, rtol=tol, atol=tol * scale)
            worst = max(worst, (a - w).abs().max().item() / scale)
        errs[name] = worst
        log(f"{name} through jvp and grad: max |Δ| / max |plain| = "
            f"{worst:.3g} (tolerance {tol:g})")
    # reverse over forward through cuDNN's convolutions, fp32 without TF32
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
    log(f"ResBlock grad of its JVP, cuDNN vs CPU: max |Δ| / max |g| = "
        f"{worst:.3g} (tolerance 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError(f"ResBlock reverse over forward: {worst:.3g}")
    errs["ResBlock"] = worst
    return errs


def check_training(cfg, model, gen, g, dev):
    """Phase 10: the kernel path against the plain path on one batch, the
    driver's Trainer, timed bare train steps with their launch counts, and
    the plain, kernel, kernel, plain replay of a train step."""
    from sdeflow_tpu_torch import train_msgm_arm
    from sdeflow_tpu_torch.experiments.driver import make_data_sampler
    from sdeflow_tpu_torch.ops.hutchinson import sample_v
    from sdeflow_tpu_torch.ops.kernels import common

    b = cfg.sweep.batch_sizes[0]
    if (b, cfg.train.num_steps_forward) != (TRAIN_BATCH, TRAIN_STEPS):
        raise AssertionError("grf16 trains at batch 128 with 64 steps")
    names = {k.name: k for k in common.KERNELS.values()}
    want = {"circulant_apply": K1_PER_TRAIN,
            "circulant_rk4_step": K2_PER_TRAIN,
            "fused_attention_block": K3_PER_TRAIN}
    assert set(want) == set(names)
    none = {k: 0 for k in want}
    rec = {}
    sampler = make_data_sampler(cfg, DIM, dev)
    x = sampler.sample(g, b)
    draws = dict(
        t=gen.sample_t(g, b),
        noise=torch.randn(TRAIN_STEPS, b, DIM, generator=g, device=dev),
        noise_one=torch.randn(b, DIM, generator=g, device=dev),
        v=sample_v(g, (b, DIM), gen.vtype, device=dev))

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = gen.ssm(g, x, **draws).mean()
        loss.backward()
        return loss.detach(), {n: p.grad.detach().clone()
                               for n, p in model.named_parameters()}

    common.reset_launches()
    loss_k, grads_k = loss_and_grads()
    if launch_counts() != want:
        raise AssertionError(f"kernel loss launched {launch_counts()}")
    common.reset_launches()
    with plain_path():
        loss_p, grads_p = loss_and_grads()
    if launch_counts() != none:
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
        f"{len(grads_p)} tensors have no gradient in exact arithmetic)")
    if not (torch.isfinite(loss_k) and rel_loss <= 1e-4 and worst <= 1e-3):
        raise AssertionError("kernel and plain training paths disagree")
    rec["agreement"] = {"loss_kernel": loss_k.item(),
                        "loss_plain": loss_p.item(), "loss_rel": rel_loss,
                        "grad_worst_rel": worst, "grad_worst": worst_name,
                        "grad_tensors": len(grads_p),
                        "grad_tensors_zero": dead}

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

    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    losses, counts = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
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
    rec.update(ms_per_step=dt * 1e3 / TIMED_STEPS,
               steps_per_s=TIMED_STEPS / dt,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches_per_step=per_step[-1],
               losses=[v.item() for v in losses], param_moved=moved)
    log(f"{TIMED_STEPS} train steps at batch {b}: {rec['ms_per_step']:.2f} "
        f"ms/step, {rec['steps_per_s']:.2f} steps/s, peak memory "
        f"{rec['max_memory_allocated'] / 2**20:.1f} MiB, launches per step "
        f"{per_step[-1]}, loss {losses[0].item():.3f} -> "
        f"{losses[-1].item():.3f}")

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
        expect = ({k: n * REPLAY_STEPS for k, n in want.items()}
                  if mode == "kernel" else none)
        if launch_counts() != expect:
            raise AssertionError(f"{mode} replay launched {launch_counts()}")
        replay.append({"mode": mode, "ms_per_step": dt * 1e3 / REPLAY_STEPS})
        log(f"{mode} train replay: {dt * 1e3 / REPLAY_STEPS:.2f} ms/step")
    rec["replay"] = replay
    return rec, step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", metavar="PATH",
                    help="write the full record as JSON to PATH")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sdeflow_tpu_torch import build_msgm_arm, get_preset, make_sampler_fn
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.ops.kernels.attnblock import (
        K3, _launch, attn_block_math, fused_attention_block)
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        K1, K2, _launch_k1, circ_math, circulant_apply)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    common.build_all()
    record["build_s"] = time.perf_counter() - t0
    log(f"kernels built in {record['build_s']:.1f} s: {sorted(common.KERNELS)}")

    g = torch.Generator(device=dev).manual_seed(0)

    # -- 2. K1 against its plain version ------------------------------------
    k1_err = 0.0
    with torch.no_grad():
        for b, d in K1_SHAPES:
            y = torch.randn(b, d, generator=g, device=dev)
            w = torch.randn(b, d, generator=g, device=dev)
            sb = 1.0 + torch.rand(b, 1, generator=g, device=dev)
            out = circulant_apply(sb, y, w)
            torch.cuda.synchronize()
            ref = circ_math(sb, y, w)
            torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
            err = (out - ref).abs().max().item()
            if (b, d) == (N_SAMPLES, DIM):
                k1_err = err
                k1_ms = cuda_ms(lambda: circulant_apply(sb, y, w), 200)
                k1_plain_ms = cuda_ms(lambda: circ_math(sb, y, w), 200)
                k1_direct_ms = cuda_ms(lambda: _launch_k1(sb, y, w), 200)
            log(f"K1 ({b}, {d}): max |kernel - plain| = {err:.3g}")

    # -- 3. K3 against its plain version ------------------------------------
    k3 = {}
    with torch.no_grad():
        for b, t, c, heads in K3_SHAPES:
            args = [2.0 * torch.randn(b, t, c, generator=g, device=dev) + 0.5,
                    1.0 + 0.1 * torch.randn(c, generator=g, device=dev),
                    0.1 * torch.randn(c, generator=g, device=dev),
                    torch.randn(c, 3 * c, generator=g, device=dev) / c**0.5,
                    0.1 * torch.randn(3 * c, generator=g, device=dev),
                    torch.randn(c, c, generator=g, device=dev) / c**0.5,
                    0.1 * torch.randn(c, generator=g, device=dev)]
            out = fused_attention_block(*args, 32, heads)
            torch.cuda.synchronize()
            ref = attn_block_math(*args, 32, heads)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
            err = (out - ref).abs().max().item()
            log(f"K3 ({b}, {t}, {c}) heads={heads}: "
                f"max |kernel - plain| = {err:.3g}")
            if heads == 1:
                nbytes, flops = k3_cost(b, t, c, heads)
                k3[(t, c)] = {
                    "shape": [b, t, c], "heads": heads, "max_abs_err": err,
                    "ms": cuda_ms(lambda: fused_attention_block(
                        *args, 32, heads)),
                    "plain_ms": cuda_ms(lambda: attn_block_math(
                        *args, 32, heads)),
                    "direct_ms": cuda_ms(lambda: _launch(*args, 32, heads)),
                    "bound_ms": bound_ms(nbytes, flops)[0],
                    "bound_by": bound_ms(nbytes, flops)[1],
                }

    # -- 4. serve three requests on the main path ------------------------------
    cfg = get_preset("grf16")
    if STEPS not in cfg.sweep.num_stepss_backward:
        raise AssertionError(f"{STEPS} steps is not a grf16 setting")
    t0 = time.perf_counter()
    model, gen = build_msgm_arm(cfg, g, device=dev)
    randomize_(model, g)
    sample = make_sampler_fn(gen, N_SAMPLES, DIM, STEPS,
                             method=cfg.sweep.backward_method,
                             norm_correction=True, device=dev)
    torch.cuda.synchronize()
    record["setup_s"] = time.perf_counter() - t0
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
        launches = {k.name: k.launches for k in common.KERNELS.values()}
        if not torch.isfinite(x).all() or tuple(x.shape) != (N_SAMPLES, DIM):
            raise AssertionError(f"request {r}: bad samples {tuple(x.shape)}")
        torch.testing.assert_close(x.norm(dim=1), x0.norm(dim=1), rtol=1e-5,
                                   atol=0)
        want = {K1.name: K1_PER_STEP * STEPS, K2.name: 0,
                K3.name: K3_PER_STEP * STEPS}
        if launches != want:
            raise AssertionError(f"request {r}: launches {launches} != {want}")
        if (x - x0).abs().max().item() < 0.1:
            raise AssertionError(f"request {r}: the solve did not move x0")
        requests.append({"ms": dt * 1e3, "samples_per_s": N_SAMPLES / dt,
                         "launches": launches})
        log(f"request {r}: {dt * 1e3:.1f} ms, {N_SAMPLES / dt:.1f} samples/s,"
            f" launches {launches}")
    record["requests"] = requests

    # -- 5. replay the last request: plain, (kernel, direct, direct, kernel)
    # twice, plain; the plain runs swap the kernel wrappers for their plain
    # versions where the path calls them, the direct runs for launches
    # without the autograd.Function; the mirrored order keeps drift out of
    # the comparison
    replay = []
    swaps = {"plain": plain_path, "direct": direct_path,
             "kernel": contextlib.nullcontext}
    for mode in ("plain", *("kernel", "direct", "direct", "kernel") * 2,
                 "plain"):
        with swaps[mode]():
            common.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_r = sample(g, x0=x0, noise=noise)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launched = {k.name: k.launches for k in common.KERNELS.values()}
        if launched != (want if mode != "plain" else
                        {k: 0 for k in launched}):
            raise AssertionError(f"{mode} replay launched {launched}")
        rel = ((x - x_r).abs().max() / x_r.abs().max()).item()
        log(f"{mode} replay: {dt * 1e3:.1f} ms; max |request - replay| / "
            f"max |x| = {rel:.3g}")
        if not rel <= 1e-3:
            raise AssertionError(f"{mode} replay disagrees: {rel:.3g}")
        replay.append({"mode": mode, "ms": dt * 1e3, "rel_err": rel})
    record["replay"] = replay

    # -- 6. where one request's time goes: a torch.profiler trace -------------
    sample2 = make_sampler_fn(gen, N_SAMPLES, DIM, PROFILED_STEPS,
                              method="rk4", norm_correction=True, device=dev)
    prof = dict(trace(lambda: sample2(g)), steps=PROFILED_STEPS)
    record["profile"] = prof
    log(f"profiled {PROFILED_STEPS} RK4 steps: wall {prof['wall_ms']:.1f} ms,"
        f" device busy {prof['busy_ms']:.1f} ms (idle share "
        f"{prof['idle_share']:.3f}), {prof['kernel_launches']} kernels")
    for row in prof["top"]:
        log(f"  {row['ms']:9.3f} ms  {row['calls']:5d}x  {row['name'][:90]}")

    # -- 7. the kernel table -------------------------------------------------
    b1, f1 = k1_cost(N_SAMPLES, DIM)
    mix = sum(K3_PATH_MIX.values())

    def avg(key):  # per launch, over the main path's mix of block shapes
        return sum(k3[s][key] * n for s, n in K3_PATH_MIX.items()) / mix

    kernels = [
        {"name": K1.name, "route": "cuda",
         "source": "sdeflow_tpu_torch/csrc/circulant.cu",
         "replaces": "sdeflow_tpu/ops/pallas/circulant.py:47",
         "launches": requests[-1]["launches"][K1.name],
         "launches_per": "serve request",
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "direct_ms": k1_direct_ms,
         "bound_ms": bound_ms(b1, f1)[0], "bound_by": bound_ms(b1, f1)[1],
         "library_ms": None, "shape": [N_SAMPLES, DIM],
         "device_ms": prof["per_launch_ms"].get("circulant_apply_kernel")},
        {"name": K3.name, "route": "cuda",
         "source": "sdeflow_tpu_torch/csrc/attnblock.cu",
         "replaces": "sdeflow_tpu/ops/pallas/attnblock.py:188",
         "launches": requests[-1]["launches"][K3.name],
         "launches_per": "serve request",
         "max_abs_err": max(v["max_abs_err"] for v in k3.values()),
         "ms": avg("ms"), "plain_ms": avg("plain_ms"),
         "direct_ms": avg("direct_ms"), "bound_ms": avg("bound_ms"),
         "bound_by": "operations" if all(
             v["bound_by"] == "operations" for v in k3.values()) else "bytes",
         "library_ms": None,
         "device_ms": prof["per_launch_ms"].get("attn_block_kernel"),
         "per_shape": [dict(v, blocks_per_forward=K3_PATH_MIX[s])
                       for s, v in k3.items()]},
    ]

    # -- 8. K2 against its plain version -------------------------------------
    k2 = check_k2(gen, g, dev)

    # -- 9. autograd through the kernels -------------------------------------
    record["autograd"] = check_autograd(g, dev)

    # -- 10. training at full width ------------------------------------------
    train, step = check_training(cfg, model, gen, g, dev)
    record["train"] = train

    # -- 11. where one train step's time goes ---------------------------------
    prof_train = trace(step)
    record["train_profile"] = prof_train
    log(f"profiled one train step: wall {prof_train['wall_ms']:.1f} ms, "
        f"device busy {prof_train['busy_ms']:.1f} ms (idle share "
        f"{prof_train['idle_share']:.3f}), {prof_train['kernel_launches']} "
        "kernels")
    for row in prof_train["top"]:
        log(f"  {row['ms']:9.3f} ms  {row['calls']:5d}x  {row['name'][:90]}")
    with plain_path():
        prof_plain = trace(step)
    record["train_profile_plain"] = prof_plain
    log(f"profiled one plain train step: wall {prof_plain['wall_ms']:.1f} ms,"
        f" device busy {prof_plain['busy_ms']:.1f} ms (idle share "
        f"{prof_plain['idle_share']:.3f}), {prof_plain['kernel_launches']} "
        "kernels")

    b2, f2 = k2_cost(TRAIN_BATCH, DIM)
    kernels.insert(1, {
        "name": K2.name, "route": "cuda",
        "source": "sdeflow_tpu_torch/csrc/rk4.cu",
        "replaces": "sdeflow_tpu/ops/pallas/circulant.py:118",
        "launches": train["launches_per_step"][K2.name],
        "launches_per": "train step", "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "direct_ms": k2["direct_ms"],
        "bound_ms": bound_ms(b2, f2)[0], "bound_by": bound_ms(b2, f2)[1],
        "library_ms": None, "shape": k2["shape"],
        "device_ms": prof_train["per_launch_ms"].get("rk4_step_kernel")})
    for k in kernels:
        k["train_launches_per_step"] = train["launches_per_step"][k["name"]]
        k["train_device_ms"] = prof_train["per_launch_ms"].get(
            {K1.name: "circulant_apply_kernel", K2.name: "rk4_step_kernel",
             K3.name: "attn_block_kernel"}[k["name"]])
        log(f"{k['name']}: {k['ms']:.4f} ms per call (direct launch "
            f"{k['direct_ms']:.4f} ms, device {k['device_ms']} ms), bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}), plain version "
            f"{k['plain_ms']:.4f} ms; no single PyTorch call computes it, "
            "so no library time")
    record["kernels"] = kernels
    if opts.record:
        os.makedirs(os.path.dirname(os.path.abspath(opts.record)),
                    exist_ok=True)
        with open(opts.record, "w") as f:
            json.dump(record, f, indent=2)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
