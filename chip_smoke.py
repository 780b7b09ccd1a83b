#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sdeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Drives the port's main path, grf16 MSGM sampling at full width (the
VorticityUNet score net with random weights from a seed, the circulant MSGM
SDE at d=256 built from 100k SmoothedGRF samples, norm-corrected RK4), and
holds every CUDA kernel of that path against its plain PyTorch version:

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
5. replays the last request (same x0 and noise) four times, plain,
   kernel, kernel, plain, the plain runs with the plain versions in place of
   the kernels: max |Δ| ≤ 1e-3·max |x| against the request, no launch in a
   plain run, the exact counts in a kernel run;
6. traces a 2-step request with torch.profiler: device time by kernel,
   the device's busy time and idle share;
7. times each kernel (CUDA events around back-to-back wrapper calls, and
   its device time from the trace) beside its bound and its plain version.
   No single PyTorch call computes K1 or K3, so library_ms is null.

Ends with the kernel table as one JSON line, then
{"ok": true, "device": {...}} as the last line. Exits non-zero without a
CUDA device, outside the repository, or when any check fails. With
--record, also writes the full record (every measurement, the profile's
top kernels) as JSON to PATH.
"""

from __future__ import annotations

import argparse
import json
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


def profile_request(gen, make_sampler_fn, g, dev):
    """Trace a PROFILED_STEPS-step request with torch.profiler: device
    time by kernel name, the device's busy time (union of kernel
    intervals) and idle share of the traced wall time."""
    sample = make_sampler_fn(gen, N_SAMPLES, DIM, PROFILED_STEPS,
                             method="rk4", norm_correction=True, device=dev)
    sample(g)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        sample(g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in p.events() if e.device_type == DeviceType.CUDA]
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
    for short in ("circulant_apply_kernel", "attn_block_kernel"):
        hits = [(ms, n) for name, (ms, n) in by_name.items() if short in name]
        if hits:
            per_launch[short] = sum(h[0] for h in hits) / sum(h[1] for h in hits)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "steps": PROFILED_STEPS, "wall_ms": wall_ms, "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / 1e3 / wall_ms,
        "kernel_ms_total": sum(ms for ms, _ in by_name.values()),
        "kernel_launches": len(kernels),
        "per_launch_ms": per_launch,
        "top": [{"name": n, "ms": ms, "calls": c} for n, (ms, c) in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", metavar="PATH",
                    help="write the full record as JSON to PATH")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sdeflow_tpu_torch import build_msgm_arm, get_preset, make_sampler_fn
    from sdeflow_tpu_torch.models import unet2d
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.ops.kernels.attnblock import (
        K3, attn_block_math, fused_attention_block)
    from sdeflow_tpu_torch.ops.kernels.circulant import (
        K1, circ_math, circulant_apply)
    from sdeflow_tpu_torch.sde import msgm

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
        want = {K1.name: K1_PER_STEP * STEPS, K3.name: K3_PER_STEP * STEPS}
        if launches != want:
            raise AssertionError(f"request {r}: launches {launches} != {want}")
        if (x - x0).abs().max().item() < 0.1:
            raise AssertionError(f"request {r}: the solve did not move x0")
        requests.append({"ms": dt * 1e3, "samples_per_s": N_SAMPLES / dt,
                         "launches": launches})
        log(f"request {r}: {dt * 1e3:.1f} ms, {N_SAMPLES / dt:.1f} samples/s,"
            f" launches {launches}")
    record["requests"] = requests

    # -- 5. replay the last request: plain, kernel, kernel, plain -----------
    # the plain runs swap the kernel wrappers for their plain versions where
    # the path calls them; alternating the order keeps drift out of the
    # comparison
    replay = []
    for mode in ("plain", "kernel", "kernel", "plain"):
        if mode == "plain":
            msgm.circulant_apply = circ_math
            unet2d.fused_attention_block = attn_block_math
        try:
            common.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_r = sample(g, x0=x0, noise=noise)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            msgm.circulant_apply = circulant_apply
            unet2d.fused_attention_block = fused_attention_block
        launched = {k.name: k.launches for k in common.KERNELS.values()}
        if launched != (want if mode == "kernel" else
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
    prof = profile_request(gen, make_sampler_fn, g, dev)
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
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": bound_ms(b1, f1)[0], "bound_by": bound_ms(b1, f1)[1],
         "library_ms": None, "shape": [N_SAMPLES, DIM],
         "device_ms": prof["per_launch_ms"].get("circulant_apply_kernel")},
        {"name": K3.name, "route": "cuda",
         "source": "sdeflow_tpu_torch/csrc/attnblock.cu",
         "replaces": "sdeflow_tpu/ops/pallas/attnblock.py:188",
         "launches": requests[-1]["launches"][K3.name],
         "max_abs_err": max(v["max_abs_err"] for v in k3.values()),
         "ms": avg("ms"), "plain_ms": avg("plain_ms"),
         "bound_ms": avg("bound_ms"),
         "bound_by": "operations" if all(
             v["bound_by"] == "operations" for v in k3.values()) else "bytes",
         "library_ms": None,
         "device_ms": prof["per_launch_ms"].get("attn_block_kernel"),
         "per_shape": [dict(v, blocks_per_forward=K3_PATH_MIX[s])
                       for s, v in k3.items()]},
    ]
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms per call (device "
            f"{k['device_ms']} ms), bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}), plain version {k['plain_ms']:.4f} ms; no "
            "single PyTorch call computes it, so no library time")
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
