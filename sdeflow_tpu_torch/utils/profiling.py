"""Tracing and profiling utilities.

Port of sdeflow_tpu/utils/profiling.py:1-197 on ``torch.profiler`` and
``torch.cuda``:

- ``trace(dir)``: a ``torch.profiler`` context (CPU and, where a card is
  present, CUDA activity) that writes a Chrome trace under dir;
- ``Timer`` and ``benchmark``: host-clock timing that waits for the card
  (``torch.cuda.synchronize``; CUDA launches are asynchronous);
- ``device_seconds``: seconds per step as the slope between two chain
  lengths, by CUDA events on the card;
- ``compiled_flops``, ``peak_flops``, ``attention_flops``,
  ``param_count``: static cost accounting;
- ``host_rss_bytes``, ``device_memory_stats``, ``memory_report``: the
  ``--print-ram`` line.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import numpy as np
import torch


def _tensors(result):
    """The tensors in a result: a tensor, or lists, tuples and dicts of
    them (other leaves ignored)."""
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            yield from _tensors(v)


def block_until_ready(result):
    """Wait until the cards holding the tensors of `result` have computed
    them; returns `result`."""
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return result


@contextmanager
def trace(log_dir):
    """Capture a trace of what runs in the block, CPU and (where a card is
    present) CUDA activity, written as a Chrome trace ``trace.json``
    under log_dir (Perfetto or chrome://tracing reads it):
    ``with trace("/tmp/trace"): step()``. Yields the profiler.

    On an H100 with PyTorch 2.11 the first 46 kernels launched in a
    window were missing from its device activity, and none were after
    the block began with a 20 ms sleep (``chip_smoke.py`` phase 30)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


class Timer:
    """ms/step on the host clock, each step waiting for its result."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def step(self, result=None):
        if result is not None:
            block_until_ready(result)
        self.steps += 1

    def ms_per_step(self):
        if self.steps == 0:
            return float("nan")
        return (time.perf_counter() - self.t0) * 1000.0 / self.steps

    def reset(self):
        self.t0 = time.perf_counter()
        self.steps = 0


def benchmark(fn, *args, repeats=5, inner=1):
    """Best-of-N seconds per call; the first call (kernel builds, warm-up)
    is excluded."""
    block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def device_seconds(step, short=2, long=None, repeats=3, target=0.5):
    """Seconds per step of ``step(i)``, which returns a small tensor
    (i the step's index: fold it into the inputs so that no step repeats
    another's work).

    A chain of n steps sums the results on their device; its time is taken
    between two CUDA events on the card (a perf_counter around the chain
    and its read on the CPU), and the reported time is the slope between
    two chain lengths, so the constant cost of starting and reading a
    chain cancels. With long=None the longer chain is sized so that the
    slope spans about `target` seconds."""
    first = step(0)
    cuda = isinstance(first, torch.Tensor) and first.is_cuda

    def chain(n):
        acc = torch.zeros((), dtype=torch.float32, device=first.device)
        for i in range(n):
            acc = acc + step(i)
        return acc

    def run(n):
        if cuda:
            with torch.cuda.device(first.device):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                chain(n)
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        float(chain(n))
        return time.perf_counter() - t0

    run(short)  # warm
    if long is None:
        est = max((run(short + 14) - run(short)) / 14, 1e-6)
        long = short + int(min(2048, max(10, target / est)))
    t_short = min(run(short) for _ in range(repeats))
    t_long = min(run(long) for _ in range(repeats))
    return max((t_long - t_short) / (long - short), 1e-12)


def compiled_flops(fn, *args, **kwargs):
    """Floating-point operations of one call fn(*args, **kwargs), as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them: the aten
    products and convolutions (2 per multiply-add). It does not count the
    hand-written kernels (K1-K7b), which run outside aten, nor elementwise
    work."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


# Dense peak rates of one card, FLOP/s, from NVIDIA's H100 data sheet (the
# SXM part at its 700 W limit; a card set below it runs slower under load):
# bf16 on the tensor cores, TF32 on the tensor cores, fp32 outside them.
PEAK_FLOPS = {"h100 80gb hbm3": {"bf16": 989e12, "tf32": 494.7e12,
                                 "fp32": 67e12}}


def peak_flops(device=None):
    """The PEAK_FLOPS entry of the card `device` (default: the current
    one) by its name, ``torch.cuda.get_device_name``; None on the CPU or
    for a card the table does not hold."""
    if not torch.cuda.is_available():
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in PEAK_FLOPS.items():
        if key in name:
            return peak
    return None


def host_rss_bytes():
    """Resident set size of this process (from /proc/self/status; None
    where there is no procfs)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def device_memory_stats(device=None):
    """The card's allocator figures under the JAX package's keys:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (``torch.cuda``'s allocated
    bytes, current and peak: the peak is ``max_memory_allocated``) and
    ``bytes_limit`` (the card's memory, ``torch.cuda.mem_get_info``); None
    on the CPU."""
    if not torch.cuda.is_available():
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(device)[1]}


def memory_report(device=None):
    """One line of host and card memory, the format of the JAX package's
    (the working form of the reference's dormant print_RAM flag,
    MSGM_higherDim.py:397): host RSS, then the card's in-use, peak and
    limit, in MiB."""
    parts = []
    rss = host_rss_bytes()
    if rss is not None:
        parts.append(f"host rss {rss / 2**20:,.0f} MiB")
    stats = device_memory_stats(device)
    if stats:
        dev = [f"{label} {stats[key] / 2**20:,.0f} MiB" for label, key in (
            ("in_use", "bytes_in_use"), ("peak", "peak_bytes_in_use"),
            ("limit", "bytes_limit"))]
        parts.append("device " + " ".join(dev))
    return "RAM: " + (", ".join(parts) if parts else "unavailable")


def attention_flops(batch, spatial, channels):
    """Matmul FLOPs of one attention block: two (T², C) contractions,
    2·MACs (the reference's thop counter, model/unet.py:252-273, counts
    MACs)."""
    t = int(np.prod(spatial))
    return 2 * 2 * batch * t * t * channels


def param_count(params):
    """Number of parameters of an ``nn.Module`` or a state dict."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(int(np.prod(p.shape)) for p in params.values())
