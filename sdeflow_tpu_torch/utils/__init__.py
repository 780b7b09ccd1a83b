"""Profiling utilities (port of sdeflow_tpu/utils/). The JAX package's
``utils/cache.py`` (XLA's persistent compile cache) has no counterpart:
the port's kernels build once into the ignored ``_build/`` directory."""

from sdeflow_tpu_torch.utils.profiling import (
    Timer, attention_flops, benchmark, block_until_ready, compiled_flops,
    device_memory_stats, device_seconds, host_rss_bytes, memory_report,
    param_count, peak_flops, trace)

__all__ = ["Timer", "attention_flops", "benchmark", "block_until_ready",
           "compiled_flops", "device_memory_stats", "device_seconds",
           "host_rss_bytes", "memory_report", "param_count", "peak_flops",
           "trace"]
