"""The profiling utilities (sdeflow_tpu_torch/utils/profiling.py) against
the JAX package's where both count the same thing: ``param_count`` of a
small U-Net converted from JAX's parameters (module and state dict),
``attention_flops``, ``memory_report``'s line (the same host and device
figures give the same text); and on the CPU: ``compiled_flops`` of a
Linear (2·B·in·out), ``peak_flops`` and ``device_memory_stats`` None,
``Timer``, ``benchmark`` and ``device_seconds`` positive, ``trace``
writing a Chrome trace that names the traced operator."""

import json
import re

import pytest
import torch

from sdeflow_tpu.utils import profiling as jax_profiling
from sdeflow_tpu_torch.models.convert import flax_to_state_dict
from sdeflow_tpu_torch.utils import profiling

from test_torch_models import SMALL, _pair

torch.set_num_threads(1)


def test_param_count_of_a_converted_unet_matches_jax():
    _, tmodel, params, _, _ = _pair(SMALL, 2)
    n = jax_profiling.param_count(params)
    assert n > 10_000
    assert profiling.param_count(tmodel) == n
    assert profiling.param_count(flax_to_state_dict(params, tmodel)) == n


def test_attention_flops_matches_jax():
    for args in ((4, (8, 8), 64), (128, (4096,), 64), (1, 16, 128)):
        assert profiling.attention_flops(*args) == \
            jax_profiling.attention_flops(*args)


def test_compiled_flops_counts_a_linear():
    b, n_in, n_out = 3, 7, 5
    layer = torch.nn.Linear(n_in, n_out)
    x = torch.randn(b, n_in)
    assert profiling.compiled_flops(layer, x) == 2 * b * n_in * n_out


@pytest.mark.parametrize("device_stats", [False, True])
def test_memory_report_is_the_jax_line(monkeypatch, device_stats):
    stats = (dict(bytes_in_use=3 * 2**20, peak_bytes_in_use=1234 * 2**20,
                  bytes_limit=81_559 * 2**20) if device_stats else None)
    for mod in (profiling, jax_profiling):
        monkeypatch.setattr(mod, "host_rss_bytes", lambda: 2_500 * 2**20)
        monkeypatch.setattr(mod, "device_memory_stats",
                            lambda device=None: stats)
    line = profiling.memory_report()
    assert line == jax_profiling.memory_report()
    want = "RAM: host rss 2,500 MiB" + (
        ", device in_use 3 MiB peak 1,234 MiB limit 81,559 MiB"
        if device_stats else "")
    assert line == want


def test_cpu_has_no_peak_and_no_device_memory():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profiling.peak_flops() is None
    assert profiling.device_memory_stats() is None
    assert re.fullmatch(r"RAM: host rss [\d,]+ MiB", profiling.memory_report())


def test_timers_on_the_cpu():
    a = torch.randn(64, 64)
    timer = profiling.Timer()
    for _ in range(3):
        timer.step(a @ a)
    assert timer.steps == 3 and timer.ms_per_step() > 0
    assert profiling.benchmark(torch.mm, a, a, repeats=2) > 0
    secs = profiling.device_seconds(lambda i: (a * (i + 1)).sum(), long=12)
    assert 0 < secs < 1


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(32, 32)
    with profiling.trace(tmp_path / "trace"):
        torch.mm(a, a)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aten::mm" in names
