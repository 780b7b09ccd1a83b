"""The port stands alone: importing it (every submodule) and chip_smoke.py
loads no JAX, no flax, nothing of the JAX package and neither pandas nor
netCDF4 (the card has neither), no source of the package names either of
those two, and its entry points (the sampler, the file-backed data)
refuse to fall back to the CPU quietly when no CUDA device is present."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import torch
import sdeflow_tpu_torch
for m in pkgutil.walk_packages(sdeflow_tpu_torch.__path__, "sdeflow_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sdeflow_tpu",
                                    "pandas", "netCDF4"))
assert not bad, bad
from sdeflow_tpu_torch.data import ArraySampler
from sdeflow_tpu_torch.serving import make_sampler_fn
if not torch.cuda.is_available():
    for fn in (lambda: make_sampler_fn(None, 4, 256, 2),
               lambda: ArraySampler([[0.0]], [[0.0]], 1, "probe")):
        try:
            fn()
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("an entry point fell back to the CPU")
print("isolated")
"""


def test_no_source_of_the_port_names_pandas_or_netcdf4():
    pattern = re.compile(r"^\s*(import|from)\s+(pandas|netCDF4)\b", re.M)
    sources = [*sorted((ROOT / "sdeflow_tpu_torch").rglob("*.py")),
               ROOT / "chip_smoke.py"]
    assert len(sources) > 40
    hits = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not hits, hits


def test_port_imports_no_jax_and_refuses_missing_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("isolated")
