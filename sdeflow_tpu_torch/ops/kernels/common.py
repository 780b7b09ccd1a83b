"""Shared plumbing for the hand-written CUDA kernels.

Counterpart of the JAX package's ops/pallas/common.py. Dispatch rule for
every kernel wrapper in this package:

- a tensor on the CPU goes to the kernel's plain PyTorch version (the CPU
  tests and nothing else take this branch);
- a CUDA tensor with no autograd recording (``torch.no_grad()``, or no
  input that requires grad) launches the kernel;
- a CUDA tensor with autograd recording raises: the kernels have no
  ``torch.autograd.Function`` yet (the JAX package differentiates through
  ``custom_jvp`` rules instead, ops/pallas/circulant.py:167-179 and
  ops/pallas/attnblock.py:268-272; the training slice brings them).

There is no fallback from a failed build or launch to the plain version.

Build: each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, at first use, under
``_build/`` beside this package's sources (git ignores it). The library's
file name carries a hash of the source and the flags, so an edited source is
rebuilt. The libraries are loaded with ``ctypes``; each C entry point
returns ``cudaGetLastError()`` after its launch, and the wrapper raises if it
is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises rather than carry on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


class Kernel:
    """One CUDA source, its shared library and its launch count.

    ``launches`` is a plain integer that the wrapper increments each time it
    launches the kernel (never for the plain version)."""

    def __init__(self, name: str, source: str, signatures: dict):
        self.name = name
        self.source = CSRC_DIR / source
        self.signatures = signatures  # C function -> ctypes argtypes
        self.launches = 0
        self._lib = None

    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc for this source unless its library is built; returns
        a handle for finish_build (None when there is nothing to build), so
        that several sources compile at once."""
        out = self.lib_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    @staticmethod
    def finish_build(handle):
        if handle is None:
            return
        proc, tmp, out = handle
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none

    def lib(self):
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.lib_path()))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args):
        """Call C entry point `fn` on the current stream; count it."""
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(self.lib(), fn)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
        self.launches += 1


KERNELS: dict = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all():
    """Build every registered kernel, one nvcc per source, all at once."""
    handles = [k.start_build() for k in KERNELS.values()]
    for h in handles:
        Kernel.finish_build(h)
    for k in KERNELS.values():
        k.lib()


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0


def use_kernel(*tensors) -> bool:
    """True if the wrapper must launch its kernel, False if it must run its
    plain version (every input on the CPU). Raises for mixed devices and
    for CUDA inputs under autograd recording."""
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return False
    if devs != {"cuda"}:
        raise ValueError(f"inputs on mixed devices: {sorted(devs)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the CUDA kernels have no autograd rule yet (ROADMAP Queue 1, "
            "training slice); call under torch.no_grad()"
        )
    return True


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())
