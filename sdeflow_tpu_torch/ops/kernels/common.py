"""Shared plumbing for the hand-written CUDA kernels.

Counterpart of the JAX package's ops/pallas/common.py. Dispatch rule for
every kernel wrapper in this package: the device alone decides.

- Every wrapper goes through its ``torch.autograd.Function``
  (``kernel_function`` below). Its ``forward`` launches the kernel on CUDA
  tensors and runs the plain PyTorch version on CPU tensors (the CPU tests
  and nothing else take that branch).
- Its ``backward`` is the plain version's vector-Jacobian product. With
  grad mode off (every training path) autograd takes it on detached copies
  of the saved inputs. With grad mode on (``create_graph=True``, or inside
  ``torch.func.grad``) it is itself differentiable, so a second reverse
  pass is exact, as JAX's ``custom_jvp`` rules are to any order:
  ``torch.func.vjp`` of the plain version, or, for the attention core's
  checkpointed tiled plain version above T = 1024 (which ``torch.func``
  refuses), autograd with ``create_graph`` on the saved tensors; inside a
  ``torch.func`` transform that last case raises. Its forward-mode rule
  ``jvp`` is a closed form
  written beside each plain version (``circ_math_jvp``, ``rk4_math_jvp``,
  ``attn_block_jvp``, ``gn_math_jvp``, ``attention_jvp``), in plain
  PyTorch, as the JAX package's ``custom_jvp`` rules evaluate the plain
  math (ops/pallas/circulant.py:149-179, ops/pallas/attnblock.py:268-272,
  ops/pallas/groupnorm.py:147-151, ops/pallas/attention.py:279-288). So a
  kernel runs under autograd and under ``torch.func.jvp`` alike, and the
  gradient of a JVP (the SSM loss) flows through the plain rules. A rule
  recomputes the plain intermediates it needs (the GroupNorm statistics,
  the softmax weights), which the kernel does not keep.
- Raw pointers are taken only inside ``forward``, which receives plain
  tensors even under ``torch.func`` transforms.

There is no fallback from a failed build or launch to the plain version.

Build: each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, at first use, under
``_build/`` beside this package's sources (git ignores it). The library's
file name carries a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt. The libraries are loaded with ``ctypes``; each C entry point
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
        for header in sorted(CSRC_DIR.glob("*.cuh")):  # the shared helpers
            h.update(header.read_bytes())
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
    """Build every registered kernel, one nvcc per source (two kernels may
    share one), all at once."""
    sources = {k.lib_path(): k for k in KERNELS.values()}
    handles = [k.start_build() for k in sources.values()]
    for h in handles:
        Kernel.finish_build(h)
    for k in KERNELS.values():
        k.lib()


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0


def use_kernel(*tensors) -> bool:
    """True if the wrapper must launch its kernel (every input on CUDA),
    False if it must run its plain version (every input on the CPU).
    Raises for mixed devices."""
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return False
    if devs != {"cuda"}:
        raise ValueError(f"inputs on mixed devices: {sorted(devs)}")
    return True


def _in_functorch(ts):
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in ts)


def _differentiable_vjp(plain, ctx, grad, checkpointed):
    """The plain version's vector-Jacobian product as a differentiable
    function of the saved inputs and of grad (a backward under
    create_graph, or inside torch.func): ``torch.func.vjp`` of the plain
    version, or, where the plain version checkpoints (``torch.func``
    refuses that), autograd with create_graph on the saved tensors
    themselves; that last case raises inside a torch.func transform."""
    ts = ctx.saved_tensors
    if not checkpointed(*ts, *ctx.static):
        _, vjp = torch.func.vjp(lambda *a: plain(*a, *ctx.static), *ts)
        return vjp(grad)
    if _in_functorch((*ts, grad)):
        raise NotImplementedError(
            f"a reverse pass inside torch.func through {ctx.name}'s "
            "checkpointed plain version (the attention core's tiled math "
            "above T = 1024) is not supported: torch.func refuses "
            "checkpoints; use torch.autograd.grad(..., create_graph=True)")
    need = [i for i, t in enumerate(ts) if t.requires_grad]
    out = plain(*ts, *ctx.static)
    got = (torch.autograd.grad(out, [ts[i] for i in need], grad,
                               create_graph=True, allow_unused=True)
           if need and out.requires_grad else [None] * len(need))
    grads = [None] * len(ts)
    for i, gi in zip(need, got):
        grads[i] = gi
    return grads


def kernel_function(name, plain, launch, tangent, n_tensors,
                    checkpointed=lambda *args: False):
    """A ``torch.autograd.Function`` (setup_context style, so that
    ``torch.func`` transforms it) for one kernel.

    ``plain(*tensors, *static)`` is the plain version, ``launch(*tensors,
    *static)`` the kernel's launcher and ``tangent(*tensors, *static,
    *tangents)`` the plain version's Jacobian-vector product, a tangent
    being None where its input has none; the first ``n_tensors`` arguments
    are tensors, the rest static values (no gradient). ``forward`` picks by
    device (``use_kernel``); ``backward`` is the plain version's
    vector-Jacobian product and ``jvp`` is ``tangent``. Call it as
    ``Fn.apply(*tensors, *static)``."""

    def forward(*args):
        if use_kernel(*args[:n_tensors]):
            return launch(*args)
        return plain(*args)

    def setup_context(ctx, inputs, output):
        ctx.name = name
        ctx.save_for_backward(*inputs[:n_tensors])
        ctx.save_for_forward(*inputs[:n_tensors])
        ctx.static = inputs[n_tensors:]

    def backward(ctx, grad):
        if torch.is_grad_enabled():  # create_graph, or inside torch.func
            grads = _differentiable_vjp(plain, ctx, grad, checkpointed)
        else:
            with torch.enable_grad():
                ts = [t.detach().requires_grad_() for t in ctx.saved_tensors]
                grads = torch.autograd.grad(plain(*ts, *ctx.static), ts,
                                            grad, allow_unused=True)
        return (*grads, *(None,) * len(ctx.static))

    def jvp(ctx, *tangents):
        return tangent(*ctx.saved_tensors, *ctx.static,
                       *tangents[:n_tensors])

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward),
        "setup_context": staticmethod(setup_context),
        "backward": staticmethod(backward),
        "jvp": staticmethod(jvp),
    })


def add(a, b):
    """a + b, where None stands for a zero tangent."""
    if a is None:
        return b
    return a if b is None else a + b


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())
