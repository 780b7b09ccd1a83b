#!/usr/bin/env python3
"""The attention kernels whose code a change leaves alone, from this tree
against the same kernels built from another tree of the package, bit for
bit, on one NVIDIA GPU; and K3 bf16 of both trees timed in turns.

    python3 tools/torch_bf16_parent.py PARENT_DIR

PARENT_DIR holds another checkout of the repository (for example the
parent commit unpacked by ``git archive`` into the git-ignored
``_parent/``). Both trees' ``csrc/attnblock.cu`` (K3), ``csrc/attention.cu``
(K6), ``csrc/attention_bwd.cu`` (K7b) and ``csrc/flash_fwd.cu`` (K4 and
K7a) are built with nvcc, each against its own tree's headers; every
kernel of the bit-for-bit check runs through this tree's wrapper on both
libraries:

- K3 in float32 at grf16's two AttentionBlock shapes, (B, T, C) =
  (1024, 64, 64) and (1024, 16, 128), with random non-zero weights;
- K6 in bf16 on its short path (grf16's two shapes, and T = 13 with head
  width 10 and two heads) and its tiled path (the DSM step's
  (128, 1024, 128), T = 65 and 1000 with three and four heads);
- K7b in bf16 (dqkv) at the DSM step's (128, 4096, 64), at (4, 4096, 64),
  head width 128, and head width 30 (element copies) with two heads, from
  this tree's K7a lse;
- K4 and K7a in float32 (out, and K7a's lse) at (4, 4096, 64) with one and
  two heads and (2, 2048, 128).

Then K3 bf16 (which sums in another order than the parent's body, so it
is not held bit for bit) at the production request's two shapes (B =
1024) and the bf16 SSM step's (B = 128), one head, groups 32, through each
tree's own wrapper, in turns (parent, this tree, this tree, parent): the
kernel's device time (a trace), a direct launch (``_launch``; the
parent's casts and transposes the weights first) and a call through the
Function, by CUDA events. Prints the card's name and power limit and one
JSON line of the times.

Exits non-zero unless every output of the bit-for-bit check is equal.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sdeflow_tpu_torch.models.common import group_count  # noqa: E402
from sdeflow_tpu_torch.ops.kernels import attention as ak  # noqa: E402
from sdeflow_tpu_torch.ops.kernels import attnblock as ab  # noqa: E402
from sdeflow_tpu_torch.ops.kernels import common  # noqa: E402

K3_SHAPES = [(1024, 64, 64, 1), (1024, 16, 128, 1)]
K3_BF16_TIMED = [(1024, 64, 64), (1024, 16, 128), (128, 64, 64),
                 (128, 16, 128)]
K6_SHAPES = [(1024, 64, 64, 1), (1024, 16, 128, 1), (5, 13, 20, 2),
             (128, 1024, 128, 1), (3, 65, 72, 3), (2, 1000, 160, 4)]
K7B_SHAPES = [(128, 4096, 64, 1), (4, 4096, 64, 1), (2, 2048, 128, 1),
              (2, 1536, 60, 2)]
FP32_SHAPES = [(4, 4096, 64, 1), (4, 4096, 64, 2), (2, 2048, 128, 1)]


def parent_lib(kernel, parent):
    """The kernel's source in the parent tree, built against that tree's
    headers (Kernel hashes and includes the headers beside its source)."""
    src = (Path(parent).resolve() / "sdeflow_tpu_torch" / "csrc"
           / kernel.source.name)
    old = common.CSRC_DIR
    common.CSRC_DIR = src.parent
    try:
        return common.Kernel(f"{kernel.name}_parent", str(src),
                             kernel.signatures).lib()
    finally:
        common.CSRC_DIR = old


def same(a, b):
    return torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a.view(torch.int32),
                       b.view(torch.int16) if b.dtype == torch.bfloat16
                       else b.view(torch.int32))


def compare(what, kernel, libs, run):
    """run() on each library; True if every output agrees bit for bit."""
    outs = {}
    try:
        for name, lib in libs.items():
            kernel._lib = lib
            outs[name] = run()
    finally:
        kernel._lib = libs["this tree"]
    torch.cuda.synchronize()
    equal = all(same(a, b) for a, b in zip(outs["this tree"],
                                           outs["parent"]))
    print(f"{what}: bit for bit {'equal' if equal else 'DIFFERENT'} to the "
          "parent's")
    return equal


def main(parent):
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    equal = True
    libs = {"this tree": ab.K3.lib(), "parent": parent_lib(ab.K3, parent)}
    for b, t, c, heads in K3_SHAPES:
        args = [2.0 * rnd(b, t, c) + 0.5,
                1.0 + 0.1 * rnd(c), 0.1 * rnd(c), rnd(c, 3 * c) / c**0.5,
                0.1 * rnd(3 * c), rnd(c, c) / c**0.5, 0.1 * rnd(c)]
        with torch.no_grad():
            equal &= compare(
                f"K3 float32 at {(b, t, c)} heads={heads}", ab.K3, libs,
                lambda: [ab._launch(*args, group_count(c), heads)])
    for kernel, shapes in ((ak.K6, K6_SHAPES), (ak.K7B, K7B_SHAPES)):
        libs = {"this tree": kernel.lib(),
                "parent": parent_lib(kernel, parent)}
        for b, t, c, heads in shapes:
            qkv = (1.5 * rnd(b, t, 3 * c)).to(torch.bfloat16)
            with torch.no_grad():
                if kernel is ak.K6:
                    equal &= compare(
                        f"K6 bf16 at {(b, t, c)} heads={heads}", kernel,
                        libs, lambda: [ak._launch(qkv, heads)])
                    continue
                dout = rnd(b, t, c).to(torch.bfloat16)
                out, lse = ak._launch_stats(qkv, heads)
                delta = (ak._heads(dout, heads).float()
                         * ak._heads(out, heads).float()).sum(-1)
                equal &= compare(
                    f"K7b bf16 at {(b, t, c)} heads={heads}", kernel, libs,
                    lambda: [ak._launch_bwd(qkv, dout, lse, delta, heads)])
                del dout, out, lse, delta
            del qkv
    # K4 and K7a share flash_fwd.cu: one parent library serves both; their
    # float32 body (flash_fwd.cuh) is the one this comparison holds
    both = common.Kernel("flash_fwd", "flash_fwd.cu",
                         {**ak.K4.signatures, **ak.K7A.signatures})
    flash = parent_lib(both, parent)
    for b, t, c, heads in FP32_SHAPES:
        qkv = 1.5 * rnd(b, t, 3 * c)
        with torch.no_grad():
            equal &= compare(
                f"K4 float32 at {(b, t, c)} heads={heads}", ak.K4,
                {"this tree": ak.K4.lib(), "parent": flash},
                lambda: [ak._launch(qkv, heads)])
            equal &= compare(
                f"K7a float32 at {(b, t, c)} heads={heads}", ak.K7A,
                {"this tree": ak.K7A.lib(), "parent": flash},
                lambda: list(ak._launch_stats(qkv, heads)))
        del qkv
    time_k3_bf16(parent, rnd)
    return 0 if equal else 1


def parent_attnblock(parent):
    """The parent tree's ops/kernels/attnblock.py as a module of its own,
    its K3 on the parent's library; this tree's K3 stays the registered
    one."""
    path = (Path(parent).resolve() / "sdeflow_tpu_torch" / "ops" / "kernels"
            / "attnblock.py")
    spec = importlib.util.spec_from_file_location("parent_attnblock", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    common.KERNELS[ab.K3.name] = ab.K3
    mod.K3._lib = parent_lib(mod.K3, parent)
    return mod


def time_k3_bf16(parent, rnd):
    """K3 bf16 of the parent and of this tree in turns at K3_BF16_TIMED."""
    from chip_smoke import cuda_ms, kernel_times

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    trees = {"parent": parent_attnblock(parent), "this tree": ab}
    rows = []
    for b, t, c in K3_BF16_TIMED:
        args = [(2.0 * rnd(b, t, c) + 0.5).to(torch.bfloat16),
                1.0 + 0.1 * rnd(c), 0.1 * rnd(c), rnd(c, 3 * c) / c**0.5,
                0.1 * rnd(3 * c), rnd(c, c) / c**0.5, 0.1 * rnd(c)]
        groups = group_count(c)
        row = {"shape": [b, t, c], "heads": 1, "groups": groups}
        for name in ("parent", "this tree", "this tree", "parent"):
            mod = trees[name]
            with torch.no_grad():
                ker = kernel_times(lambda: mod._launch(*args, groups, 1), 20)
                dev = [ms for k, v in ker.items() for ms in v
                       if "attn_block_bf16_kernel" in k]
                times = {
                    "device_ms": sum(dev) / len(dev),
                    "kernels_per_call": sum(map(len, ker.values())) / 20,
                    "direct_ms": cuda_ms(lambda: mod._launch(*args, groups,
                                                             1)),
                    "ms": cuda_ms(lambda: mod.fused_attention_block(
                        *args, groups, 1))}
            for k, v in times.items():
                row.setdefault(f"{name} {k}", []).append(v)
        rows.append(row)
        print(f"K3 bf16 at {(b, t, c)}: " + "; ".join(
            f"{k} " + ", ".join(f"{x:.4f}" for x in v)
            for k, v in row.items() if isinstance(v, list)))
        del args
    print(json.dumps({"card": card, "k3_bf16_times": rows}))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
