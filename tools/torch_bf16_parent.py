#!/usr/bin/env python3
"""The kernels whose code a change leaves alone, from this tree against the
same kernels built from another tree of the package, bit for bit, on one
NVIDIA GPU; and K6 bf16's short path, K5 bf16 and K5b bf16 of both trees
timed in turns.

    python3 tools/torch_bf16_parent.py PARENT_DIR

PARENT_DIR holds another checkout of the repository (for example the
parent commit unpacked by ``git archive`` into the git-ignored
``_parent/``). Both trees' ``csrc/attnblock.cu`` (K3), ``csrc/attention.cu``
(K6), ``csrc/attention_bwd.cu`` (K7b), ``csrc/flash_fwd.cu`` (K4 and K7a)
and ``csrc/groupnorm.cu`` (K5 and K5b) are built with nvcc, each against
its own tree's headers; every kernel of the bit-for-bit check runs through
this tree's wrapper on both libraries:

- K3 in float32 at grf16's two AttentionBlock shapes, (B, T, C) =
  (1024, 64, 64) and (1024, 16, 128), and in bf16 there and at the bf16
  SSM step's B = 128, with random non-zero weights;
- K6 in bf16 on its tiled path (the DSM step's (128, 1024, 128), T = 65
  and 1000 with three and four heads);
- K7b in bf16 (dqkv) at the DSM step's (128, 4096, 64), at (4, 4096, 64),
  head width 128, and head width 30 (element copies) with two heads, from
  this tree's K7a lse;
- K4 and K7a in float32 (out, and K7a's lse) at (4, 4096, 64) with one and
  two heads and (2, 2048, 128);
- K5 and K5b in float32 (out; dx, dγ, dβ), SiLU on and off, at
  GN_SHAPES: grf16's slabs at B = 1024 and the DSM step's at B = 128;
- K5 in bf16 at every (C, S) of grf16's GroupNorm mix at B = 1024, SiLU
  on and off: slabs of its small plan, whose sums keep their order.

Then K6 bf16's short path, K5 bf16 and K5b bf16 (K5 bf16 on its cluster
plan and K5b bf16 sum in another order than the parent's, so they are not
held bit for bit there), through each tree's own wrapper, in turns
(parent, this tree, this tree, parent): K6 at the
production request's two shapes (B = 1024) and the bf16 SSM step's
(B = 128), one head: the kernel's device time alone (a trace), warm (the
same inputs every launch) and cold (launches rotating through inputs of
more than 100 MB, twice the 50 MB L2), a direct launch (``_launch``) warm
and cold, and a call through the Function, by CUDA events; K5 bf16 at
every (C, S, SiLU) of the bf16 DSM step's GroupNorm mix (B = 128), of
grf16's production request (B = 1024) and of its bf16 SSM step (B = 128),
and K5b bf16 at the DSM step's and the SSM step's: device time per call (a
trace: for K5b the kernel and its dγ/dβ launch) and a direct launch
(``_launch``, ``_launch_vjp``), averaged over each mix by its calls.
Prints the card's name and power limit and one JSON line of the times.

Exits non-zero unless every output of the bit-for-bit check is equal.
"""

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sdeflow_tpu_torch.models.common import group_count  # noqa: E402
from sdeflow_tpu_torch.ops.kernels import attention as ak  # noqa: E402
from sdeflow_tpu_torch.ops.kernels import attnblock as ab  # noqa: E402
from sdeflow_tpu_torch.ops.kernels import common  # noqa: E402
from sdeflow_tpu_torch.ops.kernels import groupnorm as gk  # noqa: E402

K3_SHAPES = [(1024, 64, 64, 1), (1024, 16, 128, 1)]
K3_BF16_SHAPES = [(1024, 64, 64), (1024, 16, 128), (128, 64, 64),
                  (128, 16, 128)]
K6_SHAPES = [(128, 1024, 128, 1), (3, 65, 72, 3), (2, 1000, 160, 4)]
K7B_SHAPES = [(128, 4096, 64, 1), (4, 4096, 64, 1), (2, 2048, 128, 1),
              (2, 1536, 60, 2)]
FP32_SHAPES = [(4, 4096, 64, 1), (4, 4096, 64, 2), (2, 2048, 128, 1)]
GN_SHAPES = [(1024, 64, 64), (1024, 128, 16), (128, 32, 16384),
             (128, 96, 16384), (128, 256, 1024)]
K6_SHORT_TIMED = [(1024, 64, 64), (1024, 16, 128), (128, 64, 64),
                  (128, 16, 128)]
COLD_BYTES = 100e6  # inputs rotated through for a cold reading
TURNS = ("parent", "this tree", "this tree", "parent")


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


def parent_module(name, parent):
    """The parent tree's ops/kernels/<name>.py as a module of its own, its
    kernels on the parent's libraries (one a source); this tree's kernels
    stay the registered ones."""
    path = (Path(parent).resolve() / "sdeflow_tpu_torch" / "ops" / "kernels"
            / f"{name}.py")
    mine = dict(common.KERNELS)
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    common.KERNELS.clear()
    common.KERNELS.update(mine)
    kernels = [k for k in vars(mod).values() if isinstance(k, common.Kernel)]
    for src in {k.source.name for k in kernels}:
        same = [k for k in kernels if k.source.name == src]
        sigs = {fn: a for k in same for fn, a in k.signatures.items()}
        lib = parent_lib(common.Kernel(f"{name}_{src}", src, sigs), parent)
        for k in same:
            k._lib = lib
    return mod


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


def block_args(rnd, b, t, c, dtype=torch.float32):
    return [(2.0 * rnd(b, t, c) + 0.5).to(dtype), 1.0 + 0.1 * rnd(c),
            0.1 * rnd(c), rnd(c, 3 * c) / c**0.5, 0.1 * rnd(3 * c),
            rnd(c, c) / c**0.5, 0.1 * rnd(c)]


def gn_args(rnd, b, c, s, dtype):
    return ((2.0 * rnd(b, c, s) + 0.5).to(dtype), 1.0 + 0.1 * rnd(c),
            0.1 * rnd(c), rnd(b, c, s).to(dtype))


def bit_for_bit(mods, rnd, grf16):
    """Every kernel this change leaves alone, on both libraries; K5 bf16 at
    grf16's GroupNorm mix."""
    from chip_smoke import N_SAMPLES

    equal = True
    libs = {"this tree": ab.K3.lib(), "parent": mods["attnblock"].K3._lib}
    for b, t, c, heads in K3_SHAPES:
        args = block_args(rnd, b, t, c)
        with torch.no_grad():
            equal &= compare(
                f"K3 float32 at {(b, t, c)} heads={heads}", ab.K3, libs,
                lambda: [ab._launch(*args, group_count(c), heads)])
    for b, t, c in K3_BF16_SHAPES:
        args = block_args(rnd, b, t, c, torch.bfloat16)
        with torch.no_grad():
            equal &= compare(
                f"K3 bf16 at {(b, t, c)}", ab.K3, libs,
                lambda: [ab._launch(*args, group_count(c), 1)])
    pk = mods["attention"]
    for kernel, pkernel, shapes in ((ak.K6, pk.K6, K6_SHAPES),
                                    (ak.K7B, pk.K7B, K7B_SHAPES)):
        libs = {"this tree": kernel.lib(), "parent": pkernel._lib}
        for b, t, c, heads in shapes:
            qkv = (1.5 * rnd(b, t, 3 * c)).to(torch.bfloat16)
            with torch.no_grad():
                if kernel is ak.K6:
                    equal &= compare(
                        f"K6 bf16 (tiled) at {(b, t, c)} heads={heads}",
                        kernel, libs, lambda: [ak._launch(qkv, heads)])
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
    for b, t, c, heads in FP32_SHAPES:
        qkv = 1.5 * rnd(b, t, 3 * c)
        with torch.no_grad():
            equal &= compare(
                f"K4 float32 at {(b, t, c)} heads={heads}", ak.K4,
                {"this tree": ak.K4.lib(), "parent": pk.K4._lib},
                lambda: [ak._launch(qkv, heads)])
            equal &= compare(
                f"K7a float32 at {(b, t, c)} heads={heads}", ak.K7A,
                {"this tree": ak.K7A.lib(), "parent": pk.K7A._lib},
                lambda: list(ak._launch_stats(qkv, heads)))
        del qkv
    pg = mods["groupnorm"]
    for b, c, s in GN_SHAPES:
        groups = group_count(c)
        x, gamma, beta, dy = gn_args(rnd, b, c, s, torch.float32)
        for silu in (False, True):
            with torch.no_grad():
                equal &= compare(
                    f"K5 float32 at {(b, c, s)} silu={silu}", gk.K5,
                    {"this tree": gk.K5.lib(), "parent": pg.K5._lib},
                    lambda: [gk._launch(x, gamma, beta, groups, silu)])
                equal &= compare(
                    f"K5b float32 at {(b, c, s)} silu={silu}", gk.K5B,
                    {"this tree": gk.K5B.lib(), "parent": pg.K5B._lib},
                    lambda: list(gk._launch_vjp(
                        x, gamma, beta, groups, silu, dy)))
        del x, gamma, beta, dy
    for c, s in sorted({(c, s) for c, s, _ in grf16}):
        groups = group_count(c)
        x, gamma, beta, _ = gn_args(rnd, N_SAMPLES, c, s, torch.bfloat16)
        for silu in (False, True):
            with torch.no_grad():
                equal &= compare(
                    f"K5 bf16 at {(N_SAMPLES, c, s)} silu={silu}", gk.K5,
                    {"this tree": gk.K5.lib(), "parent": pg.K5._lib},
                    lambda: [gk._launch(x, gamma, beta, groups, silu)])
        del x, gamma, beta
    return equal


def cycled(make, nbytes):
    """fn(i) over enough inputs made by make() to pass COLD_BYTES, taken in
    turn: a call that finds its input out of L2."""
    inputs = [make() for _ in range(max(2, math.ceil(COLD_BYTES / nbytes)))]
    state = {"i": 0}

    def take():
        state["i"] = (state["i"] + 1) % len(inputs)
        return inputs[state["i"]]
    return take


def time_k6_short(mods, rnd):
    """K6 bf16 up to T = 64 of both trees in turns at K6_SHORT_TIMED."""
    from chip_smoke import cuda_ms, kernel_times

    trees = {"parent": mods["attention"], "this tree": ak}
    rows = []
    for b, t, c in K6_SHORT_TIMED:
        qkv = (1.5 * rnd(b, t, 3 * c)).to(torch.bfloat16)
        take = cycled(lambda: (1.5 * rnd(b, t, 3 * c)).to(torch.bfloat16),
                      qkv.numel() * 2)
        row = {"shape": [b, t, c], "heads": 1}
        for name in TURNS:
            mod = trees[name]
            with torch.no_grad():
                warm = kernel_times(lambda: mod._launch(qkv, 1), 50)
                cold = kernel_times(lambda: mod._launch(take(), 1), 50)
                dev = {k: [ms for n, v in ker.items() for ms in v
                           if "qkv_attention_bf16_kernel" in n]
                       for k, ker in (("warm", warm), ("cold", cold))}
                times = {
                    "device_ms": sum(dev["warm"]) / len(dev["warm"]),
                    "device_cold_ms": sum(dev["cold"]) / len(dev["cold"]),
                    "kernels_per_call": sum(map(len, warm.values())) / 50,
                    "direct_ms": cuda_ms(lambda: mod._launch(qkv, 1), 100),
                    "direct_cold_ms": cuda_ms(
                        lambda: mod._launch(take(), 1), 100),
                    "ms": cuda_ms(lambda: mod.qkv_attention(qkv, 1), 100)}
            for k, v in times.items():
                row.setdefault(f"{name} {k}", []).append(v)
        rows.append(row)
        print(f"K6 bf16 short at {(b, t, c)}: " + "; ".join(
            f"{k} " + ", ".join(f"{x:.5f}" for x in v)
            for k, v in row.items() if k.startswith(TURNS)))
        del qkv, take
    return rows


def time_gn(mods, rnd, mix, b, what):
    """K5 bf16 (what = "K5") or K5b bf16 ("K5b") of both trees in turns at
    every (C, S, SiLU) of a GroupNorm mix at batch b; the mix's means per
    launch."""
    from chip_smoke import cuda_ms, device_per_call

    trees = {"parent": mods["groupnorm"], "this tree": gk}
    rows = []
    for (c, s, silu), calls in sorted(mix.items()):
        torch.cuda.empty_cache()
        x, gamma, beta, dy = gn_args(rnd, b, c, s, torch.bfloat16)
        groups = group_count(c)
        row = {"shape": [b, c, s], "silu": silu, "calls": calls}
        for name in TURNS:
            mod = trees[name]
            if what == "K5":
                fn = lambda: mod._launch(  # noqa: E731
                    x, gamma, beta, groups, silu)
            else:
                fn = lambda: mod._launch_vjp(  # noqa: E731
                    x, gamma, beta, groups, silu, dy)
            with torch.no_grad():
                dev, kernels = device_per_call(fn, 10)
                times = {"device_ms": dev, "kernels_per_call": kernels,
                         "direct_ms": cuda_ms(fn, 20)}
            for k, v in times.items():
                row.setdefault(f"{name} {k}", []).append(v)
        rows.append(row)
        print(f"{what} bf16 at {(b, c, s)} silu={silu} x{calls}: " + "; ".join(
            f"{k} " + ", ".join(f"{v:.5f}" for v in vs)
            for k, vs in row.items() if k.startswith(TURNS)))
        del x, gamma, beta, dy
    n = sum(r["calls"] for r in rows)
    mean = {k: [sum(r[k][i] * r["calls"] for r in rows) / n
                for i in range(2)]
            for k in rows[0] if k.startswith(TURNS)}
    print(f"{what} bf16 mix at B = {b}, per launch: " + "; ".join(
        f"{k} " + ", ".join(f"{v:.5f}" for v in vs)
        for k, vs in mean.items()))
    return {"per_shape": rows, "mean_per_launch": mean}


def main(parent):
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (DIM, N_SAMPLES, SGM_BATCH, SGM_GN_MIX,
                            TRAIN_BATCH, gn_mix)
    from sdeflow_tpu_torch import get_preset
    from sdeflow_tpu_torch.experiments.driver import make_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    mods = {name: parent_module(name, parent)
            for name in ("attnblock", "attention", "groupnorm")}
    grf16 = gn_mix(make_model(get_preset("grf16"), DIM, "NormalizeLogRadius",
                              device="cuda"), "cuda")
    equal = bit_for_bit(mods, rnd, grf16)
    record = {"card": card, "bit_for_bit": equal,
              "k6_bf16_short": time_k6_short(mods, rnd),
              "k5_bf16_dsm": time_gn(mods, rnd, SGM_GN_MIX, SGM_BATCH, "K5"),
              "k5_bf16_grf16": time_gn(mods, rnd, grf16, N_SAMPLES, "K5"),
              "k5_bf16_ssm": time_gn(mods, rnd, grf16, TRAIN_BATCH, "K5"),
              "k5b_bf16_dsm": time_gn(mods, rnd, SGM_GN_MIX, SGM_BATCH,
                                      "K5b"),
              "k5b_bf16_ssm": time_gn(mods, rnd, grf16, TRAIN_BATCH, "K5b")}
    print(json.dumps(record))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
