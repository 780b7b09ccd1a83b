#!/usr/bin/env python3
"""The host cost of the registered ``sdeflow`` operators: this tree against
another tree of the package, in turns, on one NVIDIA GPU.

    python3 tools/torch_op_host_cost.py PARENT_DIR

PARENT_DIR holds another checkout of the repository (for example the
parent commit unpacked by ``git archive`` into the git-ignored
``_parent/``). Each tree runs in a process of its own, in the order
parent, this tree, this tree, parent; where both trees' kernel sources
are the same, the parent takes this tree's built libraries (their file
names hash the sources). Each process measures, with random weights from
one seed:

- grf16_production's request (the MSGM arm, bf16, 1,024 samples, EM-32
  with one Langevin corrector step, norm-corrected): one warm request,
  then REQUESTS requests, host clock around each, synchronized;
- grf16's SSM train step (the MSGM arm, fp32, batch 128, Adam through the
  Trainer): WARM_STEPS steps, then STEPS steps timed together;
- the host time per call of the K5 and K1 wrappers on small CUDA tensors
  (CALLS calls back to back, synchronized at the end): the dispatch cost
  alone, which the operator changes.

Prints the card's name and power limit, one JSON line per process and a
last JSON line with all of them.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REQUESTS, WARM_STEPS, STEPS, CALLS = 3, 3, 10, 2000
SEED = 19


def randomize_(module, generator):
    """Random non-zero values for every parameter (as chip_smoke.py's)."""
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            z = torch.randn(p.shape, generator=generator, device=p.device)
            if p.ndim >= 2:
                fan_in = (p.shape[0] if name.endswith(".kernel")
                          else p[0].numel())
                p.copy_(z / fan_in**0.5)
            elif name.endswith("scale"):
                p.copy_(1.0 + 0.1 * z)
            else:
                p.copy_(0.1 * z)
        module.core.conv_out.weight.mul_(0.1)


def measure(tree):
    """The measurements of the package in `tree` (a child process)."""
    sys.path.insert(0, str(tree))
    import torch

    from sdeflow_tpu_torch import (
        Trainer, build_msgm_arm, get_preset, make_sampler_fn)
    from sdeflow_tpu_torch.experiments.driver import make_sampler
    from sdeflow_tpu_torch.ops.kernels import common
    from sdeflow_tpu_torch.ops.kernels.circulant import circulant_apply
    from sdeflow_tpu_torch.ops.kernels.groupnorm import group_norm_silu

    dev = torch.device("cuda")
    common.build_all()
    g = torch.Generator(device=dev).manual_seed(SEED)
    rec = {"tree": str(tree)}

    cfg = get_preset("grf16_production")
    sw = cfg.sweep
    _, gen = build_msgm_arm(cfg, g, device=dev)
    randomize_(gen.score_net, g)
    sample = make_sampler_fn(
        gen, 1024, 256, sw.num_stepss_backward[0], method=sw.backward_method,
        norm_correction=True, corrector_steps=sw.corrector_steps, snr=sw.snr,
        device=dev)
    sample(g)
    ms = []
    for _ in range(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(g)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    rec["production_request_ms"] = ms

    cfg = get_preset("grf16")
    _, gen = build_msgm_arm(cfg, g, device=dev)
    randomize_(gen.score_net, g)
    sampler = make_sampler(cfg, 256, dev)
    trainer = Trainer(gen, sampler, lr=cfg.train.lr, batch_size=128,
                      loss="ssm", log_fn=lambda *a: None)

    def step():
        return trainer.train_step(trainer.state, g, sampler.sample(g, 128))

    for _ in range(WARM_STEPS):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    rec["ssm_step_ms"] = (time.perf_counter() - t0) * 1e3 / STEPS

    x = torch.randn(1, 32, 64, device=dev)
    gamma, beta = torch.ones(32, device=dev), torch.zeros(32, device=dev)
    y = torch.randn(8, 256, device=dev)
    for name, fn in (("k5_call_us", lambda: group_norm_silu(
            x, gamma, beta, 32, True)),
            ("k1_call_us", lambda: circulant_apply(0.5, y, y))):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        rec[name] = (time.perf_counter() - t0) * 1e6 / CALLS
    return rec


def share_builds(parent):
    """Copy this tree's built libraries into the parent's build directory
    (a library's name hashes its sources, so a name that matches is the
    same build)."""
    sys.path.insert(0, str(ROOT))
    from sdeflow_tpu_torch.ops.kernels import common

    common.build_all()
    dest = Path(parent) / "sdeflow_tpu_torch" / "_build"
    dest.mkdir(parents=True, exist_ok=True)
    for lib in common.BUILD_DIR.glob("*.so"):
        shutil.copy2(lib, dest / lib.name)


def main(argv):
    if argv[:1] == ["--child"]:
        print(json.dumps(measure(Path(argv[1]))), flush=True)
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_op_host_cost: no CUDA device", file=sys.stderr)
        return 1
    parent = Path(argv[0]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    share_builds(parent)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = []
    for tree in (parent, ROOT, ROOT, parent):
        res = subprocess.run([sys.executable, __file__, "--child", str(tree)],
                             cwd=tree, env=env, capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
