"""Command-line entry point of the port, with the JAX package's flags:

    python -m sdeflow_tpu_torch.run --no-plots --eval-mmd   # swissroll
    python -m sdeflow_tpu_torch.run --preset swissroll_dbg --cpu --no-plots
    python -m sdeflow_tpu_torch.run --preset grf16_dit_dbg --cpu --no-plots
    python -m sdeflow_tpu_torch.run --preset grf16 --eval-mmd --no-plots
    python -m sdeflow_tpu_torch.run --preset grf16_dbg --cpu --no-plots --eval-mmd
    python -m sdeflow_tpu_torch.run --preset grf16_production --no-plots
    python -m sdeflow_tpu_torch.run --preset grf16 --sampler ode --eval-nll --no-plots
    python -m sdeflow_tpu_torch.run --preset lorenz63_unet1d --data-root ROOT --eval-mmd --no-plots

Port of sdeflow_tpu/run.py:15-252. It runs on CUDA unless given --cpu,
and raises when no CUDA device is present instead of falling back to the
CPU. ``--data-root`` points the file-backed presets at a directory in the
layout of ``../MSGM-data/`` (the default); no data is fetched, and
tools/l63_fixture.py writes the Lorenz-63 one. The flags that need parts
not ported yet raise NotImplementedError, naming their ROADMAP Queue 1
item, before anything is built or trained.
"""

from __future__ import annotations

import argparse
from dataclasses import replace


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="swissroll",
                   help="experiment preset (append _dbg for the smoke config)")
    p.add_argument("--iterations", type=int, default=None,
                   help="override the iteration sweep with a single value")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--steps-backward", type=int, default=None)
    p.add_argument("--backward-method",
                   choices=["rk4", "heun", "em", "dopri", "dpm1", "dpm2",
                            "dpm2m", "dpm3m", "sdpm1", "sdpm2m"],
                   default=None,
                   help="generation integrator (default rk4; dpm* names "
                        "apply with --sampler dpm; dopri — adaptive "
                        "Dormand-Prince — with --sampler ode)")
    p.add_argument("--sampler", choices=["sde", "ode", "dpm"], default=None,
                   help="generation path: stochastic reverse SDE (default), "
                        "deterministic probability-flow ODE, or DPM-Solver "
                        "exponential integrator (SGM only)")
    p.add_argument("--corrector-steps", type=int, default=None,
                   help="Langevin corrector MCMC steps after each predictor "
                        "step (predictor-corrector sampling; default 0)")
    p.add_argument("--snr", type=float, default=None,
                   help="corrector signal-to-noise step-size knob "
                        "(default 0.16)")
    p.add_argument("--dpm-grid", choices=["logsnr", "time", "karras"],
                   default=None,
                   help="dpm sampler time grid (default logsnr; karras = "
                        "EDM rho=7 noise schedule)")
    p.add_argument("--eval-mmd", action="store_true",
                   help="compute the MMD result tensors")
    p.add_argument("--eval-nll", action="store_true",
                   help="report each trained arm's exact NLL (bits/dim) via "
                        "the PF-ODE likelihood (normalized prior; the "
                        "reference only has the ELBO bound)")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--just-load", action="store_true",
                   help="reload saved sample trajectories instead of sampling")
    p.add_argument("--just-load-mmd", action="store_true",
                   help="reload saved MMD result tensors and regenerate the "
                        "convergence plots (the reference's justLoadmmmd)")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain PyTorch "
                        "versions; the reference's force_cpu)")
    p.add_argument("--data-root", default=None,
                   help="root for file-backed datasets (../MSGM-data/)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree: shard training batches "
                        "over a 'data' mesh axis of this size and all-reduce "
                        "the gradients (not ported yet)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: shard score-net params over "
                        "a 'model' mesh axis of this size (not ported yet)")
    p.add_argument("--attention-impl", choices=["auto", "unfused", "ring"],
                   default=None,
                   help="U-Net attention backend: 'auto' runs each "
                        "heads==1 block as one fused kernel (K3) where it "
                        "fits, 'unfused' the module composition (GroupNorm "
                        "K5 and the attention core K6); 'ring' is not "
                        "ported yet")
    p.add_argument("--ema-rate", type=float, default=None,
                   help="exponential-moving-average rate for the score-net "
                        "params (e.g. 0.999); sampling/eval then use the "
                        "averaged weights (TrainConfig.ema_rate)")
    p.add_argument("--no-ema-warmup", action="store_true",
                   help="disable the min(rate, (1+n)/(10+n)) EMA decay "
                        "warmup (fixed-rate EMA is init-dominated on short "
                        "budgets: 0.999^768 ≈ 0.46 of the weight stays on "
                        "the random init)")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="clip gradients to this global norm before the "
                        "optimizer update (TrainConfig.grad_clip; the "
                        "reference trains unclipped)")
    p.add_argument("--weight-decay", type=float, default=None,
                   help="AdamW decoupled weight decay "
                        "(TrainConfig.weight_decay; default 0 = the "
                        "reference's bare Adam)")
    p.add_argument("--lr-warmup", type=int, default=None,
                   help="linear LR warmup over this many steps "
                        "(TrainConfig.lr_warmup_steps; default 0)")
    p.add_argument("--parameterization", choices=["direct", "eps"],
                   default=None,
                   help="learned-drift output form (TrainConfig"
                        ".parameterization): 'eps' rescales the net output "
                        "by -g/std so the net learns O(1) noise (SGM arms "
                        "only; better-conditioned targets, required for "
                        "bf16 SGM training)")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="score-net compute dtype (TrainConfig.compute_dtype; "
                        "parameters, Adam state and loss stay float32)")
    p.add_argument("--print-ram", action="store_true",
                   help="log host RSS + device HBM at each print cadence "
                        "(working version of the reference's dormant "
                        "print_RAM flag, MSGM_higherDim.py:397)")
    p.add_argument("--delay", type=float, default=0.0,
                   help="sleep this many seconds before starting, to stagger "
                        "concurrent runs (the reference's `delayed` flag, "
                        "MSGM_higherDim.py:171-172, 773-776)")
    return p


def _unported(args):
    """The first flag that needs an unported part, as (flag, Queue 1
    item), or None."""
    checks = [
        (args.dp > 1 or args.tp > 1, "--dp/--tp > 1", "14 (parallel)"),
        (args.attention_impl == "ring", "--attention-impl ring",
         "14 (parallel)"),
        (args.print_ram, "--print-ram", "15 (utils)"),
        (not args.no_plots, "plots (pass --no-plots)", "13b (plotting)"),
    ]
    return next(((flag, item) for hit, flag, item in checks if hit), None)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.delay > 0:
        import time

        print(f"delayed {args.delay}s ...")
        time.sleep(args.delay)

    unported = _unported(args)
    if unported is not None:
        raise NotImplementedError(
            f"{unported[0]}: ROADMAP Queue 1 item {unported[1]}")

    from sdeflow_tpu_torch.configs import get_preset
    from sdeflow_tpu_torch.experiments.driver import ExperimentDriver
    from sdeflow_tpu_torch.ops.kernels.common import resolve_device

    if args.data_root:
        from sdeflow_tpu_torch.data import set_data_root

        set_data_root(args.data_root)
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = get_preset(args.preset)
    sweep = cfg.sweep
    if args.iterations is not None:
        sweep = replace(sweep, iterationss=(args.iterations,))
    if args.batch_size is not None:
        sweep = replace(sweep, batch_sizes=(args.batch_size,))
    if args.num_samples is not None:
        sweep = replace(sweep, num_samples=args.num_samples)
    if args.steps_backward is not None:
        sweep = replace(sweep, num_stepss_backward=(args.steps_backward,))
    if args.backward_method is not None:
        sweep = replace(sweep, backward_method=args.backward_method)
    if args.sampler is not None:
        sweep = replace(sweep, sampler=args.sampler)
    if sweep.backward_method.startswith(("dpm", "sdpm")) and \
            sweep.sampler != "dpm":
        parser.error(f"--backward-method {sweep.backward_method} requires "
                     "--sampler dpm")
    if sweep.backward_method == "dopri" and sweep.sampler != "ode":
        parser.error("--backward-method dopri requires --sampler ode")
    if args.dpm_grid is not None:
        if sweep.sampler != "dpm":
            parser.error("--dpm-grid only applies with --sampler dpm")
        sweep = replace(sweep, dpm_grid=args.dpm_grid)
    if args.corrector_steps is not None:
        sweep = replace(sweep, corrector_steps=args.corrector_steps)
    if args.snr is not None:
        sweep = replace(sweep, snr=args.snr)
    if args.eval_mmd:
        sweep = replace(sweep, eval_mmd=True)
    if args.eval_nll:
        sweep = replace(sweep, eval_nll=True)
    train = cfg.train
    for flag, field in (("grad_clip", "grad_clip"),
                        ("weight_decay", "weight_decay"),
                        ("lr_warmup", "lr_warmup_steps"),
                        ("parameterization", "parameterization"),
                        ("compute_dtype", "compute_dtype"),
                        ("ema_rate", "ema_rate"),
                        ("attention_impl", "attention_impl")):
        if getattr(args, flag) is not None:
            train = replace(train, **{field: getattr(args, flag)})
    if args.no_ema_warmup:
        train = replace(train, ema_warmup=False)
    cfg = replace(cfg, train=train, sweep=sweep,
                  results_dir=args.results_dir, seed=args.seed)

    print(f"preset = {cfg.name}; device = {device}")
    driver = ExperimentDriver(cfg, make_plots=not args.no_plots,
                              device=device)
    if args.just_load_mmd:
        results = driver.load_mmd_and_plot()
    else:
        results = driver.run(just_load=args.just_load)
    if args.eval_mmd:
        import numpy as np

        print("sqrt-MMD SGM:",
              np.sqrt(np.maximum(results["mmd_sgm"], 0)).mean())
        print("sqrt-MMD MSGM:",
              np.sqrt(np.maximum(results["mmd_msgm"], 0)).mean())
        print("sqrt-MMD floor:",
              np.sqrt(np.maximum(results["mmd_ref"], 0)).mean())
    if args.eval_nll and results.get("nll_bits_per_dim"):
        for arm, v in results["nll_bits_per_dim"].items():
            if v["mean"] is None:
                print(f"NLL bits/dim [{arm}]: no finite value")
            else:
                print(f"NLL bits/dim [{arm}]: {v['mean']:.4f} ± "
                      f"{v['stderr']:.4f}")
    return results


if __name__ == "__main__":
    main()
