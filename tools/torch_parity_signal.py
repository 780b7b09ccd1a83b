"""Signal-regime quality of the PyTorch port: UNet1D arms on the Lorenz-63
delay-window fixture at d = 1000, by the protocol of
tools/parity_signal_ours.py (the JAX package's PARITY.md signal study).

The fixture comes from tools/l63_fixture.py (6,000 windows of 1,000 steps
by default), loaded through sdeflow_tpu_torch.data.Lorenz63 with
normalized=True for both arms; UNet1D base 32, mults (1, 2, 4), emb 128
(NormalizeLogRadius on the MSGM arm); β 0.1→20, t_eps 1e-3, 16 forward
steps, the circulant G with the log-map ecdf prior; Adam lr 1e-4 at batch
32 for 768 iterations; then RK4-64 reverse-SDE sampling of 1,024 samples
(norm-corrected on MSGM) from the arm's latents, scored by √MMD against
1,024 test draws beside the train-to-test floor. One JSON line per arm and
seed; the list is written to --out. Runs on the card (the default) or on
the CPU with --cpu (small --iters there):

    python tools/torch_parity_signal.py --seeds 0,1,2 --out parity_signal_torch.json
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.l63_fixture import ensure_fixture  # noqa: E402


def card_name():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return None


def run_arm(is_msgm, seed, args, dev):
    import torch

    from sdeflow_tpu_torch.data import Lorenz63
    from sdeflow_tpu_torch.eval import compute_mmd, filter_blowups
    from sdeflow_tpu_torch.models import UNet1D
    from sdeflow_tpu_torch.ops.integrators import integrate_sde
    from sdeflow_tpu_torch.ops.rng import fold_in
    from sdeflow_tpu_torch.sde import MSGMSde, PluginReverseSDE, SGMSde
    from sdeflow_tpu_torch.training import Trainer

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    g = torch.Generator(device=dev).manual_seed(seed)
    sampler = Lorenz63(dim=1000, normalized=True, device=dev)
    d = sampler.dim
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = UNet1D(input_dim=d, base_channels=32, channel_mults=(1, 2, 4),
                       premodule="NormalizeLogRadius" if is_msgm else None,
                       emb_dim=128).to(dev)
    kw = dict(beta_min=0.1, beta_max=20.0, t_epsilon=1e-3,
              num_steps_forward=16)
    if is_msgm:
        x_init = sampler.sample(fold_in(g, 1),
                                min(100_000, args.iters * args.batch))
        sde = MSGMSde.create(x_init, generator=fold_in(g, 2),
                             dense_tensor=False, norm_sampler="ecdf",
                             norm_map="log", estimate_norm_constant=False,
                             **kw)
    else:
        sde = SGMSde.create(device=dev, **kw)
    gen = PluginReverseSDE.create(sde, model)
    trainer = Trainer(gen, sampler, lr=1e-4, batch_size=args.batch,
                      print_every=max(1, args.iters // 8))
    sync()
    t0 = time.perf_counter()
    state, final_loss = trainer.run(fold_in(g, 3), args.iters)
    sync()
    train_s = time.perf_counter() - t0

    x0 = state.gen_sde.latent_sample(fold_in(g, 4), args.samples, d)
    xtest = sampler.sampletest(fold_in(g, 5), args.samples)
    xtrain = sampler.sample(fold_in(g, 6), args.samples)
    with torch.no_grad():
        for rep in range(2):  # the first call warms up, the second is timed
            sync()
            t0 = time.perf_counter()
            xgen = integrate_sde(state.gen_sde, x0, fold_in(g, 7),
                                 args.steps_back, method="rk4",
                                 norm_correction=is_msgm)
            sync()
            sample_s = time.perf_counter() - t0
    xgen_f, dropped = filter_blowups(xgen)
    n = min(xgen_f.shape[0], args.samples)
    mmd = float(compute_mmd(torch.as_tensor(xgen_f[:n], device=dev),
                            xtest[:n]))
    floor = float(compute_mmd(xtrain[:n], xtest[:n]))
    return dict(
        arm="MSGM" if is_msgm else "SGM", seed=seed, config="l63_1000_unet1d",
        iters=args.iters, batch=args.batch, sampler="sde",
        steps_back=args.steps_back, windows=args.windows, device=str(dev),
        card=card_name() if dev.type == "cuda" else None,
        train_s=train_s, ms_per_step=train_s / args.iters * 1e3,
        sample_s=sample_s, samples_per_s=args.samples / sample_s,
        sqrt_mmd=max(mmd, 0.0) ** 0.5, sqrt_mmd_floor=max(floor, 0.0) ** 0.5,
        dropped=dropped, final_loss=float(final_loss))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=768)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--steps-back", type=int, default=64)
    ap.add_argument("--windows", type=int, default=6000)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--arms", default="sgm,msgm")
    ap.add_argument("--data-root", default=None,
                    help="where the fixture is written (default: a "
                         "temporary directory)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="parity_signal_torch.json")
    args = ap.parse_args(argv)

    import tempfile

    import torch

    from sdeflow_tpu_torch.data import set_data_root
    from sdeflow_tpu_torch.ops.kernels.common import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    arms = [a.strip().lower() for a in args.arms.split(",")]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        root = args.data_root or tmp
        t0 = time.perf_counter()
        ensure_fixture(root, n_windows=args.windows)
        print(f"fixture: {time.perf_counter() - t0:.1f} s", flush=True)
        set_data_root(root)
        for seed in (int(s) for s in args.seeds.split(",")):
            for is_msgm in (False, True):
                if ("msgm" if is_msgm else "sgm") not in arms:
                    continue
                res = run_arm(is_msgm, seed, args, dev)
                print(json.dumps(res), flush=True)
                results.append(res)
                os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                            exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=2)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
