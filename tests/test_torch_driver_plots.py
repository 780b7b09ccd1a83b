"""The driver and its CLI with the figures on (the default): ``run.main``
on grf16_dbg on the CPU writes every file the JAX driver writes for that
preset, under names built by the JAX package's experiments/naming.py and
its plotting rules, including the convergence plots, which
``--just-load-mmd`` draws again; ``--print-ram`` logs a ``RAM:`` line at
each training print (the Trainer's ``print_ram``); without matplotlib the
CLI and ``ExperimentDriver(make_plots=True)`` raise ImportError, naming
--no-plots, before the results directory exists."""

import os
import re
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from sdeflow_tpu.experiments import naming as jax_naming
from sdeflow_tpu_torch import configs, run
from sdeflow_tpu_torch.data.synthetic import SmoothedGRF
from sdeflow_tpu_torch.experiments.driver import build_msgm_arm, make_trainer

ROOT = Path(__file__).resolve().parents[1]
ITERATIONS, SAMPLES, STEPS = 2, 6, 2


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _jax_driver_files(cfg):
    """Every file the JAX driver writes for cfg with plots on and
    eval_mmd, one iteration count, one batch size and one step count:
    sdeflow_tpu/experiments/driver.py:384-422, 466-481, 592-615, 702-767
    and sdeflow_tpu/plotting/plots.py."""
    tc, sw = cfg.train, cfg.sweep
    (n_iter,), (batch,), (steps,) = (sw.iterationss, sw.batch_sizes,
                                     sw.num_stepss_backward)
    n = min(10, sw.num_samples)  # the duplicated step's samples
    files = {"grf16.png"}  # the test set's pair grid, per arm
    for is_msgm in (False, True):
        sde = "MSGM_sparseTenslogNorm" if is_msgm else "SGM"
        root = jax_naming.run_name_root(
            "grf16", sde, n_iter, min(tc.num_samples_init_max,
                                      n_iter * batch),
            batch, tc.num_steps_forward, tc.beta_min, tc.beta_max,
            tc.beta_min_sgm, tc.beta_max_sgm, is_msgm, nn_archi=tc.nn_archi,
            premodule="NormalizeLogRadius" if is_msgm else None, lr=tc.lr,
            fair_comparison=sw.fair_comparison)
        fwd = range(0, tc.num_steps_forward + 1,
                    max(1, tc.num_steps_forward // 8))
        files |= {root + "_cov.png", root + "_Forward.png",
                  root + "_checkpoint_final"}
        files |= {f"{root}_Forward_imageAtt{i}_sample{k}_.png" for i in fwd
                  for k in range(n if i == 0 else 1)}
        name = jax_naming.simulation_name(".", root, tc.t_eps, steps, True)
        name = os.path.relpath(name, ".")
        files |= {name + s for s in (".npy", "_traj.npy", ".png",
                                     "_multDim.png", "_survival.png")}
        files |= {f"{name}_Gen_imageAtt{i}_sample{k}_.png"
                  for i in range(0, steps + 1, max(1, steps // 8))
                  for k in range(n if i == steps else 1)}
    files |= {f"global{m}file_{a}_1runs.npy" for m in ("MMD", "SWD")
              for a in ("SGM", "MSGM", "ref")}
    cx = list(sw.ntrain_maxs)
    files |= {f"MMD_wBckWardSteps_d=256_Ntrain={c}.png" for c in cx}
    if len(cx) > 1:
        files.add("MMD_wNtrain.png")
    return sorted(files)


def test_cli_grf16_dbg_writes_the_jax_figures(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res = tmp_path / "res"
    args = ["--preset", "grf16_dbg", "--cpu", "--results-dir", str(res),
            "--iterations", str(ITERATIONS), "--num-samples", str(SAMPLES),
            "--steps-backward", str(STEPS)]
    run.main([*args, "--eval-mmd", "--print-ram"])
    out = capsys.readouterr().out
    cfg = configs.get_preset("grf16_dbg")
    cfg = replace(cfg, sweep=replace(
        cfg.sweep, iterationss=(ITERATIONS,), num_samples=SAMPLES,
        num_stepss_backward=(STEPS,)))
    assert _files(res) == _jax_driver_files(cfg)
    assert all((res / f).stat().st_size > 0 for f in _files(res))
    # a RAM line after each of the two prints of each of the four arm runs
    ram = re.findall(r"^RAM: .*$", out, re.M)
    assert len(ram) == 4 * 2
    assert all(re.fullmatch(r"RAM: host rss [\d,]+ MiB", r) for r in ram)

    for f in res.glob("MMD_w*.png"):
        f.unlink()
    back = run.main([*args, "--just-load-mmd"])
    assert np.isfinite(back["mmd_msgm"]).all()
    assert sorted(p.name for p in res.glob("MMD_w*.png")) == [
        "MMD_wBckWardSteps_d=256_Ntrain=16.png",
        "MMD_wBckWardSteps_d=256_Ntrain=4.png", "MMD_wNtrain.png"]


def test_trainer_prints_ram_at_each_print():
    cfg = configs.get_preset("grf16")
    cfg = replace(cfg, train=replace(
        cfg.train, num_steps_forward=4, print_every=2, print_ram=True,
        base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
        attention_resolutions=(2,)))
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(0)
    _, gen = build_msgm_arm(cfg, g, num_samples_init=8, device="cpu")
    logs = []
    trainer = make_trainer(cfg, gen, SmoothedGRF(16, 2.0, device="cpu"), 2,
                           log_fn=logs.append)
    trainer.run(g, 4)
    # prints at steps 1, 2 and 4, each followed by its RAM line
    assert [m.split()[0] for m in logs] == ["|", "RAM:"] * 3


_NO_MATPLOTLIB = r"""
import sys
sys.modules["matplotlib"] = None  # import matplotlib raises ImportError
from sdeflow_tpu_torch import configs, run
from sdeflow_tpu_torch.experiments.driver import ExperimentDriver
res = sys.argv[1]
for fn in (lambda: run.main(["--preset", "grf16_dbg", "--cpu",
                             "--results-dir", res]),
           lambda: ExperimentDriver(configs.get_preset("grf16_dbg"),
                                    device="cpu")):
    try:
        fn()
    except ImportError as e:
        assert "--no-plots" in str(e), e
    else:
        raise AssertionError("ran without matplotlib")
import os
assert not os.path.exists(res)
print("refused")
"""


def test_plots_without_matplotlib_raise_before_anything_runs(tmp_path):
    res = tmp_path / "res"
    out = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB, str(res)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("refused")
    assert not res.exists()
