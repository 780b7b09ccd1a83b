"""The CLI with the PF-ODE and DPM-Solver samplers and the exact NLL
(``--sampler ode|dpm``, ``--backward-method dopri``, ``--dpm-grid``,
``--eval-nll``): ``run.main`` on ``grf16_dbg --cpu --no-plots``, the preset
with the small U-Net of tests/test_torch_driver.py and 2 NLL steps (the
grf16 U-Net takes minutes on the CPU), 2 iterations, 6 samples and 3
backward steps; each of grf16_dbg's two train-set sizes trains and samples
both arms (the second under the first's names: grf names carry no
train-set size, as in the JAX package). Samples are finite (MSGM's norms
kept), the names carry the method that runs, an MSGM arm under dpm falls
back to the SDE with RK4 and logs it, and ``nll_bits_per_dim.json`` holds
one entry per arm."""

import json
import os
import re
from dataclasses import replace

import numpy as np
import pytest
import torch

from sdeflow_tpu_torch import configs, run

torch.set_num_threads(1)
SMALL_NET = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
                 attention_resolutions=(2,))
BASE = ["--preset", "grf16_dbg", "--cpu", "--no-plots", "--iterations", "2",
        "--num-samples", "6", "--steps-backward", "3"]
RUNS = 4  # two train-set sizes × {SGM, MSGM}
ARMS = 2  # names: SGM, MSGM


@pytest.fixture
def cli(tmp_path, monkeypatch, capsys):
    """run.main on the small grf16_dbg in tmp_path: returns (results, the
    printed output, the results directory's files)."""
    cfg = configs._grf(16)
    cfg = replace(cfg, train=replace(cfg.train, **SMALL_NET),
                  sweep=replace(cfg.sweep, nll_steps=2))
    monkeypatch.setitem(configs.PRESETS, "grf16", lambda: cfg)
    monkeypatch.chdir(tmp_path)
    res_dir = str(tmp_path / "res")

    def call(*flags):
        res = run.main([*BASE, "--results-dir", res_dir, *flags])
        files = sorted(os.path.relpath(os.path.join(d, f), res_dir)
                       for d, _, fs in os.walk(res_dir) for f in fs)
        return res, capsys.readouterr().out, res_dir, files

    return call


def _trajectories(res_dir, files):
    """{file: (S, N, d) trajectory} of every sampling run."""
    return {f: np.load(os.path.join(res_dir, f)) for f in files
            if f.endswith("_traj.npy")}


def _check(trajs, method_tags):
    assert len(trajs) == ARMS
    for name, xs in trajs.items():
        assert xs.shape == (4, 6, 256) and np.isfinite(xs).all(), name
        is_msgm = name.startswith("grf16/MSGM")
        norms = np.linalg.norm(xs, axis=2)
        kept = np.allclose(norms, norms[0], rtol=1e-5, atol=0)
        assert kept is is_msgm, name
        tag = method_tags["MSGM" if is_msgm else "SGM"]
        assert name.endswith(f"3stepsBack_Truet0infer{tag}_traj.npy"), name


def test_ode_sampler(cli):
    _, out, res_dir, files = cli("--sampler", "ode")
    _check(_trajectories(res_dir, files), {"SGM": "", "MSGM": ""})
    assert "falls back" not in out


def test_ode_sampler_dopri(cli):
    _, out, res_dir, files = cli("--sampler", "ode", "--backward-method",
                                 "dopri")
    _check(_trajectories(res_dir, files), {"SGM": "_dopri",
                                           "MSGM": "_dopri"})


@pytest.mark.parametrize("grid", [None, "time", "karras"])
def test_dpm_sampler_and_the_msgm_fallback(cli, grid):
    flags = ["--sampler", "dpm"] + ([] if grid is None else
                                    ["--dpm-grid", grid])
    _, out, res_dir, files = cli(*flags)
    # SGM runs dpm2m (the name of a non-dpm method becomes dpm2m); MSGM
    # has no closed-form kernel and falls back to the SDE with RK4
    _check(_trajectories(res_dir, files), {"SGM": "_dpm2m", "MSGM": ""})
    falls = re.findall(r"^sampler 'dpm' needs a closed-form forward kernel; "
                       r"(\S+) arm falls back to sampler 'sde' / method "
                       r"'rk4'$", out, re.M)
    assert falls == ["MSGM_sparseTenslogNorm"] * 2, out[-3000:]


def test_dpm_stochastic_method(cli):
    _, _, res_dir, files = cli("--sampler", "dpm", "--backward-method",
                               "sdpm2m")
    _check(_trajectories(res_dir, files), {"SGM": "_sdpm2m", "MSGM": ""})


def test_eval_nll_writes_one_entry_per_arm(cli):
    res, out, res_dir, files = cli("--eval-nll")
    assert "nll_bits_per_dim.json" in files
    with open(os.path.join(res_dir, "nll_bits_per_dim.json")) as f:
        saved = json.load(f)
    assert saved == res["nll_bits_per_dim"] and len(saved) == ARMS
    for name, entry in saved.items():
        assert entry["n"] == 6 and entry["steps"] == 2, name
        assert np.isfinite(entry["mean"]) and entry["stderr"] >= 0, name
        line = re.search(rf"^NLL bits/dim \[{re.escape(name)}\]: (\S+) ± ",
                         out, re.M)
        assert line and float(line.group(1)) == pytest.approx(
            entry["mean"], abs=5e-5), name
    assert sum(k.startswith("grf16/MSGM") for k in saved) == 1
    assert len(re.findall(r"^NLL = \S+ ± \S+ bits/dim", out, re.M)) == RUNS
    # --just-load restores samples, not a model: the NLL is skipped
    _, out, _, _ = cli("--eval-nll", "--just-load")
    assert out.count("eval_nll skipped: --just-load") == RUNS


def test_method_flags_need_their_sampler(cli):
    with pytest.raises(SystemExit):
        cli("--backward-method", "dpm2m")
    with pytest.raises(SystemExit):
        cli("--backward-method", "dopri")
    with pytest.raises(SystemExit):
        cli("--dpm-grid", "karras")
