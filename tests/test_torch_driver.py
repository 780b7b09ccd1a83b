"""The experiment driver and its CLI against the JAX package's, without
running the JAX driver: the grf presets and their ``_dbg`` shrink field by
field, the run names and metric file names byte for byte, each arm's SDE
as the JAX ``_build_arm`` makes it, the CLI's flags and defaults (its
unported flags in tests/test_torch_driver_unported.py), one whole sweep
of a shrunken grf configuration on the CPU (both arms trained by SSM,
sampled, scored by MMD and SWD, saved, reloaded and rescored from the
saved trajectories), the test set's stream, and a checkpoint round trip
that must continue a run bit for bit on the CPU."""

import dataclasses
import os
import re
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from sdeflow_tpu import configs as jax_configs
from sdeflow_tpu import run as jax_run
from sdeflow_tpu.data.synthetic import SmoothedGRF as JaxSmoothedGRF
from sdeflow_tpu.experiments import driver as jax_driver
from sdeflow_tpu.experiments import naming as jax_naming
from sdeflow_tpu.experiments.driver import ExperimentDriver as JaxDriver
from sdeflow_tpu_torch import configs, run
from sdeflow_tpu_torch.data.synthetic import SmoothedGRF
from sdeflow_tpu_torch.experiments import naming
from sdeflow_tpu_torch.experiments.driver import (
    METRICS, ExperimentDriver, build_msgm_arm)
from sdeflow_tpu_torch.training import Trainer, checkpoint_exists

torch.set_num_threads(1)
SMALL_NET = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
                 attention_resolutions=(2,))
PRESETS = ["grf16", "grf32", "grf16_dbg", "grf32_dbg"]


def _fields_equal(ours, ref, where):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _fields_equal(a, b, f"{where}.{f.name}")
        else:
            assert a == b and type(a) is type(b), (where, f.name, a, b)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax_field_by_field(name):
    _fields_equal(configs.get_preset(name), jax_configs.get_preset(name),
                  name)


def test_config_defaults_match_jax():
    for cls in ("TrainConfig", "SweepConfig", "DataConfig", "PlotConfig",
                "ExperimentConfig"):
        _fields_equal(getattr(configs, cls)(), getattr(jax_configs, cls)(),
                      cls)


def _name_args(cfg, is_msgm):
    tc, sw = cfg.train, cfg.sweep
    sde_name = "MSGM_sparseTenslogNorm" if is_msgm else "SGM"
    return (("grf16", sde_name, 100_000, 24_576, 32, tc.num_steps_forward,
             tc.beta_min, tc.beta_max, tc.beta_min_sgm, tc.beta_max_sgm,
             is_msgm),
            dict(nn_archi=tc.nn_archi,
                 premodule="NormalizeLogRadius" if is_msgm else None,
                 lr=tc.lr, vtype=tc.vtype, ssm_intT=False,
                 fair_comparison=sw.fair_comparison))


@pytest.mark.parametrize("is_msgm", [False, True])
def test_run_names_match_jax_byte_for_byte(is_msgm):
    cfg = configs.get_preset("grf16")
    args, kw = _name_args(cfg, is_msgm)
    root = naming.run_name_root(*args, **kw)
    assert root == jax_naming.run_name_root(*args, **kw)
    assert root.startswith("grf16/") and ("0.0001lr" in root)
    for i_run in (0, 1):
        for method in ("rk4", "em"):
            a = (cfg.results_dir, root, cfg.train.t_eps, 64, True, i_run)
            assert (naming.simulation_name(*a, method=method)
                    == jax_naming.simulation_name(*a, method=method))
    ours = ExperimentDriver(cfg, make_plots=False, device="cpu")
    ref = JaxDriver(jax_configs.get_preset("grf16"), make_plots=False)
    arm = "MSGM" if is_msgm else "SGM"
    for arm_ in (arm, "ref"):
        for metric in ("MMD", "SWD"):
            assert (ours._mmd_path("out", arm_, metric)
                    == ref._mmd_path("out", arm_, metric))


class _NoNet:
    """Stands in for the JAX driver's score net: the arm's SDE is what is
    compared, and an eager flax init of the U-Net takes tens of seconds."""

    def init(self, key, x, t):
        return {"params": {}}

    def apply(self, variables, x, t):
        return x


@pytest.mark.parametrize("is_msgm", [False, True])
def test_each_arm_is_built_as_jax_builds_it(is_msgm, monkeypatch):
    cfg = configs.get_preset("grf16")
    small = replace(cfg, train=replace(cfg.train, **SMALL_NET))
    jcfg = jax_configs.get_preset("grf16")
    monkeypatch.setattr(jax_driver, "make_model", lambda *a, **k: _NoNet())
    _, jgen = JaxDriver(jcfg, make_plots=False)._build_arm(
        jax.random.PRNGKey(0), JaxSmoothedGRF(16), 256, is_msgm,
        "NormalizeLogRadius" if is_msgm else None, 64, False)
    drv = ExperimentDriver(small, make_plots=False, device="cpu")
    model, gen = drv._build_arm(torch.Generator().manual_seed(0), 256,
                                is_msgm, 64)
    ours, ref = gen.base_sde, jgen.base_sde
    assert type(ours).__name__ == type(ref).__name__
    assert ours.norm_correction is ref.norm_correction is bool(is_msgm)
    for f in ("beta_min", "beta_max", "T", "t_epsilon"):
        assert getattr(ours, f) == pytest.approx(float(getattr(ref, f)),
                                                 rel=1e-7), f
    assert ours.num_steps_forward == ref.num_steps_forward == 64
    assert ours.name == ref.name
    assert (gen.parameterization, gen.vtype, gen.ssm_intT, gen.intT_start) \
        == (jgen.parameterization, jgen.vtype, jgen.ssm_intT,
            jgen.intT_start)
    if is_msgm:
        assert (ours.circulant, ours.norm_map, ours.norm_sampler, ours.dim) \
            == (ref.circulant, ref.norm_map, ref.norm_sampler, ref.dim)
        assert ours.r_T.shape == ref.r_T.shape == (64,)
        assert model.premodule == "NormalizeLogRadius"
    else:
        assert model.premodule is None
    # the same seed builds the same arm
    model2, _ = drv._build_arm(torch.Generator().manual_seed(0), 256,
                               is_msgm, 64)
    for p, q in zip(model.parameters(), model2.parameters()):
        assert torch.equal(p, q)


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs,
                     a.type, a.const)
            for a in parser._actions if a.dest != "help"}


def test_cli_flags_and_defaults_match_jax():
    assert _actions(run.build_parser()) == _actions(jax_run.build_parser())


def test_cli_refuses_the_cpu_without_the_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "res"
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--preset", "grf16_dbg", "--no-plots", "--results-dir",
                  str(out)])
    assert not out.exists()


def test_test_set_is_its_own_stream():
    data = SmoothedGRF(16, 2.0, device="cpu")
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    test = data.sampletest(g, 8)
    assert torch.equal(g.get_state(), state)  # not advanced
    assert torch.equal(data.sampletest(g, 8), test)
    train = data.sample(g, 8)
    assert not torch.allclose(train, test)
    assert torch.equal(data.get_std(), torch.ones(256))


def _tiny_cfg(results_dir, **train):
    """grf on 4×4 images, the small U-Net, 8 forward steps, 2 iterations
    per arm at batch 3, two step counts, two runs of 16 samples each."""
    cfg = configs._grf(4)
    return replace(
        cfg, results_dir=str(results_dir),
        train=replace(cfg.train, num_steps_forward=8, print_every=10_000,
                      **SMALL_NET, **train),
        sweep=replace(cfg.sweep, iterationss=(2,), batch_sizes=(3,),
                      num_stepss_backward=(2, 3), nruns_mmd=2,
                      num_samples=16, eval_mmd=True))


def test_driver_sweep_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _tiny_cfg(tmp_path / "res")
    logs = []
    res = ExperimentDriver(cfg, log_fn=logs.append, make_plots=False,
                           device="cpu").run()
    assert list(res) == [*METRICS, "dims", "complexitys", "nll_bits_per_dim"]
    assert res["dims"] == [16] and res["complexitys"] == [np.inf]
    for k in METRICS:
        assert res[k].shape == (1, 1, 2, 1, 2) and np.isfinite(res[k]).all()
        assert (res[k] > 0).all(), k
    # both arms (and every run) are scored against the same train set
    ref = [float(m.split("= ")[1]) for m in logs
           if m.startswith("MMD train to test")]
    assert len(ref) == 8 and len(set(ref)) == 1
    np.testing.assert_allclose(np.sqrt(res["mmd_ref"]), ref[0], rtol=1e-12)

    # the files, under the JAX package's names
    tc = cfg.train
    for arm, is_msgm in (("SGM", False), ("MSGM", True)):
        sde = "MSGM_sparseTenslogNorm" if is_msgm else "SGM"
        root = jax_naming.run_name_root(
            "grf4", sde, 2, 6, 3, 8, tc.beta_min, tc.beta_max,
            tc.beta_min_sgm, tc.beta_max_sgm, is_msgm, nn_archi="Unet",
            premodule="NormalizeLogRadius" if is_msgm else None, lr=tc.lr,
            fair_comparison=False)
        assert os.path.isfile(os.path.join(cfg.results_dir,
                                           root + "_checkpoint_final"))
        for steps in (2, 3):
            for i_run in (0, 1):
                name = jax_naming.simulation_name(
                    cfg.results_dir, root, tc.t_eps, steps, True, i_run)
                assert os.path.isfile(name + ".npy")
                traj = np.load(name + "_traj.npy")
                assert traj.shape == (steps + 1, 16, 16)
                np.testing.assert_array_equal(np.load(name + ".npy"),
                                              traj[-1])
                norms = np.linalg.norm(traj, axis=2)
                kept = np.allclose(norms, norms[0], rtol=1e-5, atol=0)
                assert kept is is_msgm, (arm, steps, i_run)
        for metric in ("MMD", "SWD"):
            assert os.path.isfile(os.path.join(
                cfg.results_dir, f"global{metric}file_{arm}_2runs.npy"))
    assert os.path.isdir(tmp_path / "runs" / "grf4")

    # --just-load-mmd reloads the arrays; just_load rescores the saved
    # trajectories to the same numbers
    loaded = ExperimentDriver(cfg, make_plots=False,
                              device="cpu").load_mmd_and_plot()
    again = ExperimentDriver(cfg, log_fn=lambda *_: None, make_plots=False,
                             device="cpu").run(just_load=True)
    for k in METRICS:
        np.testing.assert_array_equal(loaded[k], res[k])
        np.testing.assert_array_equal(again[k], res[k])


def test_cli_runs_the_driver_and_prints_the_three_lines(tmp_path, capsys,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _tiny_cfg(tmp_path / "res")
    monkeypatch.setitem(configs.PRESETS, "grf4_tiny", lambda: cfg)
    res = run.main(["--preset", "grf4_tiny", "--cpu", "--no-plots",
                    "--eval-mmd", "--results-dir", cfg.results_dir,
                    "--seed", "3"])
    out = capsys.readouterr().out
    for arm, key in (("SGM", "mmd_sgm"), ("MSGM", "mmd_msgm"),
                     ("floor", "mmd_ref")):
        line = re.search(rf"^sqrt-MMD {arm}: (\S+)$", out, re.M)
        assert line, out[-2000:]
        np.testing.assert_allclose(float(line.group(1)),
                                   np.sqrt(res[key]).mean(), rtol=1e-12)
    back = run.main(["--preset", "grf4_tiny", "--cpu", "--no-plots",
                     "--just-load-mmd", "--results-dir", cfg.results_dir])
    for k in METRICS:
        np.testing.assert_array_equal(back[k], res[k])


def _msgm_trainer(seed, path=None):
    """A small MSGM arm (its radial prior from data drawn with `seed`) and
    its Trainer, with EMA and LR warmup, checkpointing to `path`."""
    cfg = configs.get_preset("grf16")
    cfg = replace(cfg, train=replace(cfg.train, num_steps_forward=4,
                                     **SMALL_NET))
    torch.manual_seed(seed)
    _, gen = build_msgm_arm(cfg, torch.Generator().manual_seed(seed),
                            num_samples_init=8 + seed, device="cpu")
    data = SmoothedGRF(16, 2.0, device="cpu")
    return Trainer(gen, data, lr=1e-3, batch_size=2, print_every=2,
                   save_every=2, checkpoint_path=path, ema_rate=0.9,
                   lr_warmup_steps=3, log_fn=lambda *_: None)


def test_checkpoint_resume_continues_the_run_exactly(tmp_path):
    path = str(tmp_path / "ckpt")
    x_test = SmoothedGRF(16, 2.0, device="cpu").sample(
        torch.Generator().manual_seed(9), 2)
    first = _msgm_trainer(0, path)
    first.run(torch.Generator().manual_seed(1), 3, x_test=x_test)
    assert checkpoint_exists(path) and checkpoint_exists(path + "_2")
    # another arm (other weights, another radial prior) resumes the run
    resumed = _msgm_trainer(1, path)
    g = torch.Generator().manual_seed(2)
    state, _ = resumed.run(g, 5, x_test=x_test)
    assert state.step == 5 and checkpoint_exists(path + "_4")
    whole = _msgm_trainer(0)
    g_whole = torch.Generator().manual_seed(1)
    ref, _ = whole.run(g_whole, 5, x_test=x_test)
    for (n, p), (_, q) in zip(state.gen_sde.score_net.named_parameters(),
                              ref.gen_sde.score_net.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(state.ema_params[n], ref.ema_params[n]), n
    assert torch.equal(state.gen_sde.base_sde.r_T, ref.gen_sde.base_sde.r_T)
    assert torch.equal(g.get_state(), g_whole.get_state())
    sd, sd_ref = (t.optimizer.state_dict() for t in (resumed, whole))
    assert sd["count"] == sd_ref["count"] == 5
    for k, v in sd["state"].items():
        for name, t in v.items():
            assert torch.equal(t, sd_ref["state"][k][name]), (k, name)
