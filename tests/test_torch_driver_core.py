"""The core MLP path and the DiT presets through the driver and its CLI:
the toy and DiT presets field by field against the JAX package's (with
their ``_dbg`` shrink), ``make_model``'s branches, the toy MSGM arm with
its dense G built as the JAX ``_build_arm`` builds it and from the same
random stream by every entry point, the MSGM
GaussianCauchy training run of the JAX package's end-to-end test at a CPU
budget (dense G, norm-corrected RK4 keeping every norm), and the CLI on
swissroll_dbg (its default preset, the results under the JAX package's
file names) and on grf16_dit_dbg at full width."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from sdeflow_tpu import configs as jax_configs
from sdeflow_tpu.data import synthetic as jax_synth
from sdeflow_tpu.experiments import driver as jax_driver
from sdeflow_tpu.experiments import naming as jax_naming
from sdeflow_tpu.experiments.driver import ExperimentDriver as JaxDriver
from sdeflow_tpu_torch import configs, run
from sdeflow_tpu_torch.data import GaussianCauchy
from sdeflow_tpu_torch.experiments.driver import (
    ExperimentDriver, arm_config, build_msgm_arm, make_model, make_sampler)
from sdeflow_tpu_torch.models import MLP, DiT1D, DiT2D, UNet1D
from sdeflow_tpu_torch.ops.integrators import integrate_sde
from sdeflow_tpu_torch.ops.rng import fold_in
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.training import Trainer

torch.set_num_threads(1)
NEW_PRESETS = ["swissroll", "gaussian", "gaussianCauchy", "cauchy",
               "grf16_dit", "grf16_production_dit"]


def _fields_equal(ours, ref, where):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _fields_equal(a, b, f"{where}.{f.name}")
        else:
            assert a == b and type(a) is type(b), (where, f.name, a, b)


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_new_presets_match_jax_field_by_field(name):
    for n in (name, name + "_dbg"):
        _fields_equal(configs.get_preset(n), jax_configs.get_preset(n), n)


def test_make_model_builds_each_archi():
    cfg = configs.get_preset("gaussian")

    def archi(name, **kw):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, nn_archi=name, **kw))

    m = make_model(cfg, 4, "NormalizeLogRadius", device="cpu")
    assert isinstance(m, MLP) and m.dense0.in_features == 6
    m = make_model(archi("DiT", dit_width=32, dit_depth=1, dit_patch=4), 10,
                   None, device="cpu")
    assert isinstance(m, DiT1D) and (m.n_tok, m.pad) == (3, 2)
    m = make_model(archi("DiT2D", dit_width=32, dit_depth=1, dit_patch=4),
                   64, None, device="cpu")
    assert isinstance(m, DiT2D) and m.flatten_order == "F"
    m = make_model(archi("Unet1D", base_channels=8, channel_mults=(1, 2)),
                   16, None, device="cpu")
    assert isinstance(m, UNet1D) and m.depth == 2 and m.premodule is None
    with pytest.raises(ValueError, match="square"):
        make_model(archi("DiT2D"), 10, None, device="cpu")


class _NoNet:
    def init(self, key, x, t):
        return {"params": {}}

    def apply(self, variables, x, t):
        return x


@pytest.mark.parametrize("is_msgm", [False, True])
def test_toy_arm_is_built_as_jax_builds_it(is_msgm, monkeypatch):
    """The gaussian preset at d = 8: the MSGM arm's SDE has a dense G of
    d³ and JAX's name; the SGM arm the VP SDE."""
    cfg, jcfg = (c.get_preset("gaussian") for c in (configs, jax_configs))
    monkeypatch.setattr(jax_driver, "make_model", lambda *a, **k: _NoNet())
    jsampler = jax_synth.Gaussian(jax.random.PRNGKey(1), 8,
                                  normalized=not is_msgm)
    _, jgen = JaxDriver(jcfg, make_plots=False)._build_arm(
        jax.random.PRNGKey(0), jsampler, 8, is_msgm,
        "NormalizeLogRadius" if is_msgm else None, 64, False)
    model, gen = ExperimentDriver(cfg, make_plots=False, device="cpu")\
        ._build_arm(torch.Generator().manual_seed(0), 8, is_msgm, 64)
    ours, ref = gen.base_sde, jgen.base_sde
    assert ours.name == ref.name
    assert isinstance(model, MLP)
    if is_msgm:
        assert ours.name == "MSGMlogNorm" and not ours.circulant
        assert ours.G.shape == (8, 8, 8) and ours.r_T.shape == (64,)
        torch.testing.assert_close(ours.beta_G(), torch.tensor(1.0))
        assert model.premodule == "NormalizeLogRadius"


@pytest.mark.parametrize("datatype", ["gaussian", "gaussianCauchy"])
def test_msgm_arm_draws_its_matrix_as_train_msgm_arm_does(datatype):
    """``build_msgm_arm`` without a sampler draws the data matrix from
    ``fold_in(generator, 0)``, as ``train_msgm_arm`` and the driver hand
    it one: the same seed builds the same radial prior and dense G."""
    cfg = configs.get_preset(datatype)
    sampler = make_sampler(arm_config(cfg, True), 8, "cpu",
                           fold_in(torch.Generator().manual_seed(5), 0))
    arms = [build_msgm_arm(cfg, torch.Generator().manual_seed(5), 8,
                           num_samples_init=64, device="cpu", **kw)[1]
            for kw in ({}, {"sampler": sampler})]
    (a, b) = (gen.base_sde for gen in arms)
    torch.testing.assert_close(a.r_T, b.r_T, rtol=0, atol=0)
    torch.testing.assert_close(a.G, b.G, rtol=0, atol=0)


def test_msgm_gaussian_cauchy_trains_on_the_cpu():
    """The JAX package's MSGM end-to-end test (tests/test_train_e2e.py:
    53-89) at a CPU budget: GaussianCauchy, dense G, 8 forward steps, β_max
    2, the log map, the MLP with the premodule, 60 steps at batch 64; then
    RK4-32 norm-corrected from the latent, every norm kept to rtol 1e-4."""
    g = torch.Generator().manual_seed(0)
    sampler = GaussianCauchy(torch.Generator().manual_seed(1), dim=2)
    x_init = sampler.sample(g, 2048)
    sde = MSGMSde.create(x_init, generator=g, beta_max=2.0,
                         num_steps_forward=8, norm_map="log")
    assert not sde.circulant
    torch.manual_seed(0)
    gen = PluginReverseSDE.create(sde, MLP(input_dim=2,
                                           premodule="NormalizeLogRadius"))
    trainer = Trainer(gen, sampler, lr=1e-3, batch_size=64,
                      print_every=10_000, log_fn=lambda s: None)
    state, loss = trainer.run(g, 60)
    assert np.isfinite(loss)
    x0 = state.gen_sde.latent_sample(g, 512, 2)
    with torch.no_grad():
        xgen = integrate_sde(state.gen_sde, x0, g, 32, method="rk4",
                             norm_correction=True)
    assert torch.isfinite(xgen).all()
    torch.testing.assert_close(xgen.norm(dim=1), x0.norm(dim=1), rtol=1e-4,
                               atol=0)


def test_cli_default_preset_swissroll_dbg_on_the_cpu(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.chdir(tmp_path)
    assert run.build_parser().parse_args([]).preset == "swissroll"
    res = run.main(["--preset", "swissroll_dbg", "--cpu", "--no-plots",
                    "--eval-mmd", "--results-dir", str(tmp_path / "res")])
    assert "sqrt-MMD MSGM" in capsys.readouterr().out
    for k in ("mmd_sgm", "mmd_msgm", "mmd_ref"):
        assert res[k].shape == (1, 2, 2, 2, 1) and np.isfinite(res[k]).all()
    cfg = configs.get_preset("swissroll_dbg")
    tc, sw = cfg.train, cfg.sweep
    for is_msgm, sde_name in ((False, "SGM"), (True, "MSGMlogNorm")):
        for it in sw.iterationss:
            # fair budget: the MSGM arm's iterations over √2·10/16 → 1
            args = ("swiss", sde_name, it, min(tc.num_samples_init_max,
                                               it * 2),
                    2, tc.num_steps_forward, tc.beta_min, tc.beta_max,
                    tc.beta_min_sgm, tc.beta_max_sgm, is_msgm)
            kw = dict(nn_archi="MLP", premodule=(
                "NormalizeLogRadius" if is_msgm else None),
                fair_comparison=sw.fair_comparison)
            root = jax_naming.run_name_root(*args, **kw)
            for steps in sw.num_stepss_backward:
                name = jax_naming.simulation_name(
                    str(tmp_path / "res"), root, tc.t_eps, steps, True)
                assert os.path.exists(name + ".npy"), name
                assert np.load(name + "_traj.npy").shape == (steps + 1, 10, 2)
            assert os.path.exists(str(tmp_path / "res" / root)
                                  + "_checkpoint_final")


def test_cli_grf16_dit_dbg_on_the_cpu(tmp_path, monkeypatch, capsys):
    """grf16_dit_dbg through the CLI on the CPU at full width (DiT2D of
    width 512, depth 6), with the production CLI test's overrides."""
    monkeypatch.chdir(tmp_path)
    res = run.main(["--preset", "grf16_dit_dbg", "--cpu", "--no-plots",
                    "--eval-mmd", "--iterations", "2", "--num-samples", "6",
                    "--steps-backward", "2",
                    "--results-dir", str(tmp_path / "res")])
    assert "preset = grf16_dit_dbg" in capsys.readouterr().out
    for k in ("mmd_sgm", "mmd_msgm", "mmd_ref"):
        assert res[k].shape == (1, 2, 1, 1, 1) and np.isfinite(res[k]).all()
    files = os.listdir(tmp_path / "res" / "grf16")
    assert any(f.startswith("MSGM_sparseTenslogNorm_2iteRefLearning") and
               "_DiT2D_NormalizeLogRadius" in f for f in files)
    assert any(f.startswith("SGM_2iteRefLearning") and "_DiT2D0.0001lr" in f
               for f in files)
