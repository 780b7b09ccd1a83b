"""The experiment driver: both arms of a preset trained by SSM, sampled by
the plug-in reverse SDE and scored by √MMD and SWD.

Port of sdeflow_tpu/experiments/driver.py:40-222, 224-700: ``make_model``
(the MLP, the U-Net, UNet1D and the DiT score nets), ``make_sampler`` (every
datatype: the toy presets' swissroll, gaussian, gaussianCauchy and cauchy,
``grf``, and the file-backed piv, lorenz63, lorenz96, pod, era5*,
eof_pressure, weather_station and ncar under the data root),
``resolve_std_norm``, the generation program
``generate`` (``_jit_generate``), and ``ExperimentDriver``: the sweep over
complexity (train-set size, Lorenz-96 size or Reynolds number) ×
dimension × {SGM, MSGM} × iterations × batch size, each arm
built (``_build_arm``; the MSGM arm on unnormalized data, as every arm of
swissroll), trained by ``train_arm`` with its fair budget
(``fair_budgets``), checkpointed,
sampled over the backward step counts and repeat runs with its base SDE's
own ``norm_correction``, and scored by the metric block of the JAX package's
``postprocessing`` (sdeflow_tpu/plotting/plots.py:480-545) without its
plots (``score_samples``); the 5-D result arrays are saved under the JAX
package's file names. Each run samples by the sweep's sampler (the reverse
SDE, the PF-ODE or DPM-Solver; an MSGM arm under "dpm" falls back, logged,
to the SDE with RK4, as in the JAX driver), and ``eval_nll`` reports each
trained arm's exact PF-ODE NLL in bits/dim (``_eval_nll``,
``nll_bits_per_dim.json``). The plots raise ``NotImplementedError``
naming their ROADMAP Queue 1 item (13b).

Random streams: the JAX driver reseeds each arm from ``PRNGKey(seed)``, so
both arms see the same test set and the same train set for the MMD floor.
Here each arm starts a ``torch.Generator`` from ``cfg.seed`` and folds one
stream per purpose off it (ops/rng.py): the test set's, and the arm's own
build, train and sample streams, and the data sampler's (the matrix of
gaussian, gaussianCauchy and cauchy); each sampling run folds
i_steps·1000 + i_run off the sample stream, the MMD train set 777.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import replace

import numpy as np
import torch

from sdeflow_tpu_torch.configs import ExperimentConfig
from sdeflow_tpu_torch.data import filebacked, synthetic
from sdeflow_tpu_torch.eval.diagnostics import filter_blowups
from sdeflow_tpu_torch.eval.mmd import compute_mmd, sliced_wasserstein
from sdeflow_tpu_torch.eval.nll import nll_summary
from sdeflow_tpu_torch.experiments.naming import run_name_root, simulation_name
from sdeflow_tpu_torch.models.dit import DiT1D, DiT2D
from sdeflow_tpu_torch.models.mlp import MLP
from sdeflow_tpu_torch.models.unet1d import UNet1D
from sdeflow_tpu_torch.models.vorticity import VorticityUNet
from sdeflow_tpu_torch.ops.kernels.common import resolve_device
from sdeflow_tpu_torch.ops.rng import fold_in, fold_seed
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde
from sdeflow_tpu_torch.serving import make_sampler_fn
from sdeflow_tpu_torch.training.checkpoint import (
    delete_checkpoint, save_checkpoint)
from sdeflow_tpu_torch.training.train import Trainer

METRICS = ("mmd_sgm", "mmd_msgm", "mmd_ref", "swd_sgm", "swd_msgm",
           "swd_ref")


COMPUTE_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
                  "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def make_model(cfg: ExperimentConfig, dim, premodule, device="cuda"):
    """The score net of `cfg` (``cfg.train.nn_archi``: MLP, Unet, Unet1D,
    DiT or DiT2D) on `device` (random weights, fp32), computing in
    ``cfg.train.compute_dtype`` (float32 or bfloat16); the U-Net's
    AttentionBlocks take ``cfg.train.attention_impl`` ("auto" or
    "unfused"; "ring" raises)."""
    tc = cfg.train
    if tc.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"Unknown compute_dtype: {tc.compute_dtype}")
    dtype = COMPUTE_DTYPES[tc.compute_dtype]
    if tc.nn_archi == "MLP":
        model = MLP(input_dim=dim, hidden_dim=128,
                    premodule=premodule, dtype=dtype)
    elif tc.nn_archi == "Unet1D":
        model = UNet1D(input_dim=dim, base_channels=tc.base_channels,
                       channel_mults=tc.channel_mults, premodule=premodule,
                       emb_dim=tc.emb_dim, dtype=dtype)
    elif tc.nn_archi == "DiT":
        model = DiT1D(input_dim=dim, patch=tc.dit_patch, width=tc.dit_width,
                      depth=tc.dit_depth, heads=tc.dit_heads,
                      premodule=premodule, dtype=dtype)
    elif tc.nn_archi in ("Unet", "DiT2D"):
        npixel = int(round(dim**0.5))
        if dim != npixel**2:
            raise ValueError(f"Incorrect dim to define square image: {dim}")
        if tc.nn_archi == "DiT2D":
            model = DiT2D(in_space=npixel, patch=tc.dit_patch,
                          width=tc.dit_width, depth=tc.dit_depth,
                          heads=tc.dit_heads, premodule=premodule,
                          flatten_order="F", dtype=dtype)
        else:
            model = VorticityUNet(
                base_channels=tc.base_channels,
                channel_mults=tc.channel_mults,
                num_res_blocks=tc.num_res_blocks,
                premodule=premodule,
                in_space=npixel,
                attention_resolutions=tc.attention_resolutions,
                flatten_order="F",
                attention_impl=tc.attention_impl,
                dtype=dtype)
    else:
        raise ValueError(f"Unknown NN archi: {tc.nn_archi}")
    return model.to(resolve_device(device))


SYNTHETIC = {"gaussian": synthetic.Gaussian,
             "gaussianCauchy": synthetic.GaussianCauchy,
             "cauchy": synthetic.Cauchy}


def make_sampler(cfg: ExperimentConfig, dim, device="cuda", generator=None,
                 complexity=None):
    """The dataset of `cfg` at dimension `dim` on `device`: swissroll and
    grf draw nothing at build time; gaussian, gaussianCauchy and cauchy
    draw their matrix from `generator` (on `device`), with the config's
    correlation and normalized flags; the file-backed datatypes read their
    files under the data root. `complexity` is the sweep's: the train-set
    size cap for piv, lorenz63 and pod, the Lorenz-96 system size for
    lorenz96 (the config's n_dim_l96 when None or infinite), the Reynolds
    number for pod (300 when None)."""
    dc = cfg.data
    dt = dc.datatype
    ntrain_max = complexity if complexity is not None else np.inf
    if dt == "swissroll":
        return synthetic.SwissRoll(device=device)
    if dt in SYNTHETIC:
        if generator is None:
            raise ValueError(f"datatype={dt!r} draws its matrix from a "
                             "generator")
        return SYNTHETIC[dt](generator, dim, correlation=dc.correlation,
                             normalized=dc.normalized)
    if dt == "grf":
        return synthetic.SmoothedGRF(npixel=int(round(dim**0.5)),
                                     ell=float(dc.smoothing or 2),
                                     device=device)
    if dt == "piv":
        return filebacked.PIV(
            dim, normalized=dc.normalized, large_image=dc.large_image,
            smoothing=dc.smoothing, localized=dc.localized,
            few_data=dc.few_data, ntrain_max=ntrain_max, device=device)
    if dt == "lorenz63":
        return filebacked.Lorenz63(
            dim, normalized=dc.normalized, few_data=dc.few_data,
            ntrain_max=ntrain_max, device=device)
    if dt == "lorenz96":
        n_dim = (dc.n_dim_l96 if complexity is None
                 or not np.isfinite(complexity) else int(complexity))
        return filebacked.Lorenz96(n_dim, dim, normalized=dc.normalized,
                                   device=device)
    if dt == "pod":
        return filebacked.PODmodes(
            int(complexity or 300), dim, normalized=dc.normalized,
            mixed_times=dc.mixed_times, concatenate_re=dc.concatenate_re,
            few_data=dc.few_data, ntrain_max=ntrain_max, device=device)
    if dt.startswith("era5"):  # era5, era5temp, era5vorttemp
        return filebacked.ERA5(
            dim, variables=dc.era5_variables, season=dc.season,
            use_deseason=dc.use_deseason, mixed_times=dc.mixed_times,
            device=device)
    if dt == "eof_pressure":
        return filebacked.EOFPressure(dim, device=device)
    if dt == "weather_station":
        return filebacked.WeatherStation(dim, device=device)
    if dt == "ncar":
        return filebacked.NCARWeatherStation(dim, device=device)
    raise ValueError(f"Unknown datatype: {dt}")


def arm_config(cfg: ExperimentConfig, is_msgm):
    """`cfg` with the arm's data normalization: the config's for the SGM
    arm, none for the MSGM arm and for swissroll (sdeflow_tpu/experiments/
    driver.py:362-373)."""
    dc = cfg.data
    normalized = (dc.normalized and not is_msgm
                  and dc.datatype != "swissroll")
    return replace(cfg, data=replace(dc, normalized=normalized))


def resolve_std_norm(sampler, normalized, real_dim, device="cuda"):
    """Per-dimension std that de-normalizes samples before the metrics:
    the sampler's ``get_std`` when the arm is normalized and it has one
    (every synthetic sampler but SwissRoll), else ones. A file-backed
    sampler that inherits ``ArraySampler.get_std`` has one only if its
    loader computed a std (weather_station, ncar and eof_pressure
    standardize inside the loader and compute none)."""
    if normalized and hasattr(sampler, "get_std"):
        inherited = (getattr(type(sampler), "get_std", None)
                     is filebacked.ArraySampler.get_std)
        if not inherited or hasattr(sampler, "std"):
            return sampler.get_std()
    return torch.ones((real_dim,), device=resolve_device(device))


def generate(gen, generator, num_samples, dim, num_steps, method,
             include_t0, norm_correction, sampler="sde", corrector_steps=0,
             snr=0.16, dpm_grid="logsnr", device="cuda"):
    """The whole generation of one sampling run: the serving module's
    sampler program (`sampler` with `method`; under "sde" corrector_steps
    Langevin steps with snr after each step, under "dpm" the dpm_grid) with
    the trajectory kept, (S, num_samples, dim), S = num_steps (+1 with
    include_t0)."""
    fn = make_sampler_fn(
        gen, num_samples, dim, num_steps, method=method,
        norm_correction=norm_correction, keep_all=True,
        include_t0=include_t0, sampler=sampler,
        corrector_steps=corrector_steps, snr=snr, dpm_grid=dpm_grid,
        device=device)
    return fn(generator)


def score_samples(xs, xtest, x_train, std_norm, name_simu, *, max_n,
                  save_results=True, log_fn=print):
    """The metric block of one sampling run: save the last state of the
    trajectory xs to ``name_simu + ".npy"``, drop blown-up rows, and the
    MMD and SWD of the generated and of the train samples to the test
    samples, on n − 1 rows (the reference's quirk, n ≤ max_n), scaled by
    std_norm, with one fixed direction set for the SWD of every arm and
    run. Returns dict(nan_count, mmd, mmd_ref, swd, swd_ref)."""
    xgen = xs[-1]
    if save_results:
        np.save(name_simu + ".npy", _host(xgen))
    xgen, nan_count = filter_blowups(xgen)
    if nan_count > 0:
        log_fn(f"Number of rows with NaN or large value: {nan_count}")
    result = dict(nan_count=nan_count)
    dev = xtest.device
    n = min(xtest.shape[0], max_n)
    n = min(n, xgen.shape[0] + 1, x_train.shape[0] + 1)
    xt = xtest[: n - 1]
    xg = torch.as_tensor(xgen[: n - 1], device=dev)
    xtr = x_train[: n - 1]
    sn = std_norm.to(device=dev, dtype=xt.dtype)
    result["mmd_ref"] = float(compute_mmd(sn * xtr, sn * xt))
    result["mmd"] = float(compute_mmd(sn * xg, sn * xt))
    log_fn(f"MMD train to test = {result['mmd_ref'] ** 0.5}")
    log_fn(f"MMD gen. to test = {result['mmd'] ** 0.5}")

    def swd(a, b):  # the same directions for every arm and run
        g = torch.Generator(device=dev).manual_seed(0)
        return float(sliced_wasserstein(g, sn * a, sn * b))

    result["swd_ref"] = swd(xtr, xt)
    result["swd"] = swd(xg, xt)
    log_fn(f"SWD train to test = {result['swd_ref']}")
    log_fn(f"SWD gen. to test = {result['swd']}")
    return result


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_msgm_arm(cfg: ExperimentConfig, generator, dim=None,
                   num_samples_init=None, device="cuda", sampler=None):
    """Score net (random weights from the caller's seed) and the reverse
    SDE of the MSGM arm (ssm_intT from the sweep's ssm_intT_ref): the
    radial prior comes from `num_samples_init` samples of `sampler` (by
    default the arm's data sampler, its matrix drawn from
    ``fold_in(generator, 0)`` as ``train_msgm_arm`` draws it;
    `num_samples_init` by default the JAX driver's
    min(num_samples_init_max, iterations·batch)), the dense G of
    ``cfg.train.dense_tensor`` from `generator` after them."""
    tc, sw = cfg.train, cfg.sweep
    dim = cfg.data.dims[0] if dim is None else dim
    if num_samples_init is None:
        num_samples_init = init_samples(cfg, sw.iterationss[0],
                                        sw.batch_sizes[0])
    model = make_model(cfg, dim, "NormalizeLogRadius", device=device)
    if sampler is None:
        sampler = make_sampler(arm_config(cfg, True), dim, device,
                               fold_in(generator, 0))
    x_init = sampler.sample(generator, num_samples_init)
    sde = MSGMSde.create(
        x_init, generator=generator, beta_min=tc.beta_min,
        beta_max=tc.beta_max, T=tc.T0, t_epsilon=tc.t_eps,
        num_steps_forward=tc.num_steps_forward,
        dense_tensor=tc.dense_tensor, norm_sampler=tc.norm_sampler,
        norm_map=tc.norm_map, estimate_norm_constant=False)
    return model, PluginReverseSDE.create(sde, model, vtype=tc.vtype,
                                          ssm_intT=sw.ssm_intT_ref)


def build_sgm_arm(cfg: ExperimentConfig, generator, dim=None,
                  device="cuda"):
    """Score net (random weights, from torch's global seed as in
    ``build_msgm_arm``) and the reverse SDE of the SGM arm: no premodule,
    the VP SDE of the config's beta_min_sgm/beta_max_sgm, and the config's
    parameterization (sdeflow_tpu/experiments/driver.py:306-318, 345-348).
    `generator` keeps ``build_msgm_arm``'s signature: the SGM arm draws no
    data at build time."""
    del generator
    tc = cfg.train
    dim = cfg.data.dims[0] if dim is None else dim
    model = make_model(cfg, dim, None, device=device)
    sde = SGMSde.create(beta_min=tc.beta_min_sgm, beta_max=tc.beta_max_sgm,
                        T=tc.T0, t_epsilon=tc.t_eps,
                        num_steps_forward=tc.num_steps_forward,
                        device=device)
    return model, PluginReverseSDE.create(
        sde, model, vtype=tc.vtype, parameterization=tc.parameterization)


def fair_budgets(cfg: ExperimentConfig, is_msgm, ssm_intT, dim,
                 batch_size_ref, iterations_ref, log_fn=print):
    """(batch_size, iterations) of an arm: intT divides the batch by
    num_steps_forward (same memory); under fair_comparison the MSGM arm
    divides the iterations by max(1, √d·num_steps_forward/16)."""
    tc, sw = cfg.train, cfg.sweep
    batch_size = (max(1, int(batch_size_ref / tc.num_steps_forward))
                  if ssm_intT else batch_size_ref)
    if sw.fair_comparison and is_msgm:
        ratio_ite = max(1, int(math.sqrt(dim) * tc.num_steps_forward / 16))
        log_fn(f"ratio_ite = {ratio_ite}")
        iterations = max(1, int(iterations_ref / ratio_ite))
    else:
        iterations = iterations_ref
    return batch_size, iterations


def init_samples(cfg: ExperimentConfig, iterations, batch_size):
    """The data samples behind the MSGM arm's radial prior, as in the JAX
    driver: min(num_samples_init_max, iterations·batch_size)."""
    return int(min(cfg.train.num_samples_init_max, iterations * batch_size))


def make_trainer(cfg: ExperimentConfig, gen, sampler, batch_size,
                 log_fn=print, checkpoint_path=None):
    """The arm's SSM Trainer with the config's optimizer, cadence,
    checkpoint cadence and EMA, as the JAX driver builds it; checkpoints go
    to checkpoint_path when given."""
    tc = cfg.train
    return Trainer(
        gen, sampler, lr=tc.lr, batch_size=batch_size, loss="ssm",
        print_every=tc.print_every, save_every=tc.save_every,
        checkpoint_path=checkpoint_path, log_fn=log_fn, ema_rate=tc.ema_rate,
        ema_warmup=tc.ema_warmup, grad_clip=tc.grad_clip,
        weight_decay=tc.weight_decay, lr_warmup_steps=tc.lr_warmup_steps)


def train_arm(cfg: ExperimentConfig, gen, sampler, generator, *, batch_size,
              iterations, x_test, checkpoint_path=None, log_fn=print):
    """Train one arm as the JAX driver's _run_arm does: its SSM Trainer
    (``make_trainer``) for `iterations` steps with ELBO prints on the first
    1000 rows of x_test, then the rolling checkpoint removed. Returns
    (trainer, the last state, the trained gen — over the EMA weights when
    the config sets ema_rate — and the last loss)."""
    trainer = make_trainer(cfg, gen, sampler, batch_size, log_fn,
                           checkpoint_path=checkpoint_path)
    state, loss = trainer.run(generator, iterations, x_test=x_test[:1000])
    # with ema_rate, sampling and evaluation use the averaged weights
    gen = trainer.ema_gen_sde if cfg.train.ema_rate else state.gen_sde
    if checkpoint_path:
        delete_checkpoint(checkpoint_path)
        log_fn("Training finished successfully, checkpoint removed.")
    return trainer, state, gen, loss


def train_msgm_arm(cfg: ExperimentConfig, generator, *, iterations=None,
                   arm=None, x_test=None, device="cuda", log_fn=print):
    """Train the MSGM arm of `cfg` by ``train_arm``: fair budgets from the
    sweep's first iterations and batch size, the arm (``build_msgm_arm``
    unless `arm` = (model, gen) is given), and ELBO prints on the first
    1000 test samples (drawn from the data sampler unless given).
    `iterations` overrides the fair budget. Returns (trainer, the trained
    gen, the last loss)."""
    sw = cfg.sweep
    dim = cfg.data.dims[0]
    batch_size, fair_iterations = fair_budgets(
        cfg, True, sw.ssm_intT_ref, dim, sw.batch_sizes[0],
        sw.iterationss[0], log_fn)
    iterations = fair_iterations if iterations is None else int(iterations)
    sampler = make_sampler(arm_config(cfg, True), dim, device,
                           fold_in(generator, 0))
    if arm is None:
        arm = build_msgm_arm(
            cfg, generator, dim, device=device,
            num_samples_init=init_samples(cfg, fair_iterations, batch_size),
            sampler=sampler)
    _, gen = arm
    if x_test is None:
        x_test = sampler.sample(generator, 1000)
    log_fn(f"name_SDE = {gen.base_sde.name}  iterations = {iterations}  "
           f"batch_size = {batch_size}  ssm_intT = {gen.ssm_intT}")
    trainer, _, gen, loss = train_arm(
        cfg, gen, sampler, generator, batch_size=batch_size,
        iterations=iterations, x_test=x_test, log_fn=log_fn)
    return trainer, gen, loss


def _check_ported(make_plots):
    """Raise for what the driver does not run yet, before any training."""
    if make_plots:
        raise NotImplementedError(
            "plots (the noising diagnostics, pairplots and convergence "
            "plots): ROADMAP Queue 1 item 13b; run with make_plots=False "
            "(--no-plots)")


class ExperimentDriver:
    """Runs the comparison sweep of one ExperimentConfig on `device`."""

    def __init__(self, cfg: ExperimentConfig, log_fn=print, make_plots=True,
                 device="cuda"):
        _check_ported(make_plots)
        self.cfg = cfg
        self.log = log_fn
        self.device = resolve_device(device)
        self.results = {}
        self.nll_results = {}

    # -- per-arm helpers ----------------------------------------------------
    def _build_arm(self, generator, dim, is_msgm, num_samples_init,
                   sampler=None):
        """Score net (random weights from a seed folded off `generator`)
        and reverse SDE of one arm: MSGM with its radial prior from
        num_samples_init samples of `sampler` (default: the arm's data
        sampler) and the "direct" parameterization, or SGM with the
        config's."""
        init = torch.random.default_generator
        with torch.random.fork_rng(devices=[]):  # the CPU stream only
            init.manual_seed(fold_seed(generator, 0))
            if is_msgm:
                return build_msgm_arm(
                    self.cfg, fold_in(generator, 1), dim,
                    num_samples_init=num_samples_init, device=self.device,
                    sampler=sampler)
            return build_sgm_arm(self.cfg, None, dim, device=self.device)

    # -- the sweep ------------------------------------------------------------
    def run(self, just_load=False):
        """The whole sweep; returns the results dict (the 5-D arrays of
        (dims, complexitys, steps backward, iterations, runs) under the
        JAX package's keys). With just_load the trajectories are read from
        their ``_traj.npy`` files instead of generated (the arms are built
        but not trained)."""
        cfg = self.cfg
        sw, dc = cfg.sweep, cfg.data
        complexitys = self._complexitys()
        dims = list(dc.dims)
        shape = (len(dims), len(complexitys), len(sw.num_stepss_backward),
                 len(sw.iterationss), sw.nruns_mmd)
        arrays = {k: np.zeros(shape) for k in METRICS}
        folder_results = cfg.results_dir
        os.makedirs(folder_results, exist_ok=True)

        for i_cx, complexity in enumerate(complexitys):
            for i_dim, dim in enumerate(dims):
                for is_msgm in sw.msgms:
                    # arm-specific defaults (reference MSGM_higherDim.py:
                    # 473-483)
                    arm_cfg = arm_config(cfg, is_msgm)
                    normalized = arm_cfg.data.normalized
                    ssm_intT = sw.ssm_intT_ref if is_msgm else False
                    arm_gen = torch.Generator(device=self.device)
                    arm_gen.manual_seed(cfg.seed)  # the same for each arm
                    key_sampler, key_test, key_arm = (fold_in(arm_gen, i)
                                                      for i in (0, 1, 2))
                    sampler = make_sampler(arm_cfg, dim, self.device,
                                           key_sampler, complexity)
                    os.makedirs(os.path.join(folder_results, sampler.name),
                                exist_ok=True)
                    xtest = sampler.sampletest(key_test, sw.num_samples)
                    real_dim = int(xtest.shape[1])
                    std_norm = resolve_std_norm(sampler, normalized,
                                                real_dim, self.device)
                    for i_iter, iterations_ref in enumerate(sw.iterationss):
                        for batch_size_ref in sw.batch_sizes:
                            self._run_arm(
                                key_arm, sampler, xtest, std_norm,
                                dim=real_dim, is_msgm=is_msgm,
                                ssm_intT=ssm_intT,
                                iterations_ref=iterations_ref,
                                batch_size_ref=batch_size_ref,
                                indices=(i_dim, i_cx, i_iter),
                                arrays=arrays, just_load=just_load)

        self.results = dict(arrays, dims=dims, complexitys=complexitys,
                            nll_bits_per_dim=self.nll_results)
        if sw.eval_mmd:
            self._save_mmd_arrays(folder_results)
        return self.results

    def _run_arm(self, key, sampler, xtest, std_norm, *, dim, is_msgm,
                 ssm_intT, iterations_ref, batch_size_ref, indices, arrays,
                 just_load):
        cfg = self.cfg
        tc, sw, pc = cfg.train, cfg.sweep, cfg.plots
        i_dim, i_cx, i_iter = indices
        folder_results = cfg.results_dir
        premodule = "NormalizeLogRadius" if is_msgm else None

        batch_size, iterations = fair_budgets(
            cfg, is_msgm, ssm_intT, dim, batch_size_ref, iterations_ref,
            self.log)
        num_samples_init = init_samples(cfg, iterations, batch_size)
        self.log(f"num_samples_init = {num_samples_init}")

        key_build, key_train, key_sample = (
            fold_in(key, i) for i in (0, 2, 3))  # 1: the noising plots
        _, gen = self._build_arm(key_build, dim, is_msgm, num_samples_init,
                                 sampler)

        self.log(f"data = {sampler.name}")
        self.log(f"name_SDE = {gen.base_sde.name}")
        self.log(f"num_steps_forward = {tc.num_steps_forward}")
        self.log(f"iterations = {iterations} (ref {iterations_ref})")
        self.log(f"batch_size = {batch_size}")
        self.log(f"ssm_intT = {ssm_intT}  fair = {sw.fair_comparison}")
        self.log(f"NNarchi = {tc.nn_archi}  premodule = {premodule}")

        name_root = run_name_root(
            sampler.name, gen.base_sde.name, iterations_ref,
            num_samples_init, batch_size, tc.num_steps_forward,
            tc.beta_min, tc.beta_max, tc.beta_min_sgm, tc.beta_max_sgm,
            is_msgm, nn_archi=tc.nn_archi, premodule=premodule, lr=tc.lr,
            vtype=tc.vtype, ssm_intT=ssm_intT,
            fair_comparison=sw.fair_comparison)

        # train (reference MSGM_higherDim.py:790-850)
        checkpoint_path = (
            os.path.join(folder_results, name_root + "_checkpoint")
            if tc.use_checkpoint else None)
        if not just_load:
            trainer, state, gen, _ = train_arm(
                cfg, gen, sampler, key_train, batch_size=batch_size,
                iterations=iterations, x_test=xtest,
                checkpoint_path=checkpoint_path, log_fn=self.log)
            save_checkpoint(
                os.path.join(folder_results,
                             name_root + "_checkpoint_final"),
                state, key_train, iterations - 1, trainer.optimizer)
            if sw.eval_nll:
                self._eval_nll(gen, xtest, key_train, name_root)
        elif sw.eval_nll:
            self.log("eval_nll skipped: --just-load restores saved samples, "
                     "not a trained model")

        # reverse-sampling sweep (reference MSGM_higherDim.py:852-916)
        x_train_for_mmd = sampler.sample(fold_in(key_sample, 777),
                                         sw.num_samples)
        eff_sampler, eff_method = self._effective_sampler(gen)
        for i_steps, num_steps_backward in enumerate(sw.num_stepss_backward):
            self.log(f"Generation : num_steps_backward = {num_steps_backward}")
            for i_run in range(sw.nruns_mmd):
                name_simu = simulation_name(
                    folder_results, name_root, tc.t_eps, num_steps_backward,
                    sw.include_t0_reverse, i_run, method=eff_method)
                if i_run > 0:  # runs/<sampler>/ under the cwd, as in JAX
                    os.makedirs(os.path.join("runs", sampler.name),
                                exist_ok=True)
                k_run = fold_in(key_sample, i_steps * 1000 + i_run)
                if just_load:
                    xs = np.load(name_simu + "_traj.npy")
                else:
                    t0 = time.perf_counter()
                    xs = generate(
                        gen, k_run, sw.num_samples, dim, num_steps_backward,
                        eff_method, sw.include_t0_reverse,
                        bool(gen.base_sde.norm_correction),
                        sampler=eff_sampler,
                        corrector_steps=sw.corrector_steps, snr=sw.snr,
                        dpm_grid=sw.dpm_grid, device=self.device)
                    _sync(self.device)
                    self.log(f"generated {tuple(xs.shape)} in "
                             f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
                    if pc.save_results:
                        np.save(name_simu + "_traj.npy", _host(xs))

                if sw.eval_mmd:
                    out = score_samples(
                        xs, xtest, x_train_for_mmd, std_norm, name_simu,
                        max_n=sw.num_samples,
                        save_results=pc.save_results and not just_load,
                        log_fn=self.log)
                    idx = (i_dim, i_cx, i_steps, i_iter, i_run)
                    arm = "msgm" if is_msgm else "sgm"
                    arrays["mmd_ref"][idx] = out["mmd_ref"]
                    arrays["swd_ref"][idx] = out["swd_ref"]
                    arrays[f"mmd_{arm}"][idx] = out["mmd"]
                    arrays[f"swd_{arm}"][idx] = out["swd"]

    def _effective_sampler(self, gen):
        """(sampler, method) that an arm's runs take: under "dpm" a method
        name that is not a dpm one becomes dpm2m, and an arm without a
        closed-form kernel (MSGM) falls back, logged, to the SDE with RK4
        (sdeflow_tpu/experiments/driver.py:547-560), so that names and
        logs carry the method that runs."""
        sw = self.cfg.sweep
        eff_sampler, eff_method = sw.sampler, sw.backward_method
        if eff_sampler == "dpm":
            if not eff_method.startswith(("dpm", "sdpm")):
                eff_method = "dpm2m"
            if not hasattr(gen.base_sde, "mean_weight"):
                eff_sampler, eff_method = "sde", "rk4"
                self.log(f"sampler 'dpm' needs a closed-form forward kernel; "
                         f"{gen.base_sde.name} arm falls back to sampler "
                         f"'{eff_sampler}' / method '{eff_method}'")
        return eff_sampler, eff_method

    def _eval_nll(self, gen, xtest, generator, name_root):
        """The exact NLL (bits/dim) of a trained arm by the PF-ODE
        likelihood with the normalized latent prior (``nll_summary``), its
        probes from ``fold_in(generator, 999)``; every arm's entry so far
        written to ``nll_bits_per_dim.json``
        (sdeflow_tpu/experiments/driver.py:629-653)."""
        entry = nll_summary(gen, xtest, fold_in(generator, 999),
                            num_steps=self.cfg.sweep.nll_steps)
        self.nll_results[name_root] = entry
        if entry["mean"] is None:
            self.log("NLL: no finite log-density (diverged arm?)")
        else:
            self.log(f"NLL = {entry['mean']:.4f} ± {entry['stderr']:.4f} "
                     f"bits/dim (exact PF-ODE likelihood, {entry['n']} test "
                     "points)")
        path = os.path.join(self.cfg.results_dir, "nll_bits_per_dim.json")
        with open(path, "w") as f:
            json.dump(self.nll_results, f, indent=1)

    def _mmd_path(self, folder, arm, metric="MMD"):
        """The metric result-array file names (reference:
        MSGM_higherDim.py:924-936; "SWD" for the sliced-Wasserstein
        arrays)."""
        return os.path.join(
            folder,
            f"global{metric}file_{arm}_{self.cfg.sweep.nruns_mmd}runs.npy")

    def _complexitys(self):
        """The sweep's complexity axis: Reynolds numbers for POD, train-set
        sizes otherwise."""
        sw, dc = self.cfg.sweep, self.cfg.data
        return list(sw.Res) if dc.datatype == "pod" else list(sw.ntrain_maxs)

    def load_mmd_and_plot(self, folder=None):
        """Reload the saved metric arrays without rerunning the sweep (the
        convergence plots come with ROADMAP Queue 1 item 13b)."""
        folder = folder or self.cfg.results_dir
        self.results = dict(
            mmd_sgm=np.load(self._mmd_path(folder, "SGM")),
            mmd_msgm=np.load(self._mmd_path(folder, "MSGM")),
            mmd_ref=np.load(self._mmd_path(folder, "ref")),
            dims=list(self.cfg.data.dims),
            complexitys=self._complexitys(),
        )
        for arm, res_key in (("SGM", "swd_sgm"), ("MSGM", "swd_msgm"),
                             ("ref", "swd_ref")):
            swd_path = self._mmd_path(folder, arm, metric="SWD")
            if os.path.exists(swd_path):
                self.results[res_key] = np.load(swd_path)
        return self.results

    def _save_mmd_arrays(self, folder):
        for metric in ("MMD", "SWD"):
            for arm in ("SGM", "MSGM", "ref"):
                np.save(self._mmd_path(folder, arm, metric),
                        self.results[f"{metric.lower()}_{arm.lower()}"])
