"""Typed experiment configuration and the grf preset chain.

Port of sdeflow_tpu/configs.py (TrainConfig, SweepConfig, DataConfig,
PlotConfig, ExperimentConfig with its ``debug`` shrink, and the
``_piv_large`` → ``_grf`` → ``_grf_production`` chain, :95-205,
318-359, 375-416, 558-565), with the fields that chain sets and the
driver, the serve and the training paths of the MSGM and SGM arms read;
each keeps the JAX default. ``_grf(npixel)`` takes any square image, as the
JAX one does (``_grf(128)`` is the SGM DSM slice's configuration); grf16,
grf32 and grf16_production are the registered presets, each also with the
``_dbg`` suffix. The JAX package's ``steps_per_dispatch`` (its ``lax.scan``
dispatch of several train steps) has no counterpart: the Trainer takes one
step at a time (a CUDA graph of the step is ROADMAP Queue 1 item 17).
grf16_production_dit waits for the DiT score net (item 11); the other
presets come with item 13; the plot options are carried as data, and only
``save_results`` is read (the plots come with item 13).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class TrainConfig:
    T0: float = 1.0
    beta_min: float = 0.1
    beta_max: float = 20.0
    beta_min_sgm: float = 0.1
    beta_max_sgm: float = 20.0
    t_eps: float = 1e-3
    norm_sampler: str = "ecdf"
    norm_map: Optional[str] = "log"
    dense_tensor: bool = True
    nn_archi: str = "MLP"  # MLP | Unet | Unet1D | DiT | DiT2D
    compute_dtype: str = "float32"
    parameterization: str = "direct"  # "eps": SGM arms only
    num_samples_init_max: int = 100_000
    vtype: str = "rademacher"
    lr: float = 1e-3
    grad_clip: Optional[float] = None
    weight_decay: float = 0.0
    lr_warmup_steps: int = 0
    print_every: int = 10_000
    save_every: int = 100_000  # tagged on-disk checkpoints
    use_checkpoint: bool = False  # rolling on-disk checkpoint, resumed
    ema_rate: Optional[float] = None
    ema_warmup: bool = True
    num_steps_forward: int = 16
    base_channels: int = 32
    channel_mults: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (2, 4)
    attention_impl: str = "auto"


@dataclass(frozen=True)
class SweepConfig:
    msgms: Tuple[int, ...] = (0, 1)  # 0 = SGM arm, 1 = MSGM arm
    ntrain_maxs: Tuple[float, ...] = (np.inf,)
    iterationss: Tuple[int, ...] = (2**20,)
    num_stepss_backward: Tuple[int, ...] = (128,)
    batch_sizes: Tuple[int, ...] = (256,)
    nruns_mmd: int = 1
    fair_comparison: bool = True
    ssm_intT_ref: bool = False
    eval_mmd: bool = False
    eval_nll: bool = False  # exact NLL: ROADMAP Queue 1 item 10
    nll_steps: int = 64
    num_samples: int = 10_000
    include_t0_reverse: bool = True
    Res: Tuple[int, ...] = (300, 3900)  # POD Reynolds numbers
    backward_method: str = "rk4"
    sampler: str = "sde"  # "ode", "dpm": ROADMAP Queue 1 item 10
    corrector_steps: int = 0  # Langevin steps after each predictor step
    snr: float = 0.16
    dpm_grid: str = "logsnr"


@dataclass(frozen=True)
class DataConfig:
    datatype: str = "swissroll"
    dims: Tuple[int, ...] = (2,)
    normalized: bool = True
    large_image: bool = False
    smoothing: int = 0


@dataclass(frozen=True)
class PlotConfig:
    """Plot options, carried as data; the driver reads ``save_results``
    (the plots come with ROADMAP Queue 1 item 13)."""

    scatter_plots: bool = True
    noising_plots: bool = True
    denoising_plots: bool = True
    save_results: bool = True
    plot_xlim: float = 3.0
    val_hist: float = 3.0
    crop_data_plot: bool = False
    plot_crop: float = 3.0
    log_scale_pdf: bool = True
    plot_ref_pdf: bool = False
    dimplot_max: int = 4
    offset_dimplot: int = 0
    dpi: int = 200
    height_seaborn: float = 1.0


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "swissroll"
    train: TrainConfig = field(default_factory=TrainConfig)
    sweep: SweepConfig = field(default_factory=SweepConfig)
    data: DataConfig = field(default_factory=DataConfig)
    plots: PlotConfig = field(default_factory=PlotConfig)
    results_dir: str = "results"
    seed: int = 0

    def debug(self) -> "ExperimentConfig":
        """The smoke-run shrink of a preset (the ``_dbg`` suffix)."""
        return replace(
            self,
            name=self.name + "_dbg",
            sweep=replace(
                self.sweep,
                iterationss=(16, 8),
                num_stepss_backward=(4, 8),
                num_samples=10,
                nruns_mmd=1,
                ntrain_maxs=(2**2, 2**4),
                batch_sizes=(2,),
            ),
            train=replace(self.train, num_steps_forward=10, print_every=8),
        )


def _piv_large(npixel=32):
    ratio = 1 / 4 if npixel == 16 else 1 / 8
    return ExperimentConfig(
        name=f"piv{npixel}",
        train=TrainConfig(
            beta_min=0.1 / ratio,
            beta_max=20.0 / ratio,
            t_eps=1e-3 / ratio,
            num_steps_forward=int(16 / ratio),
            dense_tensor=False,
            nn_archi="Unet",
            lr=1e-4,
            use_checkpoint=True,
        ),
        sweep=SweepConfig(
            fair_comparison=False,
            iterationss=(100_000,),
            batch_sizes=(128,),
            num_stepss_backward=(2048, 512, 128, 32, 16),
        ),
        data=DataConfig(
            datatype="piv", dims=(npixel**2,), large_image=True, smoothing=2
        ),
        plots=PlotConfig(
            plot_xlim=6.0, val_hist=24.0, offset_dimplot=npixel**2 // 2
        ),
    )


def _grf(npixel=16):
    """The piv16/32 image config on the synthetic SmoothedGRF data."""
    cfg = _piv_large(npixel)
    return replace(
        cfg, name=f"grf{npixel}",
        data=DataConfig(datatype="grf", dims=(npixel**2,), smoothing=2),
    )


def _grf_production(npixel=16):
    """The production image preset (sdeflow_tpu/configs.py:375-416): bf16
    compute in the score net (fp32 parameters, Adam state and loss),
    parameter EMA 0.999 with warmup, the eps output on the SGM arm (the
    driver keeps MSGM direct), and predictor–corrector sampling: EM at 32
    steps plus one Langevin corrector step."""
    cfg = _grf(npixel)
    return replace(
        cfg,
        name=f"grf{npixel}_production",
        train=replace(cfg.train, compute_dtype="bfloat16", ema_rate=0.999,
                      parameterization="eps"),
        sweep=replace(cfg.sweep, sampler="sde", backward_method="em",
                      corrector_steps=1, num_stepss_backward=(32,)),
    )


def _grf_production_dit(npixel=16):
    raise NotImplementedError(
        f"grf{npixel}_production_dit: the DiT2D score net, ROADMAP Queue 1 "
        "item 11")


PRESETS = {
    "grf16": lambda: _grf(16),
    "grf32": lambda: _grf(32),
    "grf16_production": lambda: _grf_production(16),
    "grf16_production_dit": lambda: _grf_production_dit(16),
}


def get_preset(name: str) -> ExperimentConfig:
    """Resolve a preset; a "_dbg" suffix applies the debug shrink."""
    dbg = name.endswith("_dbg")
    base = name[: -len("_dbg")] if dbg else name
    if base not in PRESETS:
        raise NotImplementedError(
            f"preset {base!r}: ported presets are {sorted(PRESETS)}; the "
            "rest come with ROADMAP Queue 1 item 13")
    cfg = PRESETS[base]()
    return cfg.debug() if dbg else cfg
