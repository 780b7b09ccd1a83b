"""Typed experiment configuration and every named preset.

Port of sdeflow_tpu/configs.py (TrainConfig, SweepConfig, DataConfig,
PlotConfig, ExperimentConfig with its ``debug`` shrink, and all 23
presets, :20-563), with the fields the presets set and the driver, the
serve and the training paths of the MSGM and SGM arms read; each keeps
the JAX default. ``_grf(npixel)`` takes any square image, as the JAX one
does (``_grf(128)`` is the SGM DSM slice's configuration). Every preset
also resolves with the ``_dbg`` suffix. The JAX package's
``steps_per_dispatch`` (its ``lax.scan`` dispatch of several train steps)
has no counterpart: the Trainer takes one step at a time (a CUDA graph of
the step is ROADMAP Queue 1 item 17).
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
    print_ram: bool = False  # log memory_report() at each print
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
    emb_dim: int = 128  # UNet1D's time embedding width
    # the DiT score nets (nn_archi "DiT" and "DiT2D", models/dit.py)
    dit_patch: int = 16
    dit_width: int = 512
    dit_depth: int = 6
    dit_heads: int = 4


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
    eval_nll: bool = False  # exact PF-ODE NLL of each trained arm
    nll_steps: int = 64
    num_samples: int = 10_000
    include_t0_reverse: bool = True
    Res: Tuple[int, ...] = (300, 3900)  # POD Reynolds numbers
    backward_method: str = "rk4"
    sampler: str = "sde"  # "sde" | "ode" | "dpm" (serving.py)
    corrector_steps: int = 0  # Langevin steps after each predictor step
    snr: float = 0.16
    dpm_grid: str = "logsnr"


@dataclass(frozen=True)
class DataConfig:
    datatype: str = "swissroll"
    dims: Tuple[int, ...] = (2,)
    normalized: bool = True
    mixed_times: bool = False  # a random train/test split (ERA5, POD)
    correlation: bool = True  # gaussian, gaussianCauchy, cauchy
    few_data: bool = False  # train on at most the sweep's ntrain_max rows
    # PIV
    large_image: bool = False
    smoothing: int = 0
    localized: bool = False
    n_dim_l96: int = 100  # the simulated Lorenz-96 system's size
    # ERA5
    season: str = "all"
    use_deseason: bool = False
    era5_variables: Optional[Tuple[str, ...]] = None
    concatenate_re: bool = False  # POD: both Reynolds numbers at once


@dataclass(frozen=True)
class PlotConfig:
    """Plot options; the driver reads all of them (plotting/plots.py)."""

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


def _swissroll():
    return ExperimentConfig(
        name="swissroll",
        data=DataConfig(datatype="swissroll", dims=(2,), normalized=False),
    )


def _gaussian():
    return ExperimentConfig(
        name="gaussian",
        data=DataConfig(datatype="gaussian", dims=(2, 4, 8, 16, 32)),
        plots=PlotConfig(plot_xlim=4.0, val_hist=8.0),
    )


def _gaussian_cauchy():
    return ExperimentConfig(
        name="gaussianCauchy",
        train=TrainConfig(beta_max=2.0),
        data=DataConfig(datatype="gaussianCauchy", dims=(2,)),
        plots=PlotConfig(
            crop_data_plot=True, plot_xlim=5.0, plot_crop=15.0, val_hist=0.4
        ),
    )


def _cauchy():
    return ExperimentConfig(
        name="cauchy",
        train=TrainConfig(
            beta_max=1.0, beta_min=0.01, t_eps=1e-4, num_steps_forward=128
        ),
        data=DataConfig(datatype="cauchy", dims=(4,), correlation=True),
        plots=PlotConfig(
            crop_data_plot=True, plot_xlim=10.0, plot_crop=30.0, val_hist=10.0
        ),
    )


def _lorenz63():
    """The dense-G d = 16 Lorenz-63 regime: β and t_eps divided by 10,
    128 forward steps, a rolling checkpoint, no fair budget."""
    ratio = 10.0
    return ExperimentConfig(
        name="lorenz63",
        train=TrainConfig(
            beta_min=0.1 / ratio,
            beta_max=20.0 / ratio,
            beta_min_sgm=0.1 / ratio,
            beta_max_sgm=20.0 / ratio,
            t_eps=1e-3 / ratio,
            num_steps_forward=128,
            use_checkpoint=True,
        ),
        sweep=SweepConfig(fair_comparison=False),
        data=DataConfig(datatype="lorenz63", dims=(16,)),
        plots=PlotConfig(plot_xlim=4.0, val_hist=8.0, offset_dimplot=8),
    )


def _lorenz63_unet1d():
    """lorenz63 at d = 1000 on UNet1D with a circulant G (sparse tensor),
    16 forward steps."""
    base = _lorenz63()
    return replace(
        base,
        name="lorenz63_unet1d",
        train=replace(base.train, dense_tensor=False, nn_archi="Unet1D",
                      num_steps_forward=16),
        data=replace(base.data, dims=(1000,)),
    )


def _lorenz63_dit():
    """lorenz63_unet1d on the DiT1D score net."""
    base = _lorenz63_unet1d()
    return replace(base, name="lorenz63_dit",
                   train=replace(base.train, nn_archi="DiT"))


def _piv_small():
    """PIV's 4×4 flat mode: β and t_eps divided by 4, at most 1,024 train
    rows."""
    ratio = 4.0
    return ExperimentConfig(
        name="piv_small",
        train=TrainConfig(
            beta_min=0.1 / ratio,
            beta_max=20.0 / ratio,
            beta_min_sgm=0.1 / ratio,
            beta_max_sgm=20.0 / ratio,
            t_eps=1e-3 / ratio,
        ),
        sweep=SweepConfig(ntrain_maxs=(2**10,)),
        data=DataConfig(datatype="piv", dims=(16,), few_data=True,
                        localized=True),
        plots=PlotConfig(plot_xlim=6.0, val_hist=12.0),
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


def _grf_dit(npixel=16):
    """grf on the DiT2D score net: 4×4 patches, 16 tokens at 16×16."""
    cfg = _grf(npixel)
    return replace(
        cfg, name=f"grf{npixel}_dit",
        train=replace(cfg.train, nn_archi="DiT2D", dit_patch=4),
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
    """grf_production on the DiT2D score net (4×4 patches)."""
    cfg = _grf_production(npixel)
    return replace(
        cfg,
        name=f"grf{npixel}_production_dit",
        train=replace(cfg.train, nn_archi="DiT2D", dit_patch=4),
    )


def _pod():
    return ExperimentConfig(
        name="pod",
        data=DataConfig(datatype="pod", dims=(16,), mixed_times=True),
        sweep=SweepConfig(Res=(300, 3900)),
        plots=PlotConfig(val_hist=6.0),
    )


def _era5():
    return ExperimentConfig(
        name="era5",
        data=DataConfig(
            datatype="era5",
            dims=(30,),
            normalized=False,
            era5_variables=(
                "10m_u_component_of_wind",
                "10m_v_component_of_wind",
                "vorticity",
            ),
        ),
        plots=PlotConfig(plot_xlim=5.0, val_hist=10.0),
    )


def _era5temp():
    return ExperimentConfig(
        name="era5temp",
        data=DataConfig(
            datatype="era5temp",
            dims=(10,),
            normalized=False,
            use_deseason=True,
            era5_variables=("2m_temperature",),
        ),
        plots=PlotConfig(plot_xlim=5.0, val_hist=10.0),
    )


def _era5vorttemp():
    return ExperimentConfig(
        name="era5vorttemp",
        train=TrainConfig(beta_max=5.0, beta_max_sgm=5.0),
        data=DataConfig(
            datatype="era5vorttemp",
            dims=(16,),
            normalized=False,
            season="winter",
            use_deseason=True,
            mixed_times=True,
            era5_variables=("2m_temperature", "vorticity"),
        ),
        plots=PlotConfig(plot_xlim=5.0, val_hist=10.0),
    )


def _lorenz96():
    return ExperimentConfig(
        name="lorenz96",
        data=DataConfig(datatype="lorenz96", dims=(8,)),
        plots=PlotConfig(plot_xlim=4.0, val_hist=8.0),
    )


def _eof_pressure():
    return ExperimentConfig(
        name="eof_pressure",
        data=DataConfig(datatype="eof_pressure", dims=(8,), normalized=False),
        plots=PlotConfig(plot_xlim=5.0, val_hist=10.0),
    )


def _weather_station():
    return ExperimentConfig(
        name="weather_station",
        data=DataConfig(datatype="weather_station", dims=(30,)),
        plots=PlotConfig(plot_xlim=5.0, val_hist=10.0),
    )


def _ncar():
    return ExperimentConfig(
        name="ncar",
        data=DataConfig(datatype="ncar", dims=(90,), normalized=False),
        plots=PlotConfig(plot_xlim=5.0, val_hist=10.0),
    )


PRESETS = {
    "swissroll": _swissroll,
    "gaussian": _gaussian,
    "gaussianCauchy": _gaussian_cauchy,
    "cauchy": _cauchy,
    "lorenz63": _lorenz63,
    "lorenz63_unet1d": _lorenz63_unet1d,
    "lorenz63_dit": _lorenz63_dit,
    "piv_small": _piv_small,
    "piv16": lambda: _piv_large(16),
    "piv32": lambda: _piv_large(32),
    "grf16": lambda: _grf(16),
    "grf32": lambda: _grf(32),
    "grf16_dit": lambda: _grf_dit(16),
    "grf16_production": lambda: _grf_production(16),
    "grf16_production_dit": lambda: _grf_production_dit(16),
    "pod": _pod,
    "era5": _era5,
    "era5temp": _era5temp,
    "era5vorttemp": _era5vorttemp,
    "lorenz96": _lorenz96,
    "eof_pressure": _eof_pressure,
    "weather_station": _weather_station,
    "ncar": _ncar,
}


def get_preset(name: str) -> ExperimentConfig:
    """Resolve a preset; a "_dbg" suffix applies the debug shrink."""
    dbg = name.endswith("_dbg")
    base = name[: -len("_dbg")] if dbg else name
    if base not in PRESETS:
        raise KeyError(f"unknown preset {base!r}; available: {sorted(PRESETS)}")
    cfg = PRESETS[base]()
    return cfg.debug() if dbg else cfg
