"""Typed experiment configuration and the grf preset chain.

Port of sdeflow_tpu/configs.py (TrainConfig, SweepConfig, DataConfig,
ExperimentConfig and the ``_piv_large`` → ``_grf`` chain, :318-359), with
the fields that chain sets and the serve and training paths of the MSGM
and SGM arms read; each keeps the JAX default. ``_grf(npixel)`` takes any
square image, as the JAX one does (``_grf(128)`` is the SGM DSM slice's
configuration); only grf16 and grf32 are registered presets. The other
presets and the plot options come with ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


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
    save_every: int = 100_000  # on-disk checkpoints (Queue 1 item 12)
    use_checkpoint: bool = False  # on-disk checkpoints (Queue 1 item 12)
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
    iterationss: Tuple[int, ...] = (2**20,)
    num_stepss_backward: Tuple[int, ...] = (128,)
    batch_sizes: Tuple[int, ...] = (256,)
    fair_comparison: bool = True
    ssm_intT_ref: bool = False
    backward_method: str = "rk4"


@dataclass(frozen=True)
class DataConfig:
    datatype: str = "swissroll"
    dims: Tuple[int, ...] = (2,)
    large_image: bool = False
    smoothing: int = 0


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "swissroll"
    train: TrainConfig = field(default_factory=TrainConfig)
    sweep: SweepConfig = field(default_factory=SweepConfig)
    data: DataConfig = field(default_factory=DataConfig)
    seed: int = 0


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
    )


def _grf(npixel=16):
    """The piv16/32 image config on the synthetic SmoothedGRF data."""
    cfg = _piv_large(npixel)
    return replace(
        cfg, name=f"grf{npixel}",
        data=DataConfig(datatype="grf", dims=(npixel**2,), smoothing=2),
    )


PRESETS = {
    "grf16": lambda: _grf(16),
    "grf32": lambda: _grf(32),
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise NotImplementedError(
            f"preset {name!r}: ported presets are {sorted(PRESETS)}; the "
            "rest come with ROADMAP Queue 1 item 13")
    return PRESETS[name]()
