"""Model factory and the MSGM arm of the experiment driver.

Port of ``make_model``'s Unet branch and of the MSGM half of
``ExperimentDriver._build_arm`` (sdeflow_tpu/experiments/driver.py:149-182,
284-319). Training, the SGM arm, the other score nets and the sweep come
with ROADMAP Queue 1 items 1, 2, 11 and 13.
"""

from __future__ import annotations

from sdeflow_tpu_torch.configs import ExperimentConfig
from sdeflow_tpu_torch.data.synthetic import SmoothedGRF
from sdeflow_tpu_torch.models.vorticity import VorticityUNet
from sdeflow_tpu_torch.ops.kernels.common import resolve_device
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE


def make_model(cfg: ExperimentConfig, dim, premodule, device="cuda"):
    """The score net of `cfg` on `device` (random weights)."""
    tc = cfg.train
    if tc.nn_archi != "Unet":
        raise NotImplementedError(
            f"nn_archi={tc.nn_archi!r}: ROADMAP Queue 1 items 5 and 11")
    if tc.compute_dtype not in ("float32", "fp32"):
        raise NotImplementedError(
            f"compute_dtype={tc.compute_dtype!r}: float32 only (ROADMAP "
            "Queue 1 item 8)")
    if tc.attention_impl != "auto":
        raise NotImplementedError(
            f"attention_impl={tc.attention_impl!r}: ROADMAP Queue 1 items "
            "8 and 14")
    npixel = int(round(dim**0.5))
    if dim != npixel**2:
        raise ValueError(f"Incorrect dim to define square image: {dim}")
    return VorticityUNet(
        base_channels=tc.base_channels,
        channel_mults=tc.channel_mults,
        num_res_blocks=tc.num_res_blocks,
        premodule=premodule,
        in_space=npixel,
        attention_resolutions=tc.attention_resolutions,
        flatten_order="F",
    ).to(resolve_device(device))


def make_data_sampler(cfg: ExperimentConfig, dim, device="cuda"):
    if cfg.data.datatype != "grf":
        raise NotImplementedError(
            f"datatype={cfg.data.datatype!r}: ROADMAP Queue 1 items 6, 13")
    return SmoothedGRF(npixel=int(round(dim**0.5)),
                       ell=float(cfg.data.smoothing or 2), device=device)


def build_msgm_arm(cfg: ExperimentConfig, generator, dim=None,
                   num_samples_init=None, device="cuda"):
    """Score net (random weights from the caller's seed) and the reverse
    SDE of the MSGM arm: the radial prior comes from `num_samples_init`
    data samples (default: the JAX driver's min(num_samples_init_max,
    iterations·batch))."""
    tc, sw = cfg.train, cfg.sweep
    dim = cfg.data.dims[0] if dim is None else dim
    if num_samples_init is None:
        num_samples_init = int(min(tc.num_samples_init_max,
                                   sw.iterationss[0] * sw.batch_sizes[0]))
    model = make_model(cfg, dim, "NormalizeLogRadius", device=device)
    x_init = make_data_sampler(cfg, dim, device).sample(generator,
                                                        num_samples_init)
    sde = MSGMSde.create(
        x_init, beta_min=tc.beta_min, beta_max=tc.beta_max, T=tc.T0,
        t_epsilon=tc.t_eps, num_steps_forward=tc.num_steps_forward,
        dense_tensor=tc.dense_tensor, norm_sampler=tc.norm_sampler,
        norm_map=tc.norm_map)
    return model, PluginReverseSDE.create(sde, model)
