"""Model factory and the MSGM and SGM arms of the experiment driver.

Port of ``make_model``'s Unet branch, of ``ExperimentDriver._build_arm``
(both halves), of ``_fair_budgets`` and of the training half of
``_run_arm`` for the MSGM arm (sdeflow_tpu/experiments/driver.py:149-182,
265-319, 425-506). The other score nets, the sweep with its sampling and
plots come with ROADMAP Queue 1 items 11 and 13.
"""

from __future__ import annotations

import math

from sdeflow_tpu_torch.configs import ExperimentConfig
from sdeflow_tpu_torch.data.synthetic import SmoothedGRF
from sdeflow_tpu_torch.models.vorticity import VorticityUNet
from sdeflow_tpu_torch.ops.kernels.common import resolve_device
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde
from sdeflow_tpu_torch.training.train import Trainer


def make_model(cfg: ExperimentConfig, dim, premodule, device="cuda"):
    """The score net of `cfg` on `device` (random weights); its
    AttentionBlocks take ``cfg.train.attention_impl`` ("auto" or
    "unfused"; "ring" raises)."""
    tc = cfg.train
    if tc.nn_archi != "Unet":
        raise NotImplementedError(
            f"nn_archi={tc.nn_archi!r}: ROADMAP Queue 1 items 5 and 11")
    if tc.compute_dtype not in ("float32", "fp32"):
        raise NotImplementedError(
            f"compute_dtype={tc.compute_dtype!r}: float32 only (ROADMAP "
            "Queue 1 item 8)")
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
        attention_impl=tc.attention_impl,
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
    SDE of the MSGM arm (ssm_intT from the sweep's ssm_intT_ref): the
    radial prior comes from `num_samples_init` data samples (default: the
    JAX driver's min(num_samples_init_max, iterations·batch))."""
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


def make_trainer(cfg: ExperimentConfig, gen, sampler, batch_size,
                 log_fn=print):
    """The arm's Trainer with the config's optimizer, cadence and EMA, as
    the JAX driver builds it. No on-disk checkpoints: ``use_checkpoint``
    (ROADMAP Queue 1 item 12) is logged and skipped."""
    tc = cfg.train
    if tc.use_checkpoint:
        log_fn("use_checkpoint: on-disk checkpoints are not ported yet "
               "(ROADMAP Queue 1 item 12); training without them")
    return Trainer(
        gen, sampler, lr=tc.lr, batch_size=batch_size, loss="ssm",
        print_every=tc.print_every, log_fn=log_fn, ema_rate=tc.ema_rate,
        ema_warmup=tc.ema_warmup, grad_clip=tc.grad_clip,
        weight_decay=tc.weight_decay, lr_warmup_steps=tc.lr_warmup_steps)


def train_msgm_arm(cfg: ExperimentConfig, generator, *, iterations=None,
                   arm=None, x_test=None, device="cuda", log_fn=print):
    """Train the MSGM arm of `cfg` as the JAX driver's _run_arm does: fair
    budgets from the sweep's first iterations and batch size, the arm
    (``build_msgm_arm`` unless `arm` = (model, gen) is given), the Trainer,
    and ELBO prints on the first 1000 test samples (drawn from the data
    sampler unless given). `iterations` overrides the fair budget.
    Returns (trainer, the trained gen — over the EMA weights when the
    config sets ema_rate — and the last loss)."""
    sw = cfg.sweep
    dim = cfg.data.dims[0]
    batch_size, fair_iterations = fair_budgets(
        cfg, True, sw.ssm_intT_ref, dim, sw.batch_sizes[0],
        sw.iterationss[0], log_fn)
    iterations = fair_iterations if iterations is None else int(iterations)
    sampler = make_data_sampler(cfg, dim, device)
    if arm is None:
        arm = build_msgm_arm(cfg, generator, dim, num_samples_init=int(min(
            cfg.train.num_samples_init_max, fair_iterations * batch_size)),
            device=device)
    _, gen = arm
    if x_test is None:
        x_test = sampler.sample(generator, 1000)
    log_fn(f"name_SDE = {gen.base_sde.name}  iterations = {iterations}  "
           f"batch_size = {batch_size}  ssm_intT = {gen.ssm_intT}")
    trainer = make_trainer(cfg, gen, sampler, batch_size, log_fn)
    state, loss = trainer.run(generator, iterations, x_test=x_test[:1000])
    # with ema_rate, sampling and evaluation use the averaged weights
    gen = trainer.ema_gen_sde if cfg.train.ema_rate else state.gen_sde
    return trainer, gen, loss
