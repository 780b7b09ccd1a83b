"""sdeflow_tpu_torch: the PyTorch and CUDA port of sdeflow_tpu.

The JAX package ``sdeflow_tpu`` is the reference; this package imports
nothing of it and no JAX. Ported so far: the system's main path on the
toy presets (swissroll, gaussian, gaussianCauchy, cauchy) and the grf
presets, end to end through the experiment driver and its CLI
(``python -m sdeflow_tpu_torch.run``): the synthetic data (SwissRoll,
Gaussian, Cauchy, GaussianCauchy, SmoothedGRF), the MSGM SDE with a dense
or circulant G and an ecdf or KDE radial prior, the VP SGM SDE, the MLP,
VorticityUNet and DiT (DiT1D, DiT2D) score nets, the plug-in
reverse SDE with the SSM loss (its forward RK4 perturbation and Hutchinson
JVP), the DSM loss with the eps parameterization and the debiased time
sampler, the ELBO, Adam, the Trainer with EMA and on-disk checkpoints, the
EM/Heun/RK4 generation solve with its Langevin corrector, the
probability-flow ODE (fixed steps and Dormand–Prince) and DPM-Solver
samplers, the exact PF-ODE likelihood, and scoring by √MMD and sliced
Wasserstein;
with hand-written CUDA kernels for every Pallas kernel of the JAX package:
the circulant stencil (K1), the fused forward RK4 step and solve (K2), the
fused AttentionBlock (K3), GroupNorm and its backward (K5, K5b), the
attention core (K6/K4) and the reverse-mode flash-attention pair
(K7a/K7b). Entry points run on CUDA unless called with ``device="cpu"``.
The names below are imported on first use, so that importing a submodule
(``sdeflow_tpu_torch.serving`` on a serving host) loads only what it
needs.
"""

import importlib

_EXPORTS = {
    "sdeflow_tpu_torch.configs": ["get_preset"],
    "sdeflow_tpu_torch.eval": ["compute_mmd", "evaluate", "filter_blowups",
                               "sliced_wasserstein"],
    "sdeflow_tpu_torch.experiments.driver": [
        "ExperimentDriver", "build_msgm_arm", "build_sgm_arm",
        "fair_budgets", "generate", "make_model", "make_trainer",
        "train_arm", "train_msgm_arm"],
    "sdeflow_tpu_torch.models": ["MLP", "DiT1D", "DiT2D", "UNetModel",
                                 "VorticityUNet"],
    "sdeflow_tpu_torch.ops.integrators": ["integrate_sde",
                                          "integrate_select"],
    "sdeflow_tpu_torch.sde": ["ForwardFlow", "MSGMSde", "PluginReverseSDE",
                              "SGMSde"],
    "sdeflow_tpu_torch.serving": ["Encoder", "Sampler", "export_encoder",
                                  "export_sampler", "make_sampler_fn"],
    "sdeflow_tpu_torch.training": [
        "Trainer", "build_optimizer", "load_checkpoint", "make_train_chunk",
        "make_train_step", "save_checkpoint"],
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_WHERE[name]), name)
