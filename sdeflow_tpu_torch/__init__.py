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
"""

from sdeflow_tpu_torch.configs import get_preset
from sdeflow_tpu_torch.eval import (
    compute_mmd, evaluate, filter_blowups, sliced_wasserstein)
from sdeflow_tpu_torch.experiments.driver import (
    ExperimentDriver, build_msgm_arm, build_sgm_arm, fair_budgets, generate,
    make_model, make_trainer, train_arm, train_msgm_arm)
from sdeflow_tpu_torch.models import (
    MLP, DiT1D, DiT2D, UNetModel, VorticityUNet)
from sdeflow_tpu_torch.ops.integrators import integrate_sde, integrate_select
from sdeflow_tpu_torch.sde import (
    ForwardFlow, MSGMSde, PluginReverseSDE, SGMSde)
from sdeflow_tpu_torch.serving import make_sampler_fn
from sdeflow_tpu_torch.training import (
    Trainer, build_optimizer, load_checkpoint, make_train_chunk,
    make_train_step, save_checkpoint)

__all__ = [
    "DiT1D", "DiT2D", "MLP", "ExperimentDriver", "ForwardFlow", "MSGMSde", "PluginReverseSDE",
    "SGMSde", "Trainer", "UNetModel", "VorticityUNet", "build_msgm_arm",
    "build_optimizer", "build_sgm_arm", "compute_mmd", "evaluate",
    "fair_budgets", "filter_blowups", "generate", "get_preset",
    "integrate_sde", "integrate_select", "load_checkpoint", "make_model",
    "make_sampler_fn", "make_train_chunk", "make_train_step", "make_trainer",
    "save_checkpoint", "sliced_wasserstein", "train_arm", "train_msgm_arm",
]
