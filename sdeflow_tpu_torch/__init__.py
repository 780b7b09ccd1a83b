"""sdeflow_tpu_torch: the PyTorch and CUDA port of sdeflow_tpu.

The JAX package ``sdeflow_tpu`` is the reference; this package imports
nothing of it and no JAX. Ported so far: the grf16 MSGM sampling path
(SmoothedGRF data, the circulant MSGM SDE, the VorticityUNet score net, the
plug-in reverse SDE and the EM/Heun/RK4 solve), its training path (the
forward RK4 perturbation, the SSM loss with its Hutchinson JVP, the ELBO,
Adam and the Trainer), and the SGM arm's denoising-score-matching training
(the VP SDE, the DSM loss, the eps parameterization and the debiased time
sampler), with hand-written CUDA kernels for every Pallas kernel of the
JAX package: the circulant stencil (K1), the fused forward RK4 step (K2),
the fused AttentionBlock (K3), GroupNorm (K5), the attention core (K6/K4)
and the reverse-mode flash-attention pair (K7a/K7b). Entry points run on
CUDA unless called with ``device="cpu"``.
"""

from sdeflow_tpu_torch.configs import get_preset
from sdeflow_tpu_torch.eval.elbo import evaluate
from sdeflow_tpu_torch.experiments.driver import (
    build_msgm_arm, build_sgm_arm, fair_budgets, make_model, make_trainer,
    train_msgm_arm)
from sdeflow_tpu_torch.models import UNetModel, VorticityUNet
from sdeflow_tpu_torch.ops.integrators import integrate_sde, integrate_select
from sdeflow_tpu_torch.sde import (
    ForwardFlow, MSGMSde, PluginReverseSDE, SGMSde)
from sdeflow_tpu_torch.serving import make_sampler_fn
from sdeflow_tpu_torch.training import (
    Trainer, build_optimizer, make_train_chunk, make_train_step)

__all__ = [
    "ForwardFlow", "MSGMSde", "PluginReverseSDE", "SGMSde", "Trainer",
    "UNetModel", "VorticityUNet", "build_msgm_arm", "build_optimizer",
    "build_sgm_arm", "evaluate",
    "fair_budgets", "get_preset", "integrate_sde", "integrate_select",
    "make_model", "make_sampler_fn", "make_train_chunk", "make_train_step",
    "make_trainer", "train_msgm_arm",
]
