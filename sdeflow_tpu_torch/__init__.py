"""sdeflow_tpu_torch: the PyTorch and CUDA port of sdeflow_tpu.

The JAX package ``sdeflow_tpu`` is the reference; this package imports
nothing of it and no JAX. Ported so far: the grf16 MSGM sampling path
(SmoothedGRF data, the circulant MSGM SDE, the VorticityUNet score net, the
plug-in reverse SDE and the EM/Heun/RK4 solve) with two hand-written CUDA
kernels, the circulant stencil (K1) and the fused AttentionBlock (K3).
Entry points run on CUDA unless called with ``device="cpu"``.
"""

from sdeflow_tpu_torch.configs import get_preset
from sdeflow_tpu_torch.experiments.driver import build_msgm_arm, make_model
from sdeflow_tpu_torch.models import UNetModel, VorticityUNet
from sdeflow_tpu_torch.ops.integrators import integrate_sde
from sdeflow_tpu_torch.sde import MSGMSde, PluginReverseSDE
from sdeflow_tpu_torch.serving import make_sampler_fn

__all__ = [
    "MSGMSde", "PluginReverseSDE", "UNetModel", "VorticityUNet",
    "build_msgm_arm", "get_preset", "integrate_sde", "make_model",
    "make_sampler_fn",
]
