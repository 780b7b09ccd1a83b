"""Score networks."""

from sdeflow_tpu_torch.models.dit import DiT1D, DiT2D, DiTBlock
from sdeflow_tpu_torch.models.mlp import MLP
from sdeflow_tpu_torch.models.unet1d import UNet1D
from sdeflow_tpu_torch.models.unet2d import UNetModel
from sdeflow_tpu_torch.models.vorticity import VorticityUNet

__all__ = ["DiT1D", "DiT2D", "DiTBlock", "MLP", "UNet1D", "UNetModel",
           "VorticityUNet"]
