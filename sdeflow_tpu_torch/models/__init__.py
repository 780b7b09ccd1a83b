"""Score networks."""

from sdeflow_tpu_torch.models.unet2d import UNetModel
from sdeflow_tpu_torch.models.vorticity import VorticityUNet

__all__ = ["UNetModel", "VorticityUNet"]
