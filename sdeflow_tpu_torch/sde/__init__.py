"""SDEs: the MSGM forward SDE, its forward flow and the plug-in reverse
SDE."""

from sdeflow_tpu_torch.sde.forward import ForwardFlow
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE

__all__ = ["ForwardFlow", "MSGMSde", "PluginReverseSDE"]
