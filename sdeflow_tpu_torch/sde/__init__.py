"""SDEs: the MSGM and SGM forward SDEs, their forward flow and the plug-in
reverse SDE."""

from sdeflow_tpu_torch.sde.forward import ForwardFlow
from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE
from sdeflow_tpu_torch.sde.sgm import SGMSde

__all__ = ["ForwardFlow", "MSGMSde", "PluginReverseSDE", "SGMSde"]
