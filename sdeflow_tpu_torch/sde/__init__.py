"""SDEs: the MSGM forward SDE and the plug-in reverse SDE."""

from sdeflow_tpu_torch.sde.msgm import MSGMSde
from sdeflow_tpu_torch.sde.reverse import PluginReverseSDE

__all__ = ["MSGMSde", "PluginReverseSDE"]
