"""Host-side diagnostics of generated samples.

Port of ``filter_blowups`` (sdeflow_tpu/eval/diagnostics.py:53-62). The
forward-convergence statistics come with ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import numpy as np
import torch


def filter_blowups(x, threshold=1e3):
    """Drop the rows holding a NaN, an inf or an entry with |x| > threshold
    before the metrics. Host-side (the kept count depends on the data);
    returns (the kept rows as a numpy array, the number dropped)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    bad = (~np.isfinite(x)).any(axis=1) | (np.abs(x) > threshold).any(axis=1)
    return x[~bad], int(bad.sum())
