"""Shared SDE helpers: the β(t) schedule and time broadcasting.

Port of sdeflow_tpu/sde/base.py:27-40. The numeric forward perturbation
(``sample_scheme``) comes with the training slice (ROADMAP Queue 1 item 1).
Times are Python numbers or tensors of shape (), (B,) or (B, 1).
"""

from __future__ import annotations

import torch


def beta_linear(t, beta_min, beta_max):
    """Linear noise schedule β(t) = β_min + (β_max − β_min)·t."""
    return beta_min + (beta_max - beta_min) * t


def _tcol(t, y):
    """Broadcast a time against a batch of states: a Python number stays a
    number, a 0-d tensor stays 0-d, a batch of times becomes (B, 1, ...)."""
    if not isinstance(t, torch.Tensor):
        return float(t)
    t = t.to(dtype=y.dtype)
    if t.ndim == 0:
        return t
    return t.reshape(t.shape[0], *([1] * (y.ndim - 1)))
