"""Carry the JAX package's flax parameters over to the port's modules.

The flax ``params`` tree arrives as nested dicts of numpy arrays. Each leaf
maps by name onto the port's module of the same dotted path:

- ``nn.Conv2d``: HWIO ``kernel`` -> OIHW ``weight``;
- ``nn.Linear``: Dense (in, out) ``kernel`` -> (out, in) ``weight``;
- anything else (GroupNorm32, and the GNParams / DenseParams holders of the
  fused AttentionBlock, sdeflow_tpu/models/unet2d.py:157-195, 245-250)
  keeps flax's names and layout.

A flax leaf without a torch counterpart, a torch parameter without a flax
leaf, or a shape mismatch raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(params, model: nn.Module) -> dict:
    """The state dict of `model` built from the flax tree `params` (the
    ``params`` collection itself, or variables holding only it)."""
    if set(params) == {"params"}:
        params = params["params"]
    modules = dict(model.named_modules())
    expected = model.state_dict()
    out = {}
    for path, leaf in _leaves(params):
        *mod_path, name = path
        where = "/".join(path)
        mod = modules.get(".".join(mod_path))
        arr = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if isinstance(mod, (nn.Conv2d, nn.Linear)) and name == "kernel":
            name = "weight"
            arr = arr.permute(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        key = ".".join((*mod_path, name))
        if mod is None or key not in expected:
            raise KeyError(f"flax parameter {where} has no torch counterpart")
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"{where}: shape {tuple(arr.shape)} != torch "
                             f"{key} {tuple(expected[key].shape)}")
        out[key] = arr.contiguous()
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"torch parameters with no flax counterpart: {missing}")
    return out


def load_flax_params(model: nn.Module, params) -> nn.Module:
    """Overwrite `model`'s parameters, on their device, with the flax tree
    `params`."""
    model.load_state_dict(flax_to_state_dict(params, model))
    return model
