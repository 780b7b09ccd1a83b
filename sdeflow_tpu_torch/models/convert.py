"""Carry the JAX package's flax parameters over to the port's modules.

The flax ``params`` tree arrives as nested dicts of numpy arrays. Each leaf
maps by name onto the port's module of the same dotted path:

- ``nn.Conv1d``, ``nn.Conv2d``, ``nn.Conv3d``: WIO, HWIO or DHWIO
  ``kernel`` -> OIW, OIHW or OIDHW ``weight``;
- ``nn.Linear``: Dense (in, out) ``kernel`` -> (out, in) ``weight``;
- ``nn.Embedding``: Embed ``embedding`` -> ``weight``, the same layout;
- anything else (GroupNorm32, and the DenseParams holders of the
  AttentionBlock, sdeflow_tpu/models/unet2d.py:157-195, 245-250) keeps
  flax's names and layout.

A flax leaf without a torch counterpart, a torch parameter without a flax
leaf, or a shape mismatch raises. ``state_dict_to_flax`` is the inverse
map, for parameters or their gradients.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)


def _to_torch(mod, name, arr):
    """(torch name, array) of the flax leaf `name` of `mod`."""
    if isinstance(mod, (*_CONVS, nn.Linear)) and name == "kernel":
        # (*spatial, I, O) -> (O, I, *spatial); Dense (in, out) -> (out, in)
        n = arr.ndim
        return "weight", arr.permute(n - 1, n - 2, *range(n - 2))
    if isinstance(mod, nn.Embedding) and name == "embedding":
        return "weight", arr
    return name, arr


def _to_flax(mod, name, arr):
    """The inverse of ``_to_torch``."""
    if isinstance(mod, (*_CONVS, nn.Linear)) and name == "weight":
        n = arr.ndim
        return "kernel", arr.permute(*range(2, n), 1, 0)
    if isinstance(mod, nn.Embedding) and name == "weight":
        return "embedding", arr
    return name, arr


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
        name, arr = _to_torch(mod, name, arr)
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


def state_dict_to_flax(tensors, model: nn.Module) -> dict:
    """The flax-shaped tree (nested dicts of float32 numpy arrays) of
    `tensors`, a dict from `model`'s parameter names to tensors of their
    shapes (the parameters themselves, or their gradients)."""
    modules = dict(model.named_modules())
    tree = {}
    for key, t in tensors.items():
        *mod_path, name = key.split(".")
        mod = modules[".".join(mod_path)]
        name, arr = _to_flax(mod, name, t.detach().to("cpu", torch.float32))
        node = tree
        for part in mod_path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr.numpy())
    return tree
