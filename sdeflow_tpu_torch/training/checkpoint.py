"""Checkpoint and resume, with the random stream captured.

Port of sdeflow_tpu/training/checkpoint.py:23-134 in the port's own format
(one ``torch.save`` file; it does not read the JAX package's orbax
directories). A checkpoint holds what resuming needs to continue the same
run: the score net's and the optimizer's state dicts, the EMA parameters,
the step count, the generator's state, the iteration, and the base SDE's
tensors (MSGM's sorted ``r_T`` radii and the KDE constants of its radial
prior), which a resumed run must not rebuild from fresh data draws: that
would change the latent law. ``r_T`` is sorted again at restore, as the
JAX package does (:110-124). Serving export (``torch.export``) comes with
ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import dataclasses
import os

import torch


def _abs(path):
    return os.path.abspath(path)


def checkpoint_exists(path) -> bool:
    return os.path.isfile(_abs(path))


def _sde_tensors(sde):
    return {f.name: getattr(sde, f.name) for f in dataclasses.fields(sde)
            if isinstance(getattr(sde, f.name), torch.Tensor)}


def save_checkpoint(path, state, generator, iteration, optimizer=None):
    """Save the train state, the optimizer, the generator's state and the
    iteration to the file `path` (written beside it, then renamed into
    place, so a run cut during the save keeps the previous checkpoint)."""
    gen = state.gen_sde
    payload = dict(
        score_net=gen.score_net.state_dict(),
        optimizer=None if optimizer is None else optimizer.state_dict(),
        ema_params=state.ema_params,
        step=int(state.step),
        base_sde=_sde_tensors(gen.base_sde),
        generator=generator.get_state(),
        iteration=int(iteration),
    )
    path = _abs(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_checkpoint(path, state, generator, optimizer=None):
    """Restore a checkpoint into `state` (its score net's parameters, the
    EMA parameters, the step count and the base SDE's tensors), into
    `optimizer` when given and into `generator`'s state; returns
    (state, generator, iteration)."""
    payload = torch.load(_abs(path), map_location="cpu", weights_only=True)
    gen = state.gen_sde
    gen.score_net.load_state_dict(payload["score_net"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    base = gen.base_sde
    tensors = {k: v.to(getattr(base, k).device)
               for k, v in payload["base_sde"].items()}
    if "r_T" in tensors:
        tensors["r_T"] = torch.sort(tensors["r_T"]).values
    if tensors:
        state.gen_sde = dataclasses.replace(
            gen, base_sde=dataclasses.replace(base, **tensors))
    if payload["ema_params"] is not None:
        device = next(gen.score_net.parameters()).device
        state.ema_params = {k: v.to(device)
                            for k, v in payload["ema_params"].items()}
    state.step = payload["step"]
    generator.set_state(payload["generator"])
    return state, generator, payload["iteration"]


def delete_checkpoint(path) -> None:
    """Remove a rolling checkpoint after a fully successful run."""
    if checkpoint_exists(path):
        os.remove(_abs(path))
