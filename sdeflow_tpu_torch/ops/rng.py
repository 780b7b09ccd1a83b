"""Derived random streams.

The JAX package splits and folds explicit keys (``jax.random.fold_in``);
PyTorch draws from stateful ``torch.Generator``s. ``fold_in`` is the
counterpart: a new generator whose seed is a hash of a generator's current
state and an integer, leaving that generator where it was. Streams folded
from one state with different integers are independent; folding the same
state with the same integer gives the same stream again.
"""

from __future__ import annotations

import hashlib

import torch


def fold_seed(generator: torch.Generator, data: int) -> int:
    """A seed in [0, 2**63) hashed from `generator`'s state and `data`;
    `generator` is not advanced."""
    digest = hashlib.blake2b(
        generator.get_state().numpy().tobytes()
        + int(data).to_bytes(8, "little", signed=True),
        digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A new generator on `generator`'s device seeded with
    ``fold_seed(generator, data)``; `generator` is not advanced."""
    return torch.Generator(device=generator.device).manual_seed(
        fold_seed(generator, data))
