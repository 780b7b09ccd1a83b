"""Plug-in reverse SDE: the generative flow.

Port of sdeflow_tpu/sde/reverse.py for sampling. The learned drift a(y, t)
is any callable ``score_net(y, t) -> (B, d)``, typically an ``nn.Module``.
Only the "direct" parameterization is ported; the losses and the eps
parameterization come with ROADMAP Queue 1 item 1, the ELBO, PF-ODE and
corrector drifts with item 4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


def _trow(t, batch, like):
    """A time as a (B,) row for score-net conditioning."""
    if not isinstance(t, torch.Tensor) or t.ndim == 0:
        return torch.full((batch,), float(t), dtype=like.dtype,
                          device=like.device)
    return t.to(like.dtype).reshape(-1)


@dataclass(frozen=True)
class PluginReverseSDE:
    """Invert a base SDE with drift f and diffusion g via a learned drift a:
    reverse drift g·a − f + ∇·Σ (time inverted), diffusion g. Implements the
    flow protocol of ops/integrators.py."""

    base_sde: Any
    score_net: Callable
    T: float

    @classmethod
    def create(cls, base_sde, score_net, T=None, parameterization="direct"):
        if parameterization != "direct":
            raise NotImplementedError(
                f"parameterization={parameterization!r}: ROADMAP Queue 1 "
                "item 1 (training slice)")
        return cls(base_sde=base_sde, score_net=score_net,
                   T=float(base_sde.T if T is None else T))

    # -- learned drift --------------------------------------------------------
    def score(self, y, t):
        """a(y, t), with t as a (B,) row, cast back to y's dtype."""
        return self.score_net(y, _trow(t, y.shape[0], y)).to(y.dtype)

    def ga(self, s, y):
        """g(s, y)·a(y, s)."""
        return self.base_sde.sigma_apply(s, y, self.score(y, s))

    # -- flow protocol (reverse direction) -------------------------------------
    def ga_m_drift(self, s, y, lmbd=0.0):
        """(1−λ/2)·g·a − f + (1−λ)·∇·Σ."""
        return ((1.0 - 0.5 * lmbd) * self.ga(s, y) - self.base_sde.f(s, y)
                + (1.0 - lmbd) * self.base_sde.div_sigma(s, y))

    def mu(self, t, y, lmbd=0.0):
        """Itô reverse drift, time-inverted."""
        return self.ga_m_drift(self.T - t, y, lmbd)

    def mu_strato(self, t, y, lmbd=0.0):
        return self.mu(t, y, lmbd) - 0.5 * (1.0 - lmbd) * (
            self.base_sde.div_sigma(self.T - t, y))

    def sigma_apply(self, t, y, w, lmbd=0.0):
        """σ(t)·w = √(1−λ)·g(T−t, y)·w."""
        return (1.0 - lmbd) ** 0.5 * self.base_sde.sigma_apply(
            self.T - t, y, w)

    # -- latent sampling -------------------------------------------------------
    def latent_sample(self, generator, num_samples, n=None):
        return self.base_sde.latent_sample(generator, num_samples, n)
