"""Shared SDE machinery: the β(t) schedule, time broadcasting and the
numeric forward perturbation.

Port of sdeflow_tpu/sde/base.py:27-156. Times are Python numbers or
tensors of shape (), (B,) or (B, 1). The forward perturbation runs under
``torch.no_grad()``, like the reference's ``@torch.no_grad()`` sampler, and
takes its normal draws from a ``torch.Generator`` unless the caller injects
them. With ``project_training_norms`` (an SDE's opt-in, off by default as
in the reference) each of its steps is re-projected to the state's
starting norm.
"""

from __future__ import annotations

import math

import torch

from sdeflow_tpu_torch.ops.integrators import (
    _norm_project, integrate_sde, integrate_select, rk4_step)
from sdeflow_tpu_torch.sde.forward import ForwardFlow


def beta_linear(t, beta_min, beta_max):
    """Linear noise schedule β(t) = β_min + (β_max − β_min)·t."""
    return beta_min + (beta_max - beta_min) * t


def _sqrt(v):
    """√v of a tensor or a Python number."""
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _tcol(t, y):
    """Broadcast a time against a batch of states: a Python number stays a
    number, a 0-d tensor stays 0-d, a batch of times becomes (B, 1, ...)."""
    if not isinstance(t, torch.Tensor):
        return float(t)
    t = t.to(dtype=y.dtype)
    if t.ndim == 0:
        return t
    return t.reshape(t.shape[0], *([1] * (y.ndim - 1)))


def _projects(sde):
    """Whether the training-time forward solve re-projects each step to
    the conserved norm: MSGMSde's ``project_training_norms`` field, False
    for every other SDE."""
    return getattr(sde, "project_training_norms", False)


class SDEBehavior:
    """Mixin of the forward SDEs: needs ``beta_min, beta_max, T,
    num_steps_forward`` and the drift/diffusion methods."""

    def beta(self, t):
        return beta_linear(t, self.beta_min, self.beta_max)

    def ijk(self):
        """COO indices of the noise tensor: None unless the SDE uses the
        circulant G."""
        return None

    @torch.no_grad()
    def sample_scheme(self, generator, t, y0, *, noise=None, noise_one=None):
        """y_t | y_0 by integrating the forward SDE, for per-sample times t
        (B,) or (B, 1) in [0, T]: one RK4 solve over the whole forward grid
        for the batch, keeping the state after floor(num_steps·t/T) steps
        per sample, and for samples below one grid step a single RK4 step
        of size t_b (the generic step, so kernel K1, four launches); with
        project_training_norms every state re-projected to ‖y0‖.

        noise: optional (num_steps, B, d) normals of the solve; noise_one:
        optional (B, d) normal of the one-step fallback. Returns (B, d)."""
        t = t.reshape(y0.shape[0]).to(y0.dtype)
        num_steps = self.num_steps_forward
        n_int = torch.clamp(torch.floor(num_steps * t / self.T).long(), 0,
                            num_steps)
        n_int = torch.where(t >= self.T, num_steps, n_int)
        flow = ForwardFlow(base_sde=self, T=self.T)
        project = _projects(self)
        y_sel = integrate_select(flow, y0, generator, num_steps, n_int,
                                 method="rk4", noise=noise,
                                 norm_correction=project)
        delta = _tcol(t, y0)
        if noise_one is None:
            noise_one = torch.randn(y0.shape, generator=generator,
                                    device=y0.device, dtype=y0.dtype)
        dW = torch.sqrt(torch.clamp(delta, min=0.0)) * noise_one
        y_one = rk4_step(flow, torch.zeros_like(delta), y0, delta, dW)
        if project:
            y_one = _norm_project(
                y_one, torch.linalg.vector_norm(y0, dim=-1, keepdim=True))
        return torch.where((n_int > 0)[:, None], y_sel, y_one)

    @torch.no_grad()
    def sample_scheme_allt(self, generator, y0, include_t0=True, *,
                           noise=None):
        """The whole forward trajectory (S, B, d), S = num_steps_forward
        (+1 with include_t0); noise as for sample_scheme."""
        flow = ForwardFlow(base_sde=self, T=self.T)
        return integrate_sde(flow, y0, generator, self.num_steps_forward,
                             method="rk4", keep_all=True,
                             include_t0=include_t0, noise=noise,
                             norm_correction=_projects(self))
