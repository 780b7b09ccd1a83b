"""Plug-in reverse SDE: the generative flow and the SSM and DSM losses.

Port of sdeflow_tpu/sde/reverse.py. The learned drift a(y, t) is any
callable ``score_net(y, t) -> (B, d)``, typically an ``nn.Module``, in the
"direct" parameterization, or the noise ε that it scales to a(y, t) under
"eps" (an SDE with a closed-form kernel: SGM). The SSM loss takes the
Hutchinson divergence with one forward-mode ``torch.func.jvp``
(ops/hutchinson.py), and its gradient with respect to the score net's
parameters comes from ``.backward()`` through that JVP; denoising score
matching (``dsm``, SGM) is reverse mode only. Every draw (t, the forward
solve's normals or the closed-form kernel's ε, the probe v, the
conditional latent's normal) can be injected, so that a test can replay the
JAX package's keys. The PF-ODE and corrector drifts come with ROADMAP
Queue 1 item 4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from sdeflow_tpu_torch.ops.hutchinson import hutchinson_div, sample_v


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
    vtype: str = "rademacher"
    ssm_intT: bool = False
    # index of the first forward-grid step with t > t_epsilon (the static
    # slice that replaces the reference's mask, SDEs.py:695-706)
    intT_start: int = 0
    debias: bool = False
    # "direct": a = net(y, t); "eps": a = −(g(t)/std(t))·net(y, t), the net
    # predicting the O(1) noise (sdeflow_tpu/sde/reverse.py:53-65)
    parameterization: str = "direct"

    @classmethod
    def create(cls, base_sde, score_net, T=None, vtype="rademacher",
               ssm_intT=False, debias=False, parameterization="direct"):
        if parameterization not in ("direct", "eps"):
            raise ValueError(f"Unknown parameterization: {parameterization}")
        if parameterization == "eps" and not hasattr(base_sde, "var"):
            raise ValueError(
                'parameterization="eps" requires a closed-form forward '
                "kernel (SGM): the output scale is g(t)/std(t)")
        if debias and not hasattr(base_sde, "var"):
            raise ValueError(
                "debias=True requires an SDE with a closed-form forward "
                "kernel (SGM): the debiasing density is g(t)²/std(t)²")
        T = float(base_sde.T if T is None else T)
        num_steps = base_sde.num_steps_forward
        grid = np.linspace(T / num_steps, T, num_steps)
        return cls(base_sde=base_sde, score_net=score_net, T=T, vtype=vtype,
                   ssm_intT=ssm_intT,
                   intT_start=int(np.sum(grid <= float(base_sde.t_epsilon))),
                   debias=debias, parameterization=parameterization)

    # -- learned drift --------------------------------------------------------
    def score(self, y, t):
        """a(y, t), with t as a (B,) row, cast back to y's dtype; under
        "eps" the net's output times −g(t)/std(t), with t clamped below at
        t_epsilon (std(0) = 0)."""
        t_row = _trow(t, y.shape[0], y)
        a = self.score_net(y, t_row).to(y.dtype)
        if self.parameterization == "eps":
            tt = torch.clamp(t_row, min=self.base_sde.t_epsilon).reshape(
                (-1,) + (1,) * (y.ndim - 1))
            std = torch.sqrt(self.base_sde.var(tt))
            a = -(self.base_sde.g_diag(tt.reshape(-1), y) / std) * a
        return a

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

    # -- time sampling ----------------------------------------------------------
    def _device(self):
        return self.base_sde.device

    def sample_t(self, generator, batch):
        """t ~ U(0, T], raised to t_epsilon below it."""
        t = torch.rand((batch,), generator=generator,
                       device=self._device()) * self.T
        eps = self.base_sde.t_epsilon
        return torch.where(t <= eps, torch.full_like(t, eps), t)

    def t_linspace(self):
        """The forward grid (dt, 2dt, ..., T) without its entries at or
        below t_epsilon."""
        num_steps = self.base_sde.num_steps_forward
        grid = torch.arange(1, num_steps + 1, dtype=torch.float32,
                            device=self._device()) * (self.T / num_steps)
        return grid[self.intT_start:]

    def sample_txy(self, generator, x, *, t=None, noise=None,
                   noise_one=None):
        """(t, x, y) for the SSM loss. Random-t mode: per-sample t (drawn
        unless given) and one forward perturbation y. ssm_intT mode: the
        whole forward grid, flattened to (S'·B, d) with t varying slowest.
        y carries no gradient (the forward solve runs under no_grad)."""
        if self.ssm_intT:
            batch, dim = x.shape
            t = self.t_linspace()
            y = self.base_sde.sample_scheme_allt(generator, x,
                                                 include_t0=False,
                                                 noise=noise)
            y = y[self.intT_start:]
            s = t.shape[0]
            return (t.repeat_interleave(batch), x.repeat(s, 1),
                    y.reshape(s * batch, dim))
        if t is None:
            t = self.sample_t(generator, x.shape[0])
        y = self.base_sde.sample(generator, t, x, noise=noise,
                                 noise_one=noise_one)
        return t, x, y

    # -- losses -------------------------------------------------------------------
    def ssm(self, generator, x, *, t=None, noise=None, noise_one=None,
            v=None):
        """Sliced score-matching loss per sample, (B,) (or (S'·B,) in intT
        mode); the keywords inject the draws."""
        t, x, y = self.sample_txy(generator, x, t=t, noise=noise,
                                  noise_one=noise_one)
        return self.ssm_loss(generator, t, x, y, v=v)

    def ssm_loss(self, generator, t, x, y, *, v=None):
        """vᵀ(∂mu_to_div/∂y)v + ½‖a‖², mu_to_div = g·a − f + ½∇·Σ (λ=0),
        with one JVP of the score net."""
        if v is None:
            v = sample_v(generator, tuple(x.shape), vtype=self.vtype,
                         device=x.device, dtype=x.dtype)

        def field(yv):
            a = self.score(yv, t)
            ga = self.base_sde.sigma_apply(t, yv, a)
            mu_to_div = (ga - self.base_sde.f(t, yv)
                         + 0.5 * self.base_sde.div_sigma(t, yv))
            return mu_to_div, a

        m_mu, _, a = hutchinson_div(field, y.detach(), v, has_aux=True)
        m_nu = 0.5 * torch.sum(a**2, dim=tuple(range(1, a.ndim)))
        return m_mu + m_nu

    def dsm(self, generator, x, *, t=None, noise=None):
        """Denoising score matching ½‖a·std/g + ε‖² per sample, (B,), for an
        SDE with a closed-form kernel (SGM): t from the debiasing law when
        debias, else U(0, T] raised to t_epsilon; ε the kernel's normal. The
        keywords inject t and ε."""
        if not hasattr(self.base_sde, "mean_weight"):
            raise ValueError("DSM requires a closed-form forward kernel (SGM)")
        if t is None:
            t = (self.base_sde.sample_debiasing_t(generator, (x.shape[0],))
                 if self.debias else self.sample_t(generator, x.shape[0]))
        y, target, std, g = self.base_sde.sample(generator, t, x,
                                                 noise=noise,
                                                 return_noise=True)
        a = self.score(y, t)
        return 0.5 * torch.sum((a * std / g + target) ** 2,
                               dim=tuple(range(1, x.ndim)))

    def elbo_random_t_slice(self, generator, x, *, t=None, noise=None,
                            noise_one=None, v=None, z=None):
        """ELBO estimate log p_latent(y_T | x) − ssm/q_t, q_t = 1/T; z is
        the conditional latent's normal draw."""
        loss_ssm = self.ssm(generator, x, t=t, noise=noise,
                            noise_one=noise_one, v=v) / (1.0 / self.T)
        if self.ssm_intT:
            s = self.base_sde.num_steps_forward - self.intT_start
            x2 = x.repeat(s, 1)
        else:
            x2 = x
        yT = self.base_sde.cond_latent_sample(generator, None, x2, z=z)
        lp = self.base_sde.log_latent_pdf(yT)
        return lp.reshape(x2.shape[0], -1).sum(dim=1) - loss_ssm

    # -- latent sampling -------------------------------------------------------
    def latent_sample(self, generator, num_samples, n=None):
        return self.base_sde.latent_sample(generator, num_samples, n)

    def cond_latent_sample(self, generator, t, x, *, z=None):
        return self.base_sde.cond_latent_sample(generator, t, x, z=z)
