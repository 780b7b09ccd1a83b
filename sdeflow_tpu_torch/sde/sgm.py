"""Variance-preserving (Song et al. 2021) additive SDE: the "SGM" model.

Port of sdeflow_tpu/sde/sgm.py:21-151 and of the closed-form forward kernel
``sample_song_et_al`` (sdeflow_tpu/sde/base.py:169-182):
dY = −½β(t)Y dt + √β(t) dB, with the Gaussian latent N(0, I), an isotropic
diagonal diffusion and the closed-form debiased time sampler. Times are
Python numbers or tensors of shape (), (B,) or (B, 1) (sde/base.py). Every
draw (the forward kernel's ε, the debiasing sampler's uniform u) can be
injected, so that a test can replay the JAX package's keys.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from sdeflow_tpu_torch.ops.kernels.common import resolve_device
from sdeflow_tpu_torch.sde.base import SDEBehavior, _sqrt, _tcol

LOG_2PI = math.log(2.0 * math.pi)


def _exp(v):
    return torch.exp(v) if isinstance(v, torch.Tensor) else math.exp(v)


@dataclass(frozen=True)
class SGMSde(SDEBehavior):
    """dY = −½β(t)Y dt + √β(t) dB (VP-SDE, eq. 32-33 of Song et al. 2021)
    on `device`."""

    beta_min: float
    beta_max: float
    T: float
    t_epsilon: float
    device: torch.device
    num_steps_forward: int = 100
    norm_correction: bool = False  # the VP SDE conserves no norm
    name: str = "SGM"

    @classmethod
    def create(cls, beta_min=0.1, beta_max=20.0, T=1.0, t_epsilon=0.001,
               num_steps_forward=100, device="cuda"):
        return cls(beta_min=float(beta_min), beta_max=float(beta_max),
                   T=float(T), t_epsilon=float(t_epsilon),
                   device=resolve_device(device),
                   num_steps_forward=int(num_steps_forward))

    # -- closed-form moments ----------------------------------------------
    def mean_weight(self, t):
        return _exp(-0.25 * t**2 * (self.beta_max - self.beta_min)
                    - 0.5 * t * self.beta_min)

    def var(self, t):
        return 1.0 - _exp(-0.5 * t**2 * (self.beta_max - self.beta_min)
                          - t * self.beta_min)

    # -- drift / diffusion -------------------------------------------------
    def f(self, t, y):
        return -0.5 * self.beta(_tcol(t, y)) * y

    def f_strato(self, t, y):
        return -0.5 * self.beta(_tcol(t, y)) * y

    def div_sigma(self, t, y):
        return torch.zeros_like(y)

    def g_diag(self, t, y):
        """Diagonal of g (isotropic): √β(t)·1."""
        return torch.ones_like(y) * _sqrt(self.beta(_tcol(t, y)))

    def sigma_apply(self, t, y, w):
        """g(t, y)·w for the isotropic diagonal diffusion."""
        return _sqrt(self.beta(_tcol(t, y))) * w

    # -- forward perturbation ----------------------------------------------
    def sample(self, generator, t, y0, *, noise=None, noise_one=None,
               return_noise=False):
        """y_t | y_0 in closed form (``sample_song_et_al``):
        y_t = mean_weight(t)·y_0 + std(t)·ε. ε is `noise` if given, else
        `noise_one` (the one-step draw of the MSGM signature, so that the
        SSM loss and the ELBO inject it alike), else drawn. With
        return_noise: (y_t, ε, std, g_diag)."""
        tc = _tcol(t, y0)
        eps = noise if noise is not None else noise_one
        if eps is None:
            eps = torch.randn(y0.shape, generator=generator,
                              device=y0.device, dtype=y0.dtype)
        std = _sqrt(self.var(tc))
        yt = eps * std + self.mean_weight(tc) * y0
        if not return_noise:
            return yt
        return yt, eps, std, self.g_diag(tc, yt)

    # -- debiased time sampling ----------------------------------------------
    def _B(self, t):
        """Integrated schedule B(t) = ∫₀ᵗ β(s) ds for the linear β."""
        return self.beta_min * t + 0.5 * (self.beta_max - self.beta_min) * t**2

    def sample_debiasing_t(self, generator, shape, *, u=None):
        """t with density q(t) ∝ β(t)/var(t) = g²/std², truncated below at
        t_epsilon, by inverting F(t) = B(t) + log var(t) in closed form
        (sdeflow_tpu/sde/sgm.py:101-129); u ~ U[0, 1) unless given."""
        if u is None:
            u = torch.rand(shape, generator=generator, device=self.device)
        # F at t_epsilon and T in u's precision, as the JAX package does
        ends = torch.tensor([self.t_epsilon, self.T], dtype=u.dtype,
                            device=u.device)
        f_lo, f_hi = self._B(ends) + torch.log(self.var(ends))
        big_b = F.softplus(f_lo + u * (f_hi - f_lo))
        a, b = 0.5 * (self.beta_max - self.beta_min), self.beta_min
        if a == 0.0:  # constant β
            t = big_b / b
        else:
            t = (torch.sqrt(torch.clamp(b**2 + 4.0 * a * big_b, min=0.0))
                 - b) / (2.0 * a)
        return torch.clamp(t, self.t_epsilon, self.T)

    # -- latent prior -------------------------------------------------------
    def latent_draws(self, generator, num_samples, n):
        """The latent's raw draws: one standard normal (num_samples, n)."""
        return (torch.randn((num_samples, n), generator=generator,
                            device=self.device),)

    def latent_draw_specs(self, num_samples, n):
        """Shape and law of each of ``latent_draws``' draws, in order."""
        return [dict(name="z", law="normal", shape=[num_samples, n])]

    @staticmethod
    def latent_from_draws(z):
        """The latents from ``latent_draws``: N(0, I) itself."""
        return z

    def latent_sample(self, generator, num_samples, n):
        return self.latent_from_draws(
            *self.latent_draws(generator, num_samples, n))

    def cond_latent_sample(self, generator, t, x, *, z=None):
        """y_T | x by the forward kernel at T (z: its ε, if given)."""
        t_T = torch.full((x.shape[0],), self.T, dtype=x.dtype,
                         device=x.device)
        return self.sample(generator, t_T, x, noise=z)

    def log_latent_pdf(self, yT):
        """Per-dimension standard-normal log density (B, d), with the
        reference's eps = 1e-5 smoothing."""
        zero = torch.zeros_like(yT)
        return self.log_normal(yT, zero, zero)

    @staticmethod
    def log_normal(x, mean, log_var, eps=1e-5):
        return (-((x - mean) ** 2) / (2.0 * torch.exp(log_var) + eps)
                - log_var / 2.0 - 0.5 * LOG_2PI)
