"""Multiplicative SGM SDE dY = √β(t) G(Y) ∘ dB, circulant G.

Port of sdeflow_tpu/sde/msgm.py for the serve path: the circulant G (its
action is kernel K1, ops/kernels/circulant.py) and the ecdf radial latent
prior, with the optional log map of the radii. The forward perturbation of
the training loss comes with ROADMAP Queue 1 item 1, the dense G and the
KDE prior with item 2.

Sign convention (as in the JAX package): the Itô drift is f = β(t)·L_G·y with
L_G = −½I for the circulant G, so f = −½β(t)y.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from sdeflow_tpu_torch.ops.hutchinson import randu_on_sphere
from sdeflow_tpu_torch.ops.kernels.circulant import circulant_apply
from sdeflow_tpu_torch.sde.base import _tcol, beta_linear

_LOG_EPS = 1e-6  # sdeflow_tpu/sde/msgm.py:45


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


@dataclass(frozen=True)
class MSGMSde:
    """Norm-preserving multiplicative SDE with an empirical radial prior."""

    beta_min: float
    beta_max: float
    T: float
    t_epsilon: float
    r_T: torch.Tensor  # (N,) (possibly log-mapped) training norms, SORTED
    dim: int
    num_steps_forward: int = 100
    circulant: bool = True
    norm_sampler: str = "ecdf"
    norm_map: Optional[str] = None
    name: str = "MSGM_sparseTens"

    @classmethod
    def create(cls, y0, *, beta_min=0.1, beta_max=20.0, T=1.0,
               t_epsilon=0.001, num_steps_forward=100, dense_tensor=True,
               norm_sampler="ecdf", norm_map=None):
        """Build the SDE from data y0 (N, d) on y0's device: the sorted
        empirical norms, log-mapped when norm_map == "log"."""
        if dense_tensor:
            raise NotImplementedError(
                "dense G: ROADMAP Queue 1 item 2 (SDE core)")
        if norm_sampler != "ecdf":
            raise NotImplementedError(
                "KDE radial prior: ROADMAP Queue 1 item 2 (SDE core)")
        y0 = y0.to(torch.float32)
        r_T = torch.linalg.vector_norm(y0, dim=1)
        if norm_map == "log":
            r_T = torch.log(r_T + _LOG_EPS)
        r_T = torch.sort(r_T).values
        name = "MSGM_sparseTens" + ("logNorm" if norm_map == "log" else "")
        return cls(beta_min=float(beta_min), beta_max=float(beta_max),
                   T=float(T), t_epsilon=float(t_epsilon), r_T=r_T,
                   dim=int(y0.shape[1]),
                   num_steps_forward=int(num_steps_forward),
                   norm_sampler=norm_sampler, norm_map=norm_map, name=name)

    def beta(self, t):
        return beta_linear(t, self.beta_min, self.beta_max)

    # -- drift / diffusion ---------------------------------------------------
    def f(self, t, y):
        """Itô drift f = −½β(t)·y."""
        return -0.5 * self.beta(_tcol(t, y)) * y

    def f_strato(self, t, y):
        """Stratonovich drift ≡ 0."""
        return torch.zeros_like(y)

    def div_sigma(self, t, y):
        """∇·Σ = 2f."""
        return 2.0 * self.f(t, y)

    def sigma_apply(self, t, y, w):
        """g(t,y)·w through the circulant stencil kernel K1."""
        return circulant_apply(_sqrt(self.beta(_tcol(t, y))), y, w)

    # -- radial latent prior ---------------------------------------------------
    def radii_from_uniform(self, u):
        """Inverse empirical cdf with linear interpolation over the sorted
        r_T (jnp.interp(u·(n−1), arange(n), r_T) in the JAX package), then
        the inverse log map. u (M,) in [0, 1) -> (M, 1)."""
        n = self.r_T.shape[0]
        x = u * (n - 1)
        i0 = torch.clamp(torch.floor(x).long(), 0, max(n - 2, 0))
        i1 = torch.clamp(i0 + 1, max=n - 1)
        lo, hi = self.r_T[i0], self.r_T[i1]
        r = lo + (x - i0.to(u.dtype)) * (hi - lo)
        if self.norm_map == "log":
            r = torch.exp(r) - _LOG_EPS
        return r[:, None]

    def gen_radial_distribution(self, generator, num_samples):
        u = torch.rand((num_samples,), generator=generator,
                       device=self.r_T.device, dtype=self.r_T.dtype)
        return self.radii_from_uniform(u)

    def latent_sample(self, generator, num_samples, n=None):
        """x_0 = r·s with r from the radial prior and s uniform on the
        sphere (n is the JAX signature's unused dimension argument)."""
        r = self.gen_radial_distribution(generator, num_samples)
        s = randu_on_sphere(generator, (num_samples, self.dim),
                            device=self.r_T.device, dtype=self.r_T.dtype)
        return r * s
