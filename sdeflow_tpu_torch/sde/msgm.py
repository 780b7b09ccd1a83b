"""Multiplicative SGM SDE dY = √β(t) G(Y) ∘ dB, circulant G.

Port of sdeflow_tpu/sde/msgm.py: the circulant G (its action is kernel
K1, one whole forward RK4 step kernel K2, the whole forward solve of the
training loss one launch of K2's solve, ops/kernels/circulant.py), the
forward perturbation of the training loss (sde/base.py), the ecdf radial
latent prior with the optional log map of the radii, the conditional latent
and the KDE log density of the ELBO. The dense G and the KDE radius sampler
come with ROADMAP Queue 1 item 2.

Sign convention (as in the JAX package): the Itô drift is f = β(t)·L_G·y with
L_G = −½I for the circulant G, so f = −½β(t)y.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from sdeflow_tpu_torch.ops.hutchinson import randu_on_sphere
from sdeflow_tpu_torch.ops.kde import (
    gaussian_kde_logpdf, kde_normalization_log_constant)
from sdeflow_tpu_torch.ops.kernels.circulant import (
    circulant_apply, circulant_rk4_solve_select, circulant_rk4_step)
from sdeflow_tpu_torch.sde.base import SDEBehavior, _sqrt, _tcol, beta_linear

_LOG_EPS = 1e-6  # sdeflow_tpu/sde/msgm.py:45


@functools.lru_cache(maxsize=16)
def sqrt_beta_table(beta_min, beta_max, delta, n, device, dtype):
    """√β(t + s·δ) for t = i·δ, i < n, s ∈ {0, ½, 1}: the (n, 3) table of
    K2's solve, with the values the per-step path fills
    (``fused_forward_rk4_step``: float64 on the host, that expression's
    order, rounded once to ``dtype``). Built once per schedule and grid and
    kept on the device, so a solve costs no host-to-device copy."""
    rows = [[math.sqrt(beta_linear(i * delta + s * delta, beta_min, beta_max))
             for s in (0.0, 0.5, 1.0)] for i in range(n)]
    return torch.tensor(rows, dtype=dtype).to(device)


@dataclass(frozen=True)
class MSGMSde(SDEBehavior):
    """Norm-preserving multiplicative SDE with an empirical radial prior."""

    beta_min: float
    beta_max: float
    T: float
    t_epsilon: float
    r_T: torch.Tensor  # (N,) (possibly log-mapped) training norms, SORTED
    kde_bandwidth: torch.Tensor  # () 0.1·std(r_T)
    cst_log_dens: torch.Tensor  # () log KDE normalizing constant, or 0
    dim: int
    num_steps_forward: int = 100
    circulant: bool = True
    norm_sampler: str = "ecdf"
    norm_map: Optional[str] = None
    # the generation solve re-projects each step to the latent's norm (the
    # SDE conserves it)
    norm_correction: bool = True
    name: str = "MSGM_sparseTens"

    @classmethod
    def create(cls, y0, *, beta_min=0.1, beta_max=20.0, T=1.0,
               t_epsilon=0.001, num_steps_forward=100, dense_tensor=True,
               norm_sampler="ecdf", norm_map=None,
               estimate_norm_constant=True):
        """Build the SDE from data y0 (N, d) on y0's device: the sorted
        empirical norms, log-mapped when norm_map == "log", the KDE
        bandwidth 0.1·std(r_T) and, with estimate_norm_constant, the KDE's
        log normalizing constant (else 0)."""
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
        bandwidth = 0.1 * torch.std(r_T, correction=0)
        r_T = torch.sort(r_T).values
        cst = (kde_normalization_log_constant(r_T, bandwidth)
               if estimate_norm_constant else torch.zeros_like(bandwidth))
        name = "MSGM_sparseTens" + ("logNorm" if norm_map == "log" else "")
        return cls(beta_min=float(beta_min), beta_max=float(beta_max),
                   T=float(T), t_epsilon=float(t_epsilon), r_T=r_T,
                   kde_bandwidth=bandwidth, cst_log_dens=cst,
                   dim=int(y0.shape[1]),
                   num_steps_forward=int(num_steps_forward),
                   norm_sampler=norm_sampler, norm_map=norm_map, name=name)

    @property
    def device(self):
        return self.r_T.device

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

    def fused_forward_rk4_step(self, t, x, delta, dW):
        """One whole RK4 forward step (Stratonovich drift ≡ 0) as kernel
        K2: √β at t, t+δ/2 and t+δ as sb3 (B, 3). A number t is written
        by three fills, not copied from the host."""
        b = x.shape[0]
        if isinstance(t, torch.Tensor):
            tc = _tcol(t, x)
            sb3 = torch.cat([torch.sqrt(self.beta(tc + s * delta)).expand(b, 1)
                             for s in (0.0, 0.5, 1.0)], dim=-1)
        else:
            sb3 = torch.empty((b, 3), dtype=x.dtype, device=x.device)
            for j, s in enumerate((0.0, 0.5, 1.0)):
                sb3[:, j].fill_(math.sqrt(self.beta(t + s * delta)))
        return circulant_rk4_step(sb3, x, dW)

    def fused_forward_rk4_solve_select(self, x0, z, delta, select_idx):
        """The whole forward RK4 solve with the per-sample select
        (integrate_select with ``fused_forward_rk4_step`` as its step) as
        one launch of K2's solve: z (n, B, d) the normals, step i at
        t = i·δ with increment √δ·z[i]."""
        sb = sqrt_beta_table(self.beta_min, self.beta_max, delta, z.shape[0],
                             x0.device, x0.dtype)
        return circulant_rk4_solve_select(x0, z, sb, select_idx, delta ** 0.5)

    # -- forward perturbation ----------------------------------------------
    def sample(self, generator, t, y0, *, noise=None, noise_one=None):
        """y_t | y_0 by the numeric forward solve (sde/base.py)."""
        return self.sample_scheme(generator, t, y0, noise=noise,
                                  noise_one=noise_one)

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

    def cond_latent_sample(self, generator, t, x, *, z=None):
        """y_T | x: the data point's own radius times a direction uniform
        on the sphere (z: optional (B, d) normal draw behind it)."""
        r_x = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        if z is None:
            z = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
        return r_x * (z / torch.linalg.vector_norm(z, dim=-1, keepdim=True))

    def log_latent_pdf(self, yT):
        """KDE log density of ‖y_T‖ minus the normalizing constant, with
        the reference's two approximations kept (sdeflow_tpu/sde/msgm.py:
        263-275). Returns (B,)."""
        r = torch.linalg.vector_norm(yT, dim=1)
        return (gaussian_kde_logpdf(r, self.r_T, self.kde_bandwidth)
                - self.cst_log_dens)
