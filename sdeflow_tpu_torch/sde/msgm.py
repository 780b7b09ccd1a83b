"""Multiplicative SGM SDE dY = √β(t) G(Y) ∘ dB, dense or circulant G.

Port of sdeflow_tpu/sde/msgm.py: the circulant G (its action is kernel
K1, one whole forward RK4 step kernel K2, the whole forward solve of the
training loss one launch of K2's solve, ops/kernels/circulant.py) and the
dense G of small d (ops/gapply.py: two matrix products, no kernel; its
forward RK4 steps are the generic stages), the forward perturbation of the
training loss (sde/base.py, optionally norm-projected), the ecdf and KDE
radial latent priors with the optional log map of the radii, the
conditional latent, the KDE log density of the ELBO and the normalized
latent density of the exact likelihood (``log_latent_pdf_exact``).

Sign convention (as in the JAX package): the Itô drift is f = β(t)·L_G·y with
L_G = ½Σ_k G_k G_k negative-definite; L_G = −½I for the circulant G, so
f = −½β(t)y.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from sdeflow_tpu_torch.ops.gapply import (
    circulant_ijk, dense_sigma_apply, make_dense_G)
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
    # the noise tensor: dense (G (d, d, d), L_G (d, d)) or circulant (None)
    G: Optional[torch.Tensor] = None
    L_G: Optional[torch.Tensor] = None
    circulant: bool = True
    norm_sampler: str = "ecdf"
    norm_map: Optional[str] = None
    # the generation solve re-projects each step to the latent's norm (the
    # SDE conserves it)
    norm_correction: bool = True
    # re-project each step of the training-time forward solve too (the
    # JAX package's opt-in, off as in the reference; set it with
    # dataclasses.replace)
    project_training_norms: bool = False
    name: str = "MSGM"

    @classmethod
    def create(cls, y0, *, generator=None, beta_min=0.1, beta_max=20.0,
               T=1.0, t_epsilon=0.001, num_steps_forward=100,
               dense_tensor=True, norm_sampler="ecdf", norm_map=None,
               estimate_norm_constant=True):
        """Build the SDE from data y0 (N, d) on y0's device: the sorted
        empirical norms, log-mapped when norm_map == "log", the KDE
        bandwidth 0.1·std(r_T), with dense_tensor a random dense G drawn
        from `generator` (``make_dense_G``), and with
        estimate_norm_constant the KDE's log normalizing constant (else
        0). The name follows the JAX package's rule: "MSGM", then
        "_sparseTens" for the circulant G, norm_sampler + "gaussian" (the KDE
        kernel) unless the sampler is "ecdf", "logNorm" under the log
        map."""
        if norm_sampler not in ("ecdf", "kde"):
            raise ValueError(f"unknown norm_sampler {norm_sampler!r}")
        if dense_tensor and generator is None:
            raise ValueError("a dense G is drawn from a generator")
        y0 = y0.to(torch.float32)
        r_T = torch.linalg.vector_norm(y0, dim=1)
        if norm_map == "log":
            r_T = torch.log(r_T + _LOG_EPS)
        bandwidth = 0.1 * torch.std(r_T, correction=0)
        r_T = torch.sort(r_T).values
        cst = (kde_normalization_log_constant(r_T, bandwidth)
               if estimate_norm_constant else torch.zeros_like(bandwidth))
        dim = int(y0.shape[1])
        G = L_G = None
        if dense_tensor:
            G, L_G = (a.to(y0.device) for a in make_dense_G(generator, dim))
        name = "MSGM"
        if not dense_tensor:
            name += "_sparseTens"
        if norm_sampler != "ecdf":
            name += norm_sampler + "gaussian"
        if norm_map == "log":
            name += "logNorm"
        return cls(beta_min=float(beta_min), beta_max=float(beta_max),
                   T=float(T), t_epsilon=float(t_epsilon), r_T=r_T,
                   kde_bandwidth=bandwidth, cst_log_dens=cst, dim=dim,
                   num_steps_forward=int(num_steps_forward), G=G, L_G=L_G,
                   circulant=not dense_tensor, norm_sampler=norm_sampler,
                   norm_map=norm_map, name=name)

    @property
    def device(self):
        return self.r_T.device

    # -- drift / diffusion ---------------------------------------------------
    def f(self, t, y):
        """Itô drift f = β(t)·L_G·y: −½β(t)·y for the circulant G."""
        bt = self.beta(_tcol(t, y))
        if self.circulant:
            return -0.5 * bt * y
        return (bt * y) @ self.L_G.T

    def f_strato(self, t, y):
        """Stratonovich drift ≡ 0."""
        return torch.zeros_like(y)

    def div_sigma(self, t, y):
        """∇·Σ = 2f."""
        return 2.0 * self.f(t, y)

    def sigma_apply(self, t, y, w):
        """g(t,y)·w: the circulant stencil kernel K1, or the dense G's two
        products."""
        sqrt_bt = _sqrt(self.beta(_tcol(t, y)))
        if self.circulant:
            return circulant_apply(sqrt_bt, y, w)
        return dense_sigma_apply(self.G, sqrt_bt, y, w)

    def fused_forward_rk4_step(self, t, x, delta, dW):
        """One whole RK4 forward step (Stratonovich drift ≡ 0) as kernel
        K2: √β at t, t+δ/2 and t+δ as sb3 (B, 3). A number t is written
        by three fills, not copied from the host. None for the dense G:
        the caller takes the generic stages."""
        if not self.circulant:
            return None
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
        t = i·δ with increment √δ·z[i]. None for the dense G: the caller
        takes the per-step loop."""
        if not self.circulant:
            return None
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
        """(num_samples, 1) radii: the inverse empirical cdf of a uniform
        draw ("ecdf"), or a draw of the KDE mixture ("kde", negative radii
        clamped to 0 without the log map), then the inverse log map."""
        return self.radii_from_draws(
            *self._radial_draws(generator, num_samples))

    def radii_from_draws(self, *draws):
        """The radii of ``gen_radial_distribution`` from its raw draws: a
        uniform u (M,) ("ecdf"), or a centre index and a standard normal,
        both (M,) ("kde"). Returns (M, 1)."""
        if self.norm_sampler == "ecdf":
            return self.radii_from_uniform(*draws)
        idx, eps = draws
        r = self.r_T[idx] + self.kde_bandwidth * eps
        if self.norm_map == "log":
            r = torch.exp(r) - _LOG_EPS
        else:
            r = torch.clamp(r, min=0.0)
        return r[:, None]

    def latent_draw_specs(self, num_samples, n=None):
        """Shape and law of each of ``latent_draws``' draws, in order (a
        "randint" draws from [0, high))."""
        m, d = num_samples, self.dim
        if self.norm_sampler == "ecdf":
            radial = [dict(name="u", law="uniform", shape=[m])]
        else:
            radial = [dict(name="idx", law="randint", shape=[m],
                           high=int(self.r_T.shape[0])),
                      dict(name="eps", law="normal", shape=[m])]
        return radial + [dict(name="z", law="normal", shape=[m, d])]

    def _radial_draws(self, generator, num_samples):
        """The radial prior's raw draws (``radii_from_draws``)."""
        dev, dt = self.r_T.device, self.r_T.dtype
        if self.norm_sampler == "ecdf":
            return (torch.rand((num_samples,), generator=generator,
                               device=dev, dtype=dt),)
        return (torch.randint(0, self.r_T.shape[0], (num_samples,),
                              generator=generator, device=dev),
                torch.randn((num_samples,), generator=generator, dtype=dt,
                            device=dev))

    def latent_draws(self, generator, num_samples, n=None):
        """The latent's raw draws from `generator`, in the order
        ``latent_sample`` has always drawn them (sde/msgm.py:202-224,
        ops/kde.py:28-36, ops/hutchinson.py:24 of the JAX package): the
        radial draws (``radii_from_draws``), then the sphere's standard
        normal (num_samples, dim)."""
        radial = self._radial_draws(generator, num_samples)
        z = torch.randn((num_samples, self.dim), generator=generator,
                        device=self.r_T.device, dtype=self.r_T.dtype)
        return (*radial, z)

    def latent_from_draws(self, *draws):
        """x_0 = r·s from ``latent_draws``: the radii of the radial draws,
        s the sphere's normal normalized."""
        *radial, z = draws
        s = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        return self.radii_from_draws(*radial) * s

    def latent_sample(self, generator, num_samples, n=None):
        """x_0 = r·s with r from the radial prior and s uniform on the
        sphere (n is the JAX signature's unused dimension argument)."""
        return self.latent_from_draws(
            *self.latent_draws(generator, num_samples))

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

    def log_latent_pdf_exact(self, yT):
        """The normalized log density of the latent law x = r·s
        (sdeflow_tpu/sde/msgm.py:277-314): p(x) = p_r(‖x‖) /
        (S_{d−1}·‖x‖^{d−1}), S_{d−1} = 2π^{d/2}/Γ(d/2), with, under the log
        map (u = log(r + ε) KDE-distributed), p_r(r) = p_u(log(r + ε))/(r +
        ε). It integrates to 1 over R^d, so ``eval/nll.exact_logp`` gives a
        true likelihood; with norm_map None it ignores the KDE's mass below
        radius 0. Returns (B,)."""
        d = float(self.dim)
        r = torch.linalg.vector_norm(yT, dim=1)
        if self.norm_map == "log":
            u = torch.log(r + _LOG_EPS)
            log_pr = gaussian_kde_logpdf(u, self.r_T, self.kde_bandwidth) - u
        else:
            log_pr = gaussian_kde_logpdf(r, self.r_T, self.kde_bandwidth)
        half_d = torch.tensor(0.5 * d, dtype=r.dtype, device=r.device)
        log_sphere_area = (math.log(2.0) + half_d * math.log(math.pi)
                           - torch.lgamma(half_d))
        return log_pr - log_sphere_area - (d - 1.0) * torch.log(r)

    # -- diagnostics -------------------------------------------------------------
    def ijk(self):
        """COO (I, J, K, V) of the circulant G; None for the dense G."""
        if self.circulant:
            return circulant_ijk(self.dim, device=self.device)
        return None

    def beta_G(self):
        """The normalization invariant β_G = −2·tr(L_G)/d: 1 for the
        circulant G and, after ``make_dense_G``'s scaling, the dense one."""
        if self.circulant:
            return torch.ones((), device=self.device)
        return -2.0 * torch.trace(self.L_G) / self.dim
