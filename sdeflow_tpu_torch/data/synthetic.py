"""Synthetic data samplers with explicit ``torch.Generator``s.

Port of sdeflow_tpu/data/synthetic.py:18-181: ``SwissRoll``, ``Gaussian``,
``Cauchy`` and ``GaussianCauchy`` (the toy presets' data), and the smoothed
Gaussian random field of the grf presets (``SmoothedGRF`` with its test
set and std, and ``grf_spectral_filter``, with ``torch.fft``). Each has
``.sample(generator, n)`` and ``.sampletest(generator, n)`` -> (n, d)
float32 on its device, ``.dim``, ``.name`` and, but for SwissRoll,
``.get_std()``; the matrices of Gaussian, Cauchy and GaussianCauchy are
drawn at construction from the generator passed in, on its device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sdeflow_tpu_torch.ops.kernels.common import resolve_device
from sdeflow_tpu_torch.ops.rng import fold_in

_TEST_STREAM = 0x7E57  # sampletest's fold, as in the JAX package


class SwissRoll:
    """The 2D swiss roll [x, z]/5 with thickness noise: t = 1.5π(1 + 2u),
    (x, z) = (t·cos t, t·sin t) plus noise·ε."""

    def __init__(self, device="cuda"):
        self.dim = 2
        self.name = "swiss"
        self.device = resolve_device(device)

    def sample(self, generator, n, noise=0.5):
        u = torch.rand((n,), generator=generator, device=self.device)
        t = 1.5 * math.pi * (1 + 2 * u)
        x = torch.stack([t * torch.cos(t), t * torch.sin(t)], dim=1)
        x = x + noise * torch.randn((n, 2), generator=generator,
                                    device=self.device)
        return (x / 5.0).to(torch.float32)

    def sampletest(self, generator, n, noise=0.5):
        return self.sample(generator, n, noise)


def _mixing(generator, dim, correlation, normalized):
    """(A, std): A a standard normal (dim, dim) matrix drawn from
    `generator` (the identity without correlation), std = √diag(A·Aᵀ);
    normalized, A's rows divided by std."""
    device = generator.device
    if correlation:
        A = torch.randn((dim, dim), generator=generator, device=device)
    else:
        A = torch.eye(dim, device=device)
    std = torch.sqrt(torch.diag(A @ A.T))
    if normalized:
        A = A / std[:, None]
    return A, std


def _suffix(correlation, normalized):
    return ("cor" if correlation else "") + ("_norm" if normalized else "")


class Gaussian:
    """Correlated multi-dimensional Gaussian x = ε·Aᵀ."""

    def __init__(self, generator, dim=2, correlation=True, normalized=False):
        self.dim = dim
        self.name = f"gaussian{dim}" + _suffix(correlation, normalized)
        self.A, self.std = _mixing(generator, dim, correlation, normalized)

    def sample(self, generator, n):
        eps = torch.randn((n, self.dim), generator=generator,
                          device=self.A.device)
        return (eps @ self.A.T).to(torch.float32)

    def sampletest(self, generator, n):
        return self.sample(generator, n)

    def get_std(self):
        return self.std


class Cauchy:
    """Heavy-tailed multi-dimensional Cauchy of scale 1/50, optionally
    correlated: x = c·Aᵀ."""

    def __init__(self, generator, dim=2, correlation=False, normalized=False):
        self.dim = dim
        self.name = f"cauchy{dim}" + _suffix(correlation, normalized)
        self.A, self.std = _mixing(generator, dim, correlation, normalized)
        self.scale = 1.0 / 50

    def sample(self, generator, n):
        c = torch.empty((n, self.dim), device=self.A.device).cauchy_(
            generator=generator) * self.scale
        return (c @ self.A.T).to(torch.float32)

    def sampletest(self, generator, n):
        return self.sample(generator, n)

    def get_std(self):
        return self.std


class GaussianCauchy:
    """A correlated Gaussian scaled by one scalar Cauchy draw shared by the
    whole batch, times 1/50."""

    def __init__(self, generator, dim=2, correlation=True, normalized=False):
        self.gaussian = Gaussian(generator, dim, correlation, normalized)
        self.dim = dim
        self.name = f"gaussianCauchy{dim}" + _suffix(correlation, normalized)

    def get_std(self):
        return self.gaussian.std

    def sample(self, generator, n):
        x = self.gaussian.sample(generator, n)
        scalar = torch.empty((1, 1), device=x.device).cauchy_(
            generator=generator)
        return ((1.0 / 50) * x * scalar).to(torch.float32)

    def sampletest(self, generator, n):
        return self.sample(generator, n)


def grf_spectral_filter(npixel: int, ell: float = 2.0):
    """Real-FFT spectral filter of a periodic smoothed Gaussian random
    field, and the norm that gives unit pixel variance: the field is
    irfft2(rfft2(w)·filt)/norm with w iid N(0, 1). Returns (filt, norm) as
    a float32 numpy array and a float."""
    k1 = 2.0 * np.pi * np.fft.fftfreq(npixel)
    k2 = 2.0 * np.pi * np.fft.rfftfreq(npixel)
    ksq = k1[:, None] ** 2 + k2[None, :] ** 2
    filt = np.exp(-0.5 * ell**2 * ksq)
    # Var(x_pixel) = (1/N²)·Σ_k filt(k)² over the full two-sided spectrum;
    # the rfft grid stores only half, so double the interior columns
    weights = np.full_like(filt, 2.0)
    weights[:, 0] = 1.0
    if npixel % 2 == 0:
        weights[:, -1] = 1.0
    var = float((weights * filt**2).sum()) / npixel**2
    return filt.astype("float32"), float(var**0.5)


class SmoothedGRF:
    """Periodic smoothed GRF on an npixel×npixel grid, flattened column-major
    (order "F") to (n, npixel²), unit pixel variance."""

    def __init__(self, npixel=16, ell=2.0, device="cuda"):
        self.npixel = int(npixel)
        self.dim = self.npixel**2
        self.name = f"grf{npixel}"
        filt, norm = grf_spectral_filter(self.npixel, ell)
        self.filt = torch.as_tensor(filt, device=resolve_device(device))
        self.norm = norm

    def fields(self, w):
        """The fields (n, H, W) of white noise w (n, H, W)."""
        x = torch.fft.irfft2(torch.fft.rfft2(w) * self.filt,
                             s=(self.npixel,) * 2)
        return x / self.norm

    def sample(self, generator, n):
        w = torch.randn((n, self.npixel, self.npixel), generator=generator,
                        device=self.filt.device)
        x = self.fields(w)
        return x.transpose(1, 2).reshape(n, self.dim).to(torch.float32)

    def sampletest(self, generator, n):
        """A test set: ``sample`` from a stream folded off `generator`'s
        state, independent of ``sample``'s own draws from it; `generator`
        is not advanced."""
        return self.sample(fold_in(generator, _TEST_STREAM), n)

    def get_std(self):
        """Per-pixel std of the fields: ones (unit variance)."""
        return torch.ones((self.dim,), device=self.filt.device)
