"""Synthetic data: the smoothed Gaussian random field of the grf presets.

Port of ``SmoothedGRF`` (with its test set and std) and
``grf_spectral_filter`` (sdeflow_tpu/data/synthetic.py:96-153) with
``torch.fft`` and explicit ``torch.Generator``s. The other synthetic
samplers come with ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import numpy as np
import torch

from sdeflow_tpu_torch.ops.kernels.common import resolve_device
from sdeflow_tpu_torch.ops.rng import fold_in

_TEST_STREAM = 0x7E57  # sampletest's fold, as in the JAX package


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
