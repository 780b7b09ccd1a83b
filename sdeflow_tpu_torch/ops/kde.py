"""1-D Gaussian kernel density estimation on the device.

Port of sdeflow_tpu/ops/kde.py:20-54: a Gaussian KDE is a uniform mixture
of N Gaussians centred on the data points, so its log density is a
logsumexp over the centres. The KDE sampler (``norm_sampler="kde"``) comes
with ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

import math

import torch

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def gaussian_kde_logpdf(x, centers, bandwidth):
    """Log density at x (M,) of the Gaussian KDE with `centers` (N,) and a
    scalar bandwidth (number or 0-d tensor). Returns (M,)."""
    bw = torch.as_tensor(bandwidth, dtype=centers.dtype, device=centers.device)
    z = (x[:, None] - centers[None, :]) / bw
    log_kernel = -0.5 * z**2 - LOG_SQRT_2PI - torch.log(bw)
    return torch.logsumexp(log_kernel, dim=1) - math.log(centers.shape[0])


def kde_normalization_log_constant(centers, bandwidth, num_grid=1000):
    """log ∫ KDE density over [min(centers), max(centers)] by a Riemann sum
    on a `num_grid`-point linspace (left endpoints, as the JAX package)."""
    r = torch.linspace(0.0, 1.0, num_grid, dtype=centers.dtype,
                       device=centers.device)
    lo, hi = centers.min(), centers.max()
    r = lo + (hi - lo) * r
    dens = torch.exp(gaussian_kde_logpdf(r, centers, bandwidth))
    return torch.log(torch.sum(dens) * (r[1] - r[0]))
