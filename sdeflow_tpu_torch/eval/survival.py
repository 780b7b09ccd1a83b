"""Empirical survival curves S(R) = P(‖x‖ > R) and log-log tail fits.

Port of sdeflow_tpu/eval/survival.py:18-102: a shared log-spaced R grid,
the empirical survival by a search of the sorted norms, and the OLS tail
exponent of (log R, log S) over the top-k order statistics. The norms are
computed on the samples' device; the small fit runs in numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _norms(x, std_norm=None):
    x = torch.as_tensor(x)
    if std_norm is not None:
        x = x * torch.as_tensor(std_norm, dtype=x.dtype, device=x.device)
    return torch.linalg.vector_norm(x, dim=1).cpu().numpy()


def common_r_grid(norms_list, n_points=200):
    """A log-spaced grid from 0.9 × the smallest positive norm to the
    largest norm over every non-empty array of `norms_list`."""
    mins, maxs = [], []
    for arr in norms_list:
        if arr is None or len(arr) == 0:
            continue
        pos = arr[arr > 0]
        if pos.size > 0:
            mins.append(pos.min())
        maxs.append(arr.max())
    if not maxs:
        raise ValueError("No data provided to build R grid.")
    min_pos = min(mins) if mins else 1e-12
    upper = max(maxs) if max(maxs) > min_pos else min_pos * 10.0
    return np.logspace(np.log10(min_pos * 0.9), np.log10(upper), num=n_points)


def survival_curve(norms, r_grid):
    """The empirical S(R) on the grid and the counts above each R."""
    norms_sorted = np.sort(norms)
    idx = np.searchsorted(norms_sorted, r_grid, side="right")
    counts = norms.size - idx
    s = (counts.astype(float) / float(norms.size) if norms.size
         else np.zeros_like(r_grid))
    return s, counts


def tail_fit_loglog(r_grid, s_vals, norms, tail_frac=0.05, tail_k=None):
    """OLS fit log S = a + b log R over the grid points at or above the
    (k+1)-th largest norm; alpha = −b. Returns (alpha, k, S_fit), with
    None where fewer than 10 norms or 3 positive tail points."""
    n = norms.size
    if n < 10:
        return None, None, None
    sorted_norms = np.sort(norms)
    if tail_k is None:
        k = max(10, int(np.clip(np.ceil(n * tail_frac), 10, n - 1)))
    else:
        k = int(max(1, tail_k))
    k = min(k, n - 1)  # the (n-k-1)-th order statistic exists
    threshold = sorted_norms[-k - 1]
    mask = r_grid >= threshold
    if not np.any(mask):
        return None, k, None
    r_tail, s_tail = r_grid[mask], s_vals[mask]
    positive = s_tail > 0
    if np.sum(positive) < 3:
        return None, k, None
    b, a = np.polyfit(np.log(r_tail[positive]), np.log(s_tail[positive]), 1)
    return float(-b), int(k), np.exp(a) * (r_grid**b)


def survival_analysis(x=None, x_ref=None, std_norm=None, n_points=200,
                      tail_frac=0.05, tail_k=None):
    """Survival summary of generated samples x and reference samples x_ref
    (either may be None), their norms scaled by std_norm: the shared grid
    ``R_grid``, per tag ("reference", "generated") its ``S``, ``counts``
    and ``N``, and ``fits[tag]`` its tail ``alpha`` and ``k``."""
    if x is None and x_ref is None:
        raise ValueError("At least one of x or x_ref must be provided.")
    norms_ref = _norms(x_ref, std_norm) if x_ref is not None else None
    norms_gen = _norms(x, std_norm) if x is not None else None
    r_grid = common_r_grid([norms_ref, norms_gen], n_points=n_points)

    out = {"R_grid": r_grid, "fits": {}}
    for tag, norms in (("reference", norms_ref), ("generated", norms_gen)):
        if norms is None:
            out[tag] = {"S": None, "counts": None, "N": 0}
            out["fits"][tag] = {"alpha": None, "k": None}
            continue
        s, counts = survival_curve(norms, r_grid)
        alpha, k, _ = tail_fit_loglog(r_grid, s, norms, tail_frac=tail_frac,
                                      tail_k=tail_k)
        out[tag] = {"S": s, "counts": counts, "N": norms.size}
        out["fits"][tag] = {"alpha": alpha, "k": k}
    return out
