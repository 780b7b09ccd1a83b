"""Numerical diagnostics of forward solves and generated samples.

Port of sdeflow_tpu/eval/diagnostics.py:15-62: the forward-convergence
statistics (on the samples' device, one scalar tensor each) and the
host-side blow-up filter.
"""

from __future__ import annotations

import numpy as np
import torch


def forward_convergence_stats(x_test, x_forward):
    """Forward-SDE convergence metrics of test samples x_test (N, d) and
    their forward solve x_forward (N, d):

    - the distance of cov(x_test) and of cov(x_forward) to the isotropic
      law var̄·I of the test samples (tr(cov) = E‖X‖² is conserved by
      MSGM), relative to that law's Frobenius norm times √d,
    - the distance of cov(x_forward) to white noise of its own mean
      variance,
    - the energies E‖x‖² and their ratio forward / test.

    Returns a dict of 0-d tensors."""

    def cov(a):
        a = a - a.mean(dim=0, keepdim=True)
        return (a.T @ a) / (a.shape[0] - 1)

    d = x_test.shape[1]
    eye = torch.eye(d, dtype=x_test.dtype, device=x_test.device)

    def dist_to(c, target):
        return (torch.linalg.matrix_norm(c - target)
                / torch.sqrt(d * torch.trace(target**2)))

    converged = x_test.var(dim=0, correction=0).mean() * eye
    wwn = x_forward.var(dim=0, correction=0).mean() * eye
    energy_test = (x_test**2).sum(dim=1).mean()
    energy_fwd = (x_forward**2).sum(dim=1).mean()
    return dict(
        d_cov_test_to_converged=dist_to(cov(x_test), converged),
        d_cov_forward_to_converged=dist_to(cov(x_forward), converged),
        d_cov_forward_to_wwn=dist_to(cov(x_forward), wwn),
        energy_test=energy_test,
        energy_forward=energy_fwd,
        energy_ratio=energy_fwd / energy_test,
    )


def filter_blowups(x, threshold=1e3):
    """Drop the rows holding a NaN, an inf or an entry with |x| > threshold
    before the metrics. Host-side (the kept count depends on the data);
    returns (the kept rows as a numpy array, the number dropped)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    bad = (~np.isfinite(x)).any(axis=1) | (np.abs(x) > threshold).any(axis=1)
    return x[~bad], int(bad.sum())
