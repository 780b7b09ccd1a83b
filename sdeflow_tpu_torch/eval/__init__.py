"""Evaluation: the ELBO, √MMD and sliced Wasserstein, the blow-up filter,
the forward-convergence statistics, the survival curves and tail fits,
and the exact PF-ODE likelihood (``eval/nll.py``)."""

from sdeflow_tpu_torch.eval.diagnostics import (
    filter_blowups, forward_convergence_stats)
from sdeflow_tpu_torch.eval.elbo import evaluate
from sdeflow_tpu_torch.eval.mmd import (
    compute_kernel_mean, compute_mmd, sliced_wasserstein)
from sdeflow_tpu_torch.eval.survival import (
    survival_analysis, survival_curve, tail_fit_loglog)

__all__ = ["compute_kernel_mean", "compute_mmd", "evaluate",
           "filter_blowups", "forward_convergence_stats",
           "sliced_wasserstein", "survival_analysis", "survival_curve",
           "tail_fit_loglog"]
