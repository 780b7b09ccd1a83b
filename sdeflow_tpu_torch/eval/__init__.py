"""Evaluation: the ELBO, √MMD and sliced Wasserstein, the blow-up filter,
and the exact PF-ODE likelihood (``eval/nll.py``)."""

from sdeflow_tpu_torch.eval.diagnostics import filter_blowups
from sdeflow_tpu_torch.eval.elbo import evaluate
from sdeflow_tpu_torch.eval.mmd import (
    compute_kernel_mean, compute_mmd, sliced_wasserstein)

__all__ = ["compute_kernel_mean", "compute_mmd", "evaluate",
           "filter_blowups", "sliced_wasserstein"]
