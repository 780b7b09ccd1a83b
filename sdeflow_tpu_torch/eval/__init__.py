"""Evaluation: the ELBO, √MMD and sliced Wasserstein, and the blow-up
filter."""

from sdeflow_tpu_torch.eval.diagnostics import filter_blowups
from sdeflow_tpu_torch.eval.elbo import evaluate
from sdeflow_tpu_torch.eval.mmd import (
    compute_kernel_mean, compute_mmd, sliced_wasserstein)

__all__ = ["compute_kernel_mean", "compute_mmd", "evaluate",
           "filter_blowups", "sliced_wasserstein"]
