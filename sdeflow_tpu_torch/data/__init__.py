"""Synthetic data samplers."""

from sdeflow_tpu_torch.data.synthetic import (
    Cauchy, Gaussian, GaussianCauchy, SmoothedGRF, SwissRoll,
    grf_spectral_filter)

__all__ = ["Cauchy", "Gaussian", "GaussianCauchy", "SmoothedGRF",
           "SwissRoll", "grf_spectral_filter"]
