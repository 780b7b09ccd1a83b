"""Synthetic data samplers."""

from sdeflow_tpu_torch.data.synthetic import SmoothedGRF, grf_spectral_filter

__all__ = ["SmoothedGRF", "grf_spectral_filter"]
