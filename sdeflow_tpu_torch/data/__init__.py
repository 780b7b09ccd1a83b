"""Data samplers: the synthetic distributions and the file-backed datasets."""

from sdeflow_tpu_torch.data.filebacked import (
    ERA5, PIV, ArraySampler, EOFPressure, Lorenz63, Lorenz96,
    NCARWeatherStation, PODmodes, WeatherStation, get_data_root,
    set_data_root)
from sdeflow_tpu_torch.data.synthetic import (
    Cauchy, Gaussian, GaussianCauchy, SmoothedGRF, SwissRoll,
    grf_spectral_filter)

__all__ = ["ArraySampler", "Cauchy", "EOFPressure", "ERA5", "Gaussian",
           "GaussianCauchy", "Lorenz63", "Lorenz96", "NCARWeatherStation",
           "PIV", "PODmodes", "SmoothedGRF", "SwissRoll", "WeatherStation",
           "get_data_root", "grf_spectral_filter", "set_data_root"]
