"""ERA5's deseasonalization in numpy (sdeflow_tpu_torch/data/filebacked.py
``ERA5.deseasonalize``: day-of-year then hour-of-day group means) against
the JAX package's pandas groupby version, to 1e-12 in float64: 6-hourly
times over a leap year, times with gaps (the NaN-vorticity mask drops
some), hourly times, and NaN entries, which both skip in their means."""

import numpy as np
import pytest

from sdeflow_tpu.data.filebacked import ERA5 as JaxERA5
from sdeflow_tpu_torch.data.filebacked import ERA5


def _times(start, n, step_h):
    t0 = np.datetime64(start)
    return np.arange(t0, t0 + np.timedelta64(n * step_h, "h"),
                     np.timedelta64(step_h, "h"))


@pytest.mark.parametrize("case", ["six_hourly_leap", "gaps", "hourly",
                                  "nans"])
def test_deseasonalize_matches_pandas(case):
    rng = np.random.default_rng(0)
    step = 1 if case == "hourly" else 6
    times = _times("2011-06-01T00", 4 * 365 * 24 // step, step)
    if case in ("gaps", "nans"):
        times = times[rng.random(times.size) > 0.3]
    doy = (times - times.astype("datetime64[Y]")).astype(
        "timedelta64[D]").astype(int)
    X = (5.0 * np.sin(2 * np.pi * doy / 365.25)[:, None]
         + rng.standard_normal((times.size, 7)) * 3.0 + 280.0)
    if case == "nans":
        X[rng.random(X.shape) < 0.01] = np.nan
    ref = JaxERA5.deseasonalize(X, times)
    out = ERA5.deseasonalize(X, times)
    assert out.shape == ref.shape and out.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
