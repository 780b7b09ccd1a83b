"""File-backed dataset samplers (geophysical, fluid and chaotic workloads).

Port of sdeflow_tpu/data/filebacked.py:1-488. Every loader reads and
preprocesses its files once on the host in numpy, then moves the train and
test arrays to the sampler's device once, as float32 tensors
(``ArraySampler``); ``sample(generator, n)`` and ``sampletest(generator,
n)`` gather n rows at uniform indices drawn by ``torch.randint`` on the
generator, which lives on that device.

The data root is a module-level setting: ``set_data_root(path)`` or the
SDEFLOW_DATA_ROOT environment variable (default ``../MSGM-data/``). A
missing file raises FileNotFoundError naming the path it expected. No data
is fetched: the roots that the tests and tools/l63_fixture.py write hold
synthetic files in the same layout.

Neither pandas nor netCDF4 is needed: ERA5's day-of-year and hour-of-day
means are numpy group means (``_remove_group_means``), and EOFPressure
reads NetCDF3 classic files through scipy.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from sdeflow_tpu_torch.ops.kernels.common import resolve_device

_DATA_ROOT = os.environ.get("SDEFLOW_DATA_ROOT", "../MSGM-data/")


def set_data_root(path):
    global _DATA_ROOT
    _DATA_ROOT = str(path)


def get_data_root():
    return _DATA_ROOT


def _require(path):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Dataset file not found: {path}. Set the data root with "
            "sdeflow_tpu_torch.data.set_data_root(...) or SDEFLOW_DATA_ROOT "
            "(default '../MSGM-data/').")
    return path


class ArraySampler:
    """Uniform random-index resampling of in-memory float32 arrays on a
    device: ``npdata`` (train) and ``npdatatest`` (test)."""

    def __init__(self, npdata, npdatatest, dim, name, device="cuda"):
        self.device = resolve_device(device)
        self.npdata = self._tensor(npdata)
        self.npdatatest = self._tensor(npdatatest)
        self.dim = dim
        self.name = name
        self.max_nsamples = int(self.npdata.shape[0])
        self.max_nsamplestest = int(self.npdatatest.shape[0])

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def sample(self, generator, n):
        idx = torch.randint(0, self.max_nsamples, (n,), generator=generator,
                            device=self.device)
        return self.npdata[idx]

    def sampletest(self, generator, n):
        idx = torch.randint(0, self.max_nsamplestest, (n,),
                            generator=generator, device=self.device)
        return self.npdatatest[idx]

    def _set_std(self, npdata, normalized):
        self.std = self._tensor(np.asarray(npdata, np.float32).std(axis=0))
        return self.std

    def get_std(self):
        return self.std

    def _normalize(self):
        """Divide the train and test arrays by ``std``."""
        self.npdata = self.npdata / self.std
        self.npdatatest = self.npdatatest / self.std


def _split_train_test(npdata, few_data=False, ntrain_max=np.inf):
    """Sequential 2:1 train/test split."""
    if few_data:
        n_train = int(min(2 * npdata.shape[0] // 3, ntrain_max))
        n_test = npdata.shape[0] - n_train
    else:
        n_test = npdata.shape[0] // 3
    return npdata[:-n_test], npdata[-n_test:-1]


def _mixed_split(npdata, n_test, seed=0):
    """Random train/test split by a seeded numpy permutation."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(npdata.shape[0])
    return npdata[perm[n_test:]], npdata[perm[:n_test]]


def _remove_group_means(X, labels):
    """X minus the mean of its group (rows sharing a label), column by
    column, NaNs skipped as pandas' groupby mean skips them (a group whose
    column is all NaN has a NaN mean)."""
    _, inv = np.unique(labels, return_inverse=True)
    valid = ~np.isnan(X)
    sums = np.zeros((inv.max() + 1, X.shape[1]))
    counts = np.zeros_like(sums)
    np.add.at(sums, inv, np.where(valid, X, 0.0))
    np.add.at(counts, inv, valid)
    with np.errstate(invalid="ignore", divide="ignore"):
        means = sums / counts
    return X - means[inv]


class ERA5(ArraySampler):
    """ERA5 cities×variables 6-hourly series 2010–2020: per-variable
    scaling, NaN-in-vorticity time masking, Fortran-order (T, V·C) packing,
    optional deseasonalization (day-of-year and hour-of-day means),
    optional winter (DJF) filter, column centering, 2:1 sequential or
    mixed split."""

    VAR_SCALES = {
        "vorticity": 0.00003,
        "10m_u_component_of_wind": 3.0,
        "10m_v_component_of_wind": 3.0,
        "2m_temperature": 7.0,
    }
    DEFAULT_CITIES = [
        "Paris", "Warsaw", "Berlin", "Vienna", "Amsterdam",
        "Stockholm", "Athens", "London", "Madrid", "Rome",
    ]
    DEFAULT_VARIABLES = [
        "10m_u_component_of_wind", "10m_v_component_of_wind",
        "2m_temperature", "vorticity",
    ]

    def __init__(
        self,
        dim=40,
        variables: Optional[Sequence[str]] = None,
        cities: Optional[Sequence[str]] = None,
        season="all",
        start_date="2010-01-01T00",
        use_deseason=False,
        mixed_times=False,
        device="cuda",
    ):
        variables = list(variables or self.DEFAULT_VARIABLES)
        cities = list(cities or self.DEFAULT_CITIES)
        dim = min(dim, len(variables) * len(cities))
        name = "ERA5"
        if len(variables) < 4:
            name += f"{len(variables)}vars"
        if len(cities) < 10:
            name += f"{len(cities)}cities"
        name += str(dim)
        if use_deseason:
            name += "_deseason"
        if season == "winter":
            name += "_DJF"
        if mixed_times:
            name += "mix"

        folder = os.path.join(get_data_root(), "ERA5-cities")
        series = {}
        for city in cities:
            for var in variables:
                path = _require(
                    os.path.join(folder, f"{city}_{var}_2010_2020.npy"))
                arr = np.load(path)
                if var == "vorticity" and arr.ndim == 2 and arr.shape[1] > 1:
                    arr = arr[:, 0]
                arr = arr / self.VAR_SCALES.get(var, 1.0)
                series[(city, var)] = arr.astype(np.float64, copy=False)

        T_len = series[(cities[0], variables[0])].shape[0]
        t0 = np.datetime64(start_date)
        times = np.arange(t0, t0 + np.timedelta64(T_len * 6, "h"),
                          np.timedelta64(6, "h"))

        # mask the times with NaN vorticity in any city
        valid = np.ones(T_len, dtype=bool)
        if "vorticity" in variables:
            for city in cities:
                valid &= ~np.isnan(series[(city, "vorticity")])
        for k in series:
            series[k] = series[k][valid]
        times = times[valid]
        T_len = int(valid.sum())

        # pack (C, V, T) -> (T, V, C) -> Fortran-order (T, V·C)
        data_array = np.zeros((len(cities), len(variables), T_len))
        for i, city in enumerate(cities):
            for j, var in enumerate(variables):
                data_array[i, j] = series[(city, var)]
        X = np.reshape(np.transpose(data_array, (2, 1, 0)),
                       (T_len, len(variables) * len(cities)), order="F")

        if use_deseason:
            X = self.deseasonalize(X, times)

        if season == "winter":
            months = (times.astype("datetime64[M]").astype(int) % 12) + 1
            djf = (months == 12) | (months == 1) | (months == 2)
            X, times = X[djf], times[djf]

        X = X - X.mean(axis=0)
        X = X[:, :dim]
        n_test = X.shape[0] // 3
        if mixed_times:
            train, test = _mixed_split(X, n_test)
        else:
            train, test = X[:-n_test], X[-n_test:-1]
        super().__init__(train, test, dim, name, device)

    @staticmethod
    def deseasonalize(X, times):
        """Remove the annual (day-of-year mean) then the diurnal
        (hour-of-day mean) cycle of X (T, n) at datetime64 `times`."""
        times = np.asarray(times, dtype="datetime64[ns]")
        days = times.astype("datetime64[D]")
        doy = (days - times.astype("datetime64[Y]").astype("datetime64[D]")
               ).astype(np.int64) + 1
        hours = (times - days).astype("timedelta64[h]").astype(np.int64)
        return _remove_group_means(_remove_group_means(X, doy), hours)


class PIV(ArraySampler):
    """PIV vorticity/divergence fields: flat 4×4 mode or largeImage 64×64
    → Gaussian smoothing → subsampled to npixel², Fortran-order flatten,
    /2.5 scaling, centering."""

    def __init__(
        self,
        dim=2,
        normalized=False,
        localized=False,
        large_image=False,
        smoothing=0,
        few_data=False,
        ntrain_max=np.inf,
        device="cuda",
    ):
        name = f"PIV{dim}"
        if large_image:
            name += "largeIm"
            if smoothing == 1:
                name += "smooth"
            elif smoothing == 2:
                name += "superSmooth"
            localized = True
            npixelx = int(np.sqrt(dim))
        elif localized:
            name += "loc"
        if few_data:
            name += f"{ntrain_max}pts"
        if normalized:
            name += "_norm"

        sub = "largerImage" if large_image else (
            "newPIV2" if localized else "newPIV")
        folder = Path(os.path.join(get_data_root(), sub))
        _require(str(folder))

        npixelx_max = 64 if large_image else 4
        dmax = 2 * npixelx_max**2
        cols = []
        for file in sorted(folder.glob("Serie_*_vortdiv.npy")):
            cols.append(np.load(file).reshape(-1, 1))
        if not cols:
            raise FileNotFoundError(f"no Serie_*_vortdiv.npy files in {folder}")
        npdata = np.concatenate(cols, axis=1).T / 2.5
        if npdata.shape[1] != dmax:
            raise ValueError(f"PIV fields of {npdata.shape[1]} values, "
                             f"expected {dmax}")
        npdata = npdata - npdata.mean(axis=0)

        if large_image:
            if dim != npixelx**2:
                raise ValueError(f"Incorrect dim to subsample: {dim}")
            npdata = npdata.reshape(
                (npdata.shape[0], npixelx_max, npixelx_max, 2), order="F")
            npdata = npdata[:, :, :, 0]  # keep vorticity only
            if smoothing > 0:
                from scipy.ndimage import gaussian_filter

                if smoothing == 1:
                    sigmax = npdata.shape[1] // (3 * npixelx)
                else:
                    sigmax = npdata.shape[1] // npixelx
                    npdata = npdata * 4
                npdata = np.stack(
                    [gaussian_filter(img, sigma=sigmax) for img in npdata])
            ix = np.linspace(0, npdata.shape[1] - 1, npixelx, dtype=int)
            iy = np.linspace(0, npdata.shape[2] - 1, npixelx, dtype=int)
            npdata = npdata[:, ix][:, :, iy]
            npdata = npdata.reshape((npdata.shape[0], dim), order="F")
        else:
            npdata = npdata[:, :dim]

        train, test = _split_train_test(npdata, few_data, ntrain_max)
        super().__init__(train, test, dim, name, device)
        self._set_std(npdata, normalized)
        if normalized:
            self._normalize()


class Lorenz63(ArraySampler):
    """Delay-embedded Lorenz-63 X coordinate: ``L63/L63_data_X.npy`` of
    shape (window length, windows), /10, subsampled in time to `dim`,
    centered, 2:1 sequential split."""

    def __init__(self, dim=1000, normalized=False, few_data=False,
                 ntrain_max=np.inf, device="cuda"):
        name = f"L63_{dim}"
        if normalized:
            name += "_norm"
        path = _require(os.path.join(get_data_root(), "L63", "L63_data_X.npy"))
        npdata = np.load(path) / 10.0
        npdata = npdata.T
        if dim < npdata.shape[1]:
            times = range(0, npdata.shape[1] - 1, npdata.shape[1] // dim)
            npdata = npdata[:, times]
        npdata = npdata[:, :dim]
        npdata = npdata - npdata.mean(axis=0)
        train, test = _split_train_test(npdata, few_data, ntrain_max)
        super().__init__(train, test, dim, name, device)
        self._set_std(npdata, normalized)
        if normalized:
            self._normalize()


class Lorenz96(ArraySampler):
    """Lorenz-96 snapshots of an n_dim_l96-variable system, /10, the first
    `dim` variables."""

    def __init__(self, n_dim_l96=100, dim=8, normalized=False,
                 device="cuda"):
        name = f"L96_n{n_dim_l96}{dim}"
        base = os.path.join(get_data_root(), f"L96_n{n_dim_l96}_data")
        npdata = np.load(_require(base + ".npy")) / 10.0
        npdatatest = np.load(_require(base + "_test.npy")) / 10.0
        if normalized:
            std = npdata.std(axis=0)
            npdata, npdatatest = npdata / std, npdatatest / std
        super().__init__(npdata[:, :dim], npdatatest[:, :dim], dim, name,
                         device)
        self._set_std(npdata[:, :dim], normalized)


class PODmodes(ArraySampler):
    """LES temporal POD modes at Reynolds 300/3900, optional Re
    concatenation and mixed split."""

    def __init__(self, Re=300, dim=8, normalized=False, mixed_times=False,
                 concatenate_re=False, few_data=False, ntrain_max=np.inf,
                 device="cuda"):
        re_name = "300-3900" if concatenate_re else str(Re)
        name = f"POD{re_name}{dim}"
        if few_data:
            mixed_times = True
            name += f"{ntrain_max}pts"
        if mixed_times:
            name += "mix"
        if normalized:
            name += "_norm"

        def load_pod(re_val):
            base = os.path.join(get_data_root(), "tempPODModes",
                                f"LES_Re{re_val}", "temporalModes_16modes")
            return (np.load(_require(os.path.join(base, "U.npy"))),
                    np.load(_require(base + "_test/U.npy")))

        if concatenate_re:
            d1, t1 = load_pod(300)
            d2, t2 = load_pod(3900)
            npdata = np.concatenate((d1, (3900 / 300) * d2), axis=0)
            npdatatest = np.concatenate((t1, (3900 / 300) * t2), axis=0)
        else:
            npdata, npdatatest = load_pod(int(Re))

        if mixed_times:
            alldata = np.concatenate((npdata, npdatatest), axis=0)
            if few_data:
                n_train = int(min(2 * alldata.shape[0] // 3, ntrain_max))
                n_test = alldata.shape[0] - n_train
            else:
                n_test = alldata.shape[0] // 3
            npdata, npdatatest = _mixed_split(alldata, n_test)

        npdata, npdatatest = npdata / 10.0, npdatatest / 10.0
        npdata, npdatatest = npdata[:, :dim], npdatatest[:, :dim]
        super().__init__(npdata, npdatatest, dim, name, device)
        self.mean = self._tensor(npdata.mean(axis=0).astype(np.float32))
        self._set_std(npdata, normalized)
        if normalized:
            self._normalize()


class NCARWeatherStation(ArraySampler):
    """NCAR M2HATS station subsample, standardized per column."""

    def __init__(self, dim=90, device="cuda"):
        path = _require(os.path.join(
            get_data_root(), "isfs_m2hats_qc_geo_hr_202309",
            "subsample_data.npy"))
        npdata = np.load(path)
        npdata = (npdata - npdata.mean(axis=0)) / npdata.std(axis=0)
        npdata = npdata[:-1, :dim]
        n_test = npdata.shape[0] // 3
        super().__init__(npdata[:-n_test], npdata[-n_test:-1], dim,
                         f"ncar_weather{dim}", device)


class WeatherStation(ArraySampler):
    """Campbell CR300 station logs: .dat parsing, timestamp intersection,
    polar→cartesian wind, standardized per column."""

    def __init__(self, dim=30, device="cuda"):
        folder = os.path.join(get_data_root(),
                              "weather-data-2022-12-05-to-2023-02-27")
        _require(folder)
        file_names = [f"CR300-{i}_Mesures_0{i}" for i in range(14, 16)] + [
            f"CR300-{i}_Mesures_{i}" for i in range(559, 572)]
        begin_time, last_time = '"2022-12-07 00:00:00"', '"2023-02-26 23:55:00"'
        npdata_all, timestamps_keep = None, None
        for file in file_names:
            path = _require(os.path.join(folder, file + ".dat"))
            data = np.genfromtxt(
                path, delimiter=",", skip_header=4, dtype=None,
                encoding="utf-8", missing_values='"NAN"', filling_values=np.nan)
            timestamps = data["f0"]
            vals = np.array([list(row)[1:] for row in data], dtype=float)
            b = np.where(timestamps == begin_time)[0][0]
            e = np.where(timestamps == last_time)[0][0]
            timestamps, vals = timestamps[b:e + 1], vals[b:e + 1, 1:3]
            v0 = vals.copy()
            vals[:, 0] = v0[:, 0] * np.cos((np.pi / 180.0) * v0[:, 1])
            vals[:, 1] = v0[:, 0] * np.sin((np.pi / 180.0) * v0[:, 1])
            if npdata_all is None:
                timestamps_keep, npdata_all = timestamps, vals.copy()
            else:
                prev = timestamps_keep
                timestamps_keep = np.intersect1d(timestamps_keep, timestamps)
                i1 = np.where(np.isin(timestamps, timestamps_keep))[0]
                i2 = np.where(np.isin(prev, timestamps_keep))[0]
                npdata_all = np.concatenate((npdata_all[i2], vals[i1].copy()),
                                            axis=1)
        npdata = (npdata_all - npdata_all.mean(axis=0)) / npdata_all.std(axis=0)
        npdata = npdata[:-1, :dim]
        n_test = npdata.shape[0] // 3
        super().__init__(npdata[:-n_test], npdata[-n_test:-1], dim,
                         f"weather{dim}", device)


def _read_netcdf_var(path, varname):
    """One variable of a NetCDF3 classic file, read by scipy. A NetCDF4
    (HDF5) file raises ValueError: convert it to NetCDF3 first."""
    from scipy.io import netcdf_file

    try:
        with netcdf_file(path, "r", mmap=False) as ds:
            return np.array(ds.variables[varname][:])
    except TypeError as e:  # scipy's error for a file that is not NetCDF3
        raise ValueError(
            f"{path}: not a NetCDF3 classic file (scipy reads NetCDF3 "
            "only; convert a NetCDF4/HDF5 file, e.g. with nccopy -k "
            "classic)") from e


class EOFPressure(ArraySampler):
    """North-Atlantic pressure pseudo-PCs (``pcs2.nc``, NetCDF3), /250000."""

    def __init__(self, dim=8, device="cuda"):
        path = _require(os.path.join(get_data_root(), "pcs2.nc"))
        npdata = _read_netcdf_var(path, "pseudo_pcs")
        npdata = npdata[:-1, :dim] / 250000
        n_test = npdata.shape[0] // 3
        super().__init__(npdata[:-n_test], npdata[-n_test:-1], dim,
                         f"eof_pressure_NA{dim}", device)
