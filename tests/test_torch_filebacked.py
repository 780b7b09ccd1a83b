"""The file-backed loaders (sdeflow_tpu_torch/data/filebacked.py) against
the JAX package's on the same synthetic fixture files, in the layout of
tests/test_data.py:79-232 (the real ../MSGM-data/ is not bundled): each
loader's train and test arrays exactly equal in float32, its std where it
computes one, its name, dim and sizes; draws of the right shape taken
from the arrays by the generator; the missing-file error naming the path
and SDEFLOW_DATA_ROOT."""

import os

import numpy as np
import pytest
import torch

import jax

from sdeflow_tpu.data import filebacked as jfb
from sdeflow_tpu_torch.data import filebacked as tfb

torch.set_num_threads(1)


def write_l63(root, window_len=16, n_windows=900):
    os.makedirs(root / "L63", exist_ok=True)
    np.save(root / "L63" / "L63_data_X.npy",
            np.random.RandomState(0).randn(window_len, n_windows) * 10)


def write_l96(root):
    np.save(root / "L96_n40_data.npy", np.random.RandomState(0).randn(500, 40)
            * 10)
    np.save(root / "L96_n40_data_test.npy",
            np.random.RandomState(1).randn(200, 40) * 10)


def write_pod(root):
    for i, re_val in enumerate((300, 3900)):
        base = root / "tempPODModes" / f"LES_Re{re_val}"
        for sub, n in (("", 300), ("_test", 100)):
            os.makedirs(base / f"temporalModes_16modes{sub}", exist_ok=True)
            np.save(base / f"temporalModes_16modes{sub}" / "U.npy",
                    np.random.RandomState(2 * i + len(sub)).randn(n, 16))


def write_piv(root, large):
    folder = root / ("largerImage" if large else "newPIV2")
    os.makedirs(folder, exist_ok=True)
    rs = np.random.RandomState(0)
    for i in range(30 if large else 60):
        np.save(folder / f"Serie_{i:03d}_vortdiv.npy",
                rs.randn(2 * 64 * 64 if large else 32))


ERA5_CITIES = ["Paris", "Berlin"]


def write_era5(root, cities=ERA5_CITIES):
    folder = root / "ERA5-cities"
    os.makedirs(folder, exist_ok=True)
    rs = np.random.RandomState(0)
    T = 6 * 365 * 4 // 4  # ~1.5 years of 6-hourly steps
    for city in cities:
        np.save(folder / f"{city}_2m_temperature_2010_2020.npy",
                rs.randn(T) * 7 + 280)
        vort = rs.randn(T) * 3e-5
        vort[5] = np.nan  # the NaN time mask
        np.save(folder / f"{city}_vorticity_2010_2020.npy", vort)
        for comp in ("u", "v"):
            np.save(folder / f"{city}_10m_{comp}_component_of_wind_2010_2020"
                    ".npy", rs.randn(T) * 3)


def write_ncar(root):
    folder = root / "isfs_m2hats_qc_geo_hr_202309"
    os.makedirs(folder, exist_ok=True)
    np.save(folder / "subsample_data.npy",
            np.random.RandomState(0).randn(400, 100) * 3 + 1)


def write_weather(root):
    folder = root / "weather-data-2022-12-05-to-2023-02-27"
    os.makedirs(folder, exist_ok=True)
    rs = np.random.RandomState(0)
    names = ([f"CR300-{i}_Mesures_0{i}" for i in (14, 15)]
             + [f"CR300-{i}_Mesures_{i}" for i in range(559, 572)])
    for k, name in enumerate(names):
        lines = ['"h1"', '"h2"', '"h3"', '"h4"']
        times = (['"2022-12-06 23:55:00"', '"2022-12-07 00:00:00"']
                 + ['"2022-12-07 00:%02d:00"' % m for m in range(5, 60, 5)]
                 + ['"2022-12-07 01:00:00"' if k % 3 else
                    '"2022-12-07 01:05:00"', '"2023-02-26 23:55:00"'])
        for t in times:
            speed = "NAN" if (k == 2 and t.endswith(':20:00"')) else \
                f"{rs.rand() * 10:.3f}"
            lines.append(f"{t},{rs.rand():.2f},{speed},{rs.rand() * 360:.2f}")
        (folder / f"{name}.dat").write_text("\n".join(lines) + "\n")


def write_eof(root):
    from scipy.io import netcdf_file

    with netcdf_file(str(root / "pcs2.nc"), "w") as f:
        f.createDimension("time", 90)
        f.createDimension("mode", 12)
        v = f.createVariable("pseudo_pcs", "f8", ("time", "mode"))
        v[:] = np.random.RandomState(0).randn(90, 12) * 250000


# (name, fixture writer, loader class name, kwargs)
CASES = [
    ("l63", write_l63, "Lorenz63", dict(dim=8)),
    ("l63_norm_few", write_l63, "Lorenz63",
     dict(dim=16, normalized=True, few_data=True, ntrain_max=100)),
    ("l96_norm", write_l96, "Lorenz96", dict(n_dim_l96=40, dim=8,
                                             normalized=True)),
    ("pod_mixed_norm", write_pod, "PODmodes",
     dict(Re=300, dim=8, normalized=True, mixed_times=True)),
    ("pod_concat_few", write_pod, "PODmodes",
     dict(dim=16, concatenate_re=True, few_data=True, ntrain_max=200)),
    ("piv_small", lambda r: write_piv(r, False), "PIV",
     dict(dim=4, localized=True, normalized=True)),
    ("piv_large", lambda r: write_piv(r, True), "PIV",
     dict(dim=16 * 16, large_image=True, smoothing=2)),
    ("era5_deseason_winter", write_era5, "ERA5",
     dict(dim=4, variables=("2m_temperature", "vorticity"),
          cities=ERA5_CITIES, season="winter", use_deseason=True)),
    ("era5_mixed", write_era5, "ERA5",
     dict(dim=6, cities=ERA5_CITIES, mixed_times=True)),
    ("ncar", write_ncar, "NCARWeatherStation", dict(dim=10)),
    ("weather", write_weather, "WeatherStation", dict(dim=8)),
    ("eof_netcdf3", write_eof, "EOFPressure", dict(dim=4)),
]


@pytest.fixture
def data_root(tmp_path):
    root = tmp_path / "MSGM-data"
    root.mkdir()
    prev = jfb.get_data_root(), tfb.get_data_root()
    jfb.set_data_root(str(root))
    tfb.set_data_root(str(root))
    yield root
    jfb.set_data_root(prev[0])
    tfb.set_data_root(prev[1])


@pytest.mark.parametrize("name,write,cls,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_loader_matches_jax_exactly(data_root, name, write, cls, kw):
    write(data_root)
    ref = getattr(jfb, cls)(**kw)
    ours = getattr(tfb, cls)(**kw, device="cpu")
    assert (ours.name, ours.dim) == (ref.name, ref.dim)
    assert (ours.max_nsamples, ours.max_nsamplestest) == (
        ref.max_nsamples, ref.max_nsamplestest)
    for a in ("npdata", "npdatatest", "std", "mean"):
        if hasattr(ref, a):
            got, want = getattr(ours, a), np.asarray(getattr(ref, a))
            assert got.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=a)
        else:
            assert not hasattr(ours, a), a
    g = torch.Generator().manual_seed(0)
    assert ours.sample(g, 5).shape == ref.sample(jax.random.PRNGKey(0),
                                                 5).shape
    assert ours.sampletest(g, 3).shape == (3, ours.npdata.shape[1])


def test_draws_are_rows_of_the_arrays(data_root):
    write_l63(data_root)
    s = tfb.Lorenz63(dim=8, device="cpu")
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    x = s.sample(g, 64)
    g.set_state(state)
    idx = torch.randint(0, s.max_nsamples, (64,), generator=g)
    assert torch.equal(x, s.npdata[idx]) and x.dtype == torch.float32
    xt = s.sampletest(g, 64)
    rows = {tuple(r) for r in s.npdatatest.tolist()}
    assert all(tuple(r) in rows for r in xt.tolist())


def test_missing_file_error_names_the_path(data_root):
    with pytest.raises(FileNotFoundError, match="SDEFLOW_DATA_ROOT") as e:
        tfb.Lorenz63(dim=4, device="cpu")
    assert str(data_root / "L63" / "L63_data_X.npy") in str(e.value)
