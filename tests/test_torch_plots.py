"""The port's figures (sdeflow_tpu_torch/plotting/plots.py) against the JAX
package's on the same numpy draws: a 2D histogram map pixel for pixel;
``def_pd`` against the JAX DataFrame's values and columns exactly (the
generic, crop, era5 and era5vorttemp cases); the pair grid's diagonal
(the test set's step histogram and the generated set's KDE) within 1e-6
relative of the lines seaborn draws in the JAX figure, and every axis
limit equal, each figure captured at its ``savefig``; ``preprocessing``'s
statistics within 1e-6 relative and its file names; ``plot_signal``'s
file set (images at d = 256, time series at d = 1000, none at d ≤ 16);
the survival curves of ``plot_survival_simple`` (grid to 1e-6, S and
counts exactly); ``postprocessing``'s blow-up count exactly and its MMDs
within the metrics' tolerance (rtol 1e-4, atol 1e-9; SWD draws its
directions from another generator than JAX's), and the files of each."""

import os

import numpy as np
import pytest
import torch
from matplotlib.collections import PathCollection, PolyCollection
from matplotlib.figure import Figure

import jax.numpy as jnp

from sdeflow_tpu.plotting import plots as jax_plots
from sdeflow_tpu_torch.plotting import plots

torch.set_num_threads(1)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture
def captured(monkeypatch):
    """Figures saved while the fixture is active, not written."""
    figs = []
    monkeypatch.setattr(Figure, "savefig",
                        lambda self, *a, **k: figs.append(self))
    return figs


@pytest.mark.parametrize("d", [2, 5])
def test_histogram_map_is_jax_pixel_for_pixel(d):
    x = (1.3 * np.random.default_rng(d).standard_normal((500, d))).astype(
        np.float32)
    ref = jax_plots.get_2d_histogram_plot(x, val=3)
    out = plots.get_2d_histogram_plot(torch.from_numpy(x), val=3)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("case", ["generic", "crop", "era5", "era5vorttemp"])
def test_def_pd_is_the_jax_frame(case, capsys):
    rng = np.random.default_rng(1)
    x = (2.0 * rng.standard_normal((64, 10))).astype(np.float32)
    sn = np.linspace(0.5, 1.5, 10).astype(np.float32)
    stp = x.std(axis=0)
    kws = {"generic": [dict(dimplot=3, offset_dimplot=2),
                       dict(dimplot=2, columns_plot=[7, 8])],
           "crop": [dict(dimplot=4, crop_data_plot=True, plot_crop=1.5)],
           "era5": [dict(dimplot=3), dict(dimplot=6, columns_plot=list(
               range(1, 7)))],
           "era5vorttemp": [dict(dimplot=2), dict(dimplot=4)]}[case]
    for kw in kws:
        ref = jax_plots.def_pd(x, sn, stp, case, **kw)
        out = plots.def_pd(torch.from_numpy(x), torch.from_numpy(sn),
                           torch.from_numpy(stp), case, **kw)
        assert out.values.dtype == ref.values.dtype
        np.testing.assert_array_equal(out.values, ref.values)
        assert out.columns == list(ref.columns)
    if case == "crop":
        assert capsys.readouterr().out.count("outside plot limits") == 2


def _grid(fig):
    """(diagonal axes, lower axes), each row by row: the diagonal holds
    the histogram's fill, the lower triangle the scatters."""
    def key(ax):
        p = ax.get_position()
        return (-round(p.y0, 4), round(p.x0, 4))

    def holding(kind):
        return sorted((ax for ax in fig.axes if any(
            isinstance(c, kind) for c in ax.collections)), key=key)

    return holding(PolyCollection), holding(PathCollection)


def test_pair_grid_diagonal_and_limits_match_seaborn(tmp_path, captured):
    rng = np.random.default_rng(2)
    xtest = rng.standard_normal((300, 3)).astype(np.float32)
    xgen = (1.2 * rng.standard_normal((250, 3)) + 0.1).astype(np.float32)
    sn = np.array([1.0, 2.0, 0.5], np.float32)
    stp = xtest.std(axis=0)
    kw = dict(dimplot=3, log_scale_pdf=True, columns_plot=[1, 2, 3],
              height_seaborn=1.0, ssize=1.0)
    jax_plots.pairplots(xgen, jnp.asarray(xtest), sn, stp, "toy",
                        str(tmp_path / "jax"), **kw)
    plots.pairplots(xgen, torch.from_numpy(xtest), torch.from_numpy(sn),
                    torch.from_numpy(stp), "toy", str(tmp_path / "torch"),
                    **kw)
    assert len(captured) == 2
    (jdiag, jlower), (tdiag, tlower) = map(_grid, captured)
    assert len(jdiag) == len(tdiag) == 3 and len(jlower) == len(tlower) == 3
    for ja, ta in zip(jdiag, tdiag):
        jfill, = [c for c in ja.collections if isinstance(c, PolyCollection)]
        tfill, = [c for c in ta.collections if isinstance(c, PolyCollection)]
        np.testing.assert_allclose(tfill.get_paths()[0].vertices,
                                   jfill.get_paths()[0].vertices, rtol=1e-6)
        (jline,), (tline,) = ja.get_lines(), ta.get_lines()
        np.testing.assert_allclose(tline.get_xdata(), jline.get_xdata(),
                                   rtol=1e-6)
        np.testing.assert_allclose(tline.get_ydata(), jline.get_ydata(),
                                   rtol=1e-6)
        assert ta.get_xlim() == ja.get_xlim()
        assert ta.get_ylim() == ja.get_ylim()
        assert ta.get_yscale() == ja.get_yscale() == "log"
    for ja, ta in zip(jlower, tlower):
        assert ta.get_xlim() == ja.get_xlim()
        assert ta.get_ylim() == ja.get_ylim()


def test_single_pair_grid_is_written_under_the_jax_name(tmp_path):
    x = np.random.default_rng(3).standard_normal((100, 3)).astype(np.float32)
    ones = np.ones(3, np.float32)
    for root, mod in (("jax", jax_plots), ("torch", plots)):
        mod.pairplots_single(x, ones, ones, "toy", "grf16", dimplot=3,
                             columns_plot=[1, 2, 3],
                             results_dir=str(tmp_path / root))
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax") == [
        "grf16.png"]


def test_preprocessing_stats_and_files_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((5, 200, 3)).astype(np.float32)
    xs[0] = 0.5 * xs[0] + 1.0
    xtest = xs[0].copy()
    ones = np.ones(3, np.float32)
    jlog, tlog = [], []
    ref = jax_plots.preprocessing(
        jnp.asarray(xtest), jnp.asarray(xs), 4, "toy/run",
        folder_results=str(tmp_path / "jax"), std_norm=ones,
        std_test_plot=ones, log_fn=jlog.append)
    out = plots.preprocessing(
        torch.from_numpy(xtest), torch.from_numpy(xs), 4, "toy/run",
        folder_results=str(tmp_path / "torch"),
        std_norm=torch.from_numpy(ones), std_test_plot=torch.from_numpy(ones),
        log_fn=tlog.append)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k] == pytest.approx(ref[k], rel=1e-6), k
    assert [m.split(" = ")[0] for m in tlog] == [
        m.split(" = ")[0] for m in jlog]
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax") == [
        "toy/run_Forward.png", "toy/run_cov.png"]


@pytest.mark.parametrize("d,kind", [(256, "image"), (1000, "timeserie"),
                                    (16, None)])
def test_plot_signal_writes_the_jax_file_set(tmp_path, d, kind):
    xs = np.random.default_rng(5).standard_normal((3, 3, d)).astype(
        np.float32)
    for root, mod, arr in (("jax", jax_plots, xs),
                           ("torch", plots, torch.from_numpy(xs))):
        os.makedirs(tmp_path / root)
        mod.plot_signal(arr, [0, 2], str(tmp_path / root / "sig"),
                        time_to_duplicate=-1)
    names = _files(tmp_path / "torch")
    assert names == _files(tmp_path / "jax")
    if kind is None:
        assert names == []
    else:  # one sample at step 0, all three (ten at most) at the last
        assert len(names) == 4
        assert all(f"_{kind}Att" in n for n in names)


def test_survival_curves_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    x = rng.standard_t(3.0, (500, 8)).astype(np.float32)
    x_ref = rng.standard_t(3.0, (600, 8)).astype(np.float32)
    ref = jax_plots.plot_survival_simple(x=x, x_ref=x_ref,
                                         prefix_save=str(tmp_path / "j"))
    out = plots.plot_survival_simple(x=torch.from_numpy(x),
                                     x_ref=torch.from_numpy(x_ref),
                                     prefix_save=str(tmp_path / "t"))
    np.testing.assert_allclose(out["R_grid"], ref["R_grid"], rtol=1e-6)
    for tag in ("reference", "generated"):
        assert out[tag]["N"] == ref[tag]["N"]
        np.testing.assert_array_equal(out[tag]["counts"], ref[tag]["counts"])
        np.testing.assert_array_equal(out[tag]["S"], ref[tag]["S"])
        assert out["fits"][tag]["alpha"] == pytest.approx(
            ref["fits"][tag]["alpha"], rel=1e-5)
    assert (tmp_path / "t_survival.png").stat().st_size > 0


def test_postprocessing_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((5, 120, 3)).astype(np.float32)
    xs[-1, 3] = np.nan
    xs[-1, 7, 1] = 5e3
    xtest = rng.standard_normal((120, 3)).astype(np.float32)
    xtrain = rng.standard_normal((120, 3)).astype(np.float32)
    ones = np.ones(3, np.float32)
    kw = dict(dimplot=3, columns_plot=[1, 2, 3], log_fn=lambda *_: None)
    os.makedirs("jax")
    os.makedirs("torch")
    ref = jax_plots.postprocessing(
        [0, 2, 4], jnp.asarray(xs), jnp.asarray(xtest), ones, ones, "toy",
        "jax/sim", mmd_inputs=(xtrain, 100), **kw)
    out = plots.postprocessing(
        [0, 2, 4], torch.from_numpy(xs), torch.from_numpy(xtest),
        torch.from_numpy(ones), torch.from_numpy(ones), "toy", "torch/sim",
        mmd_inputs=(torch.from_numpy(xtrain), 100), **kw)
    assert out["nan_count"] == ref["nan_count"] == 2
    for k in ("mmd", "mmd_ref"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-9)
    assert np.isfinite([out["swd"], out["swd_ref"]]).all()
    assert out["survival"]["generated"]["N"] == 118
    assert _files("torch") == _files("jax") == [
        "sim.npy", "sim.png", "sim_multDim.png", "sim_survival.png"]
    np.testing.assert_array_equal(np.load("torch/sim.npy"), xs[-1])
