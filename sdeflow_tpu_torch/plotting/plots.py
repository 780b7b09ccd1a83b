"""The figures of a sweep and the numbers behind them.

Port of sdeflow_tpu/plotting/plots.py:38-545 (the reference's
own_plotting.py), with its figure vocabulary and file names: 2D log-scale
histogram maps and the noising and denoising film strips, the corner pair
grids with per-dimension axis limits, the forward-convergence covariance
panels, the per-step image or signal plots, the survival curves, and the
post-generation pipeline.

Each figure is made in two steps. Its numbers come first, in numpy on the
host or in torch on the samples' device: ``histogram_2d`` (one panel of a
film strip), ``def_pd`` (a pair grid's columns), ``step_histogram`` and
``kde_curve`` (a pair grid's diagonal as seaborn 0.13 draws it),
``covariance_panels``, ``forward_convergence_stats`` and the survival
curves (eval/). Then matplotlib draws them on its Agg backend, imported by
the call that draws (``pyplot``): importing this module loads no
matplotlib, so a host without it runs every computation, and a run that
would draw calls ``require_matplotlib`` before it builds anything. No
seaborn and no pandas: the JAX package's seaborn grids are drawn with
matplotlib, and ``def_pd`` returns a ``Frame``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from sdeflow_tpu_torch.eval.diagnostics import (
    filter_blowups, forward_convergence_stats)
from sdeflow_tpu_torch.eval.mmd import sample_metrics
from sdeflow_tpu_torch.eval.survival import survival_analysis


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pyplot():
    """matplotlib's pyplot on the Agg backend (files, no display),
    imported at the first figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def require_matplotlib():
    """Raise ImportError, naming the way to run without figures, where
    matplotlib is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the plots need matplotlib, which is not installed here: run "
            "with --no-plots (make_plots=False) to skip every figure") from e


# ---------------------------------------------------------------------------
# 2D histogram maps and film strips (reference: own_plotting.py:23-126)
# ---------------------------------------------------------------------------


def histogram_2d(data, val=3, offset_dimplot=0, num=64, vmin=0, vmax=10,
                 logscale=True):
    """The numbers of one film-strip panel: the 2D histogram of column
    offset_dimplot against the next one (d < 3) or the one after it (val
    halved) over [−val, val]² in num bins a side; with logscale the log
    counts, vmin the log of half the smallest count above the least and
    vmax the largest. Returns (heatmap, extent, vmin, vmax)."""
    data = _np(data)
    x = data[:, offset_dimplot]
    if (offset_dimplot + data.shape[1]) < 3:
        y = data[:, offset_dimplot + 1]
    else:
        y = data[:, offset_dimplot + 2]
        val = val / 2

    heatmap, xedges, yedges = np.histogram2d(
        x, y, range=[[-val, val], [-val, val]], bins=num)
    if logscale:
        if (heatmap > heatmap.min()).any():
            vmin = heatmap[heatmap > heatmap.min()].min() / 2
        heatmap = np.log(heatmap + 1e-10)
        vmin = np.log(vmin) if vmin > 0 else heatmap.min()
        vmax = heatmap.max()
    return heatmap, [xedges[0], xedges[-1], yedges[0], yedges[-1]], vmin, vmax


def get_2d_histogram_plot(data, val=3, offset_dimplot=0, num=64, vmin=0,
                          vmax=10, use_grid=False, origin="lower",
                          logscale=True):
    """One 2D log-density map (``histogram_2d``) drawn to an RGB array
    (h, w, 3) of uint8."""
    heatmap, extent, vmin, vmax = histogram_2d(
        data, val, offset_dimplot, num, vmin, vmax, logscale)
    val = extent[1]  # halved where the panel skips a column
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(heatmap.T, extent=extent, origin=origin, vmin=vmin, vmax=vmax)
    ax.grid(False)
    if use_grid:
        plt.xticks(np.arange(-val, val + 1, step=1))
        plt.yticks(np.arange(-val, val + 1, step=1))
    else:
        plt.xticks([])
        plt.yticks([])
    plt.tight_layout()
    fig.canvas.draw()
    image = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    image = image.reshape((h, w, 4))[:, :, :3]
    plt.close(fig)
    return image


def plot_selected_inds(xs, inds, use_xticks=True, use_yticks=True, lmbd=0.0,
                       offset_dimplot=0, include_t0=False, backward=True,
                       val=3):
    """Film strip of 2D histograms of the trajectory xs (S, N, d) at the
    steps inds (reversed when backward); returns the figure."""
    inds = list(inds)
    l_inds = len(inds)
    iter_inds = list(reversed(inds)) if backward else inds
    imgs = [get_2d_histogram_plot(xs[ind], val, offset_dimplot=offset_dimplot)
            for ind in iter_inds]
    img = np.concatenate(imgs, axis=1)

    height, width, _ = img.shape
    height_per_img = width_per_img = height
    figwidth, fontsize = 25, 15
    if use_xticks:
        xticks = [0.5 * width_per_img + width_per_img * i
                  for i in range(l_inds)]
        offset = 0 if include_t0 else 1
        xticklabels = [rf"$i={ind + offset:d}$" for ind in iter_inds]
    else:
        xticks, xticklabels = [], []
    if use_yticks:
        yticks = [0.5 * height_per_img]
        yticklabels = [rf"$\lambda={lmbd:.2g}$"]
    else:
        yticks, yticklabels = [], []

    plt = pyplot()
    fig = plt.figure(figsize=(figwidth, figwidth * height / width))
    ax = fig.add_subplot(111)
    ax.imshow(img)
    for spine in ax.spines.values():
        spine.set_color("white")
    ax.tick_params(axis="x", colors="white")
    ax.tick_params(axis="y", colors="white")
    plt.xticks(xticks, xticklabels, color="black", fontsize=fontsize)
    plt.yticks(yticks, yticklabels, color="black", fontsize=fontsize)
    return fig


# ---------------------------------------------------------------------------
# Pair grids (reference: own_plotting.py:129-330)
# ---------------------------------------------------------------------------


@dataclass
class Frame:
    """A pair grid's columns, without pandas: values (n, k) and the column
    labels (the JAX DataFrame's ``columns``: columns_plot, else 0..k−1)."""

    values: np.ndarray
    columns: list


def def_pd(xgen, std_norm, std_test_plot, datatype, dimplot=2,
           offset_dimplot=0, crop_data_plot=False, plot_crop=3,
           columns_plot=None):
    """The columns of a pair grid: the samples scaled by std_norm, with
    crop_data_plot the rows inside plot_crop·std_norm·std_test_plot on
    every axis kept, then dimplot columns from offset_dimplot, except
    era5 (dimplot 3: columns 6-8; 6: 6-8 then 0-2) and era5vorttemp
    (dimplot 2: columns 4-5; 4: 4-5 then 0-1); the JAX DataFrame's values
    and columns (own_plotting.py:129-167)."""
    xgen = _np(xgen)
    std_norm = _np(std_norm)
    xgen_plot = std_norm * xgen
    if crop_data_plot:
        limit = plot_crop * std_norm * _np(std_test_plot)
        mask = (np.abs(xgen_plot) < limit).all(axis=1)
        frac_out = 100.0 * (1 - mask.mean())
        print(f"{frac_out} % of samples outside plot limits")
        xgen_plot = xgen_plot[mask]

    if datatype == "era5" and xgen.shape[1] >= 9 and dimplot in (3, 6):
        if dimplot == 6:
            xgen_plot = np.concatenate((xgen_plot[:, 6:9], xgen_plot[:, 0:3]),
                                       axis=1)
        else:
            xgen_plot = xgen_plot[:, 6:9]
    elif (datatype == "era5vorttemp" and xgen.shape[1] >= 6
          and dimplot in (2, 4)):
        if dimplot == 4:
            xgen_plot = np.concatenate((xgen_plot[:, 4:6], xgen_plot[:, 0:2]),
                                       axis=1)
        else:
            xgen_plot = xgen_plot[:, 4:6]
    else:
        xgen_plot = xgen_plot[:, offset_dimplot:offset_dimplot + dimplot]
    columns = (list(columns_plot) if columns_plot is not None
               else list(range(xgen_plot.shape[1])))
    return Frame(xgen_plot, columns)


def step_histogram(x, bins=80):
    """The density histogram of the finite values of x as seaborn's
    ``histplot(element="step")`` draws it: (edges (bins + 1,), heights
    (bins + 1,), the last repeated) for ``fill_between(step="post")``;
    None without a finite value."""
    x = np.asarray(x, dtype=np.float64)
    x = x[np.isfinite(x)]
    if not x.size:
        return None
    heights, edges = np.histogram(x, bins=bins, density=True)
    widths = np.diff(edges)
    left = (edges[:-1] + widths / 2) - widths / 2  # seaborn's edges
    return (np.append(left, left[-1] + widths[-1]),
            np.append(heights, heights[-1]))


def kde_curve(x, gridsize=200, cut=3):
    """The Gaussian KDE of the finite values of x as seaborn 0.13's
    ``kdeplot`` computes it: ``scipy.stats.gaussian_kde`` with Scott's
    factor, evaluated at gridsize points over [min − cut·bw, max + cut·bw],
    bw the kernel's standard deviation. Returns (support, density); None
    for fewer than two points or zero variance (seaborn skips those)."""
    x = np.asarray(x, dtype=np.float64)
    x = x[np.isfinite(x)]
    if x.size < 2 or math.isclose(np.nan_to_num(x.var(ddof=1)), 0):
        return None
    from scipy.stats import gaussian_kde

    kde = gaussian_kde(x, bw_method="scott")
    bw = np.sqrt(kde.covariance.squeeze())
    support = np.linspace(x.min() - bw * cut, x.max() + bw * cut, gridsize)
    return support, kde(support)


def _corner_grid(columns, height):
    """A corner grid of len(columns)² axes (the upper triangle removed),
    labels on the outer axes, no y axis on the diagonal: seaborn's
    PairGrid(corner=True) layout. Returns (pyplot, figure, axes)."""
    plt = pyplot()
    n = len(columns)
    fig, axes = plt.subplots(n, n, figsize=(n * height, n * height),
                             squeeze=False)
    for i in range(n):
        for j in range(n):
            ax = axes[i, j]
            if j > i:
                ax.remove()
                axes[i, j] = None
                continue
            ax.spines[["top", "right"]].set_visible(False)
            if i < n - 1:
                ax.tick_params(labelbottom=False)
            else:
                ax.set_xlabel(str(columns[j]))
            if i == j:
                ax.yaxis.set_visible(False)
            elif j > 0:
                ax.tick_params(labelleft=False)
            else:
                ax.set_ylabel(str(columns[i]))
    return plt, fig, axes


def _axis_limits(axes, std_norm, std_test_plot, plot_xlim, offset_dimplot):
    """x limits on every axis and y limits on the lower triangle:
    ±plot_xlim·std_norm·std_test_plot of each axis' dimension."""
    def lim(k):
        k += offset_dimplot
        return plot_xlim * std_norm[k] * std_test_plot[k]

    for i, row in enumerate(axes):
        for j, ax in enumerate(row):
            if ax is None:
                continue
            ax.set_xlim((-lim(j), lim(j)))
            if j < i:
                ax.set_ylim((-lim(i), lim(i)))


def pairplots(xgen, xtest, std_norm, std_test_plot, datatype, name_simu,
              dimplot=2, offset_dimplot=0, crop_data_plot=False, plot_crop=3,
              plot_xlim=3, plot_ref_pdf=False, pdf_theor=None,
              log_scale_pdf=False, columns_plot=None, dpi=200,
              height_seaborn=2.5, ssize=10):
    """Corner grid of the generated against the test samples: scatters of
    each pair below the diagonal (alpha 0.1, size ssize, rasterized), on
    the diagonal the test set's 80-bin density step histogram (its y
    limits from it, log-scaled with log_scale_pdf) and the generated
    set's KDE, with plot_ref_pdf the normalized pdf_theor dotted; each
    axis at ±plot_xlim·std_norm·std_test_plot (own_plotting.py:170-298).
    Saves ``<name_simu>_multDim.png``."""
    import matplotlib.ticker as mticker

    std_norm = _np(std_norm)
    std_test_plot = _np(std_test_plot)
    kw = dict(dimplot=dimplot, offset_dimplot=offset_dimplot,
              crop_data_plot=crop_data_plot, plot_crop=plot_crop,
              columns_plot=columns_plot)
    test = def_pd(xtest, std_norm, std_test_plot, datatype, **kw)
    gen = def_pd(xgen, std_norm, std_test_plot, datatype, **kw)
    plt, fig, axes = _corner_grid(test.columns, height_seaborn)
    colors = {"test": "C0", "gen.": "C1"}
    n = len(test.columns)
    for i in range(n):
        for j in range(i):
            for frame, label in ((test, "test"), (gen, "gen.")):
                axes[i, j].scatter(frame.values[:, j], frame.values[:, i],
                                   alpha=0.1, s=ssize, edgecolor="none",
                                   rasterized=True, color=colors[label])
        ax = axes[i, i]
        hist = step_histogram(test.values[:, i])
        if hist is not None:
            edges, heights = hist
            ax.fill_between(edges, 0, heights, step="post", alpha=0.25,
                            color=colors["test"])
            ymax = float(heights.max())
            ymin = (heights[heights > 0].min() if log_scale_pdf
                    and (heights > 0).any() else 0)
            if ymax > 0:
                ax.set_ylim(ymin, 1.05 * ymax)
        curve = kde_curve(gen.values[:, i])
        if curve is not None:
            ax.plot(*curve, color=colors["gen."], lw=1.5)
        if plot_ref_pdf and pdf_theor is not None:
            lim = (plot_xlim * std_norm[offset_dimplot]
                   * std_test_plot[offset_dimplot])
            xx = np.linspace(-lim, lim, 2000)
            pdf = pdf_theor(xx)
            pdf = pdf / (pdf.sum() * (xx[1] - xx[0]))
            ax.plot(xx, pdf, color=colors["test"], linestyle=":", lw=1.5)
        if log_scale_pdf:
            ax.set_yscale("log")
    handles = [plt.Line2D([], [], marker="o", linestyle="", color=colors[k],
                          markersize=8, alpha=0.6) for k in ("test", "gen.")]
    fig.legend(handles=handles, labels=["test", "gen."], loc="upper right",
               markerscale=ssize)
    _axis_limits(axes, std_norm, std_test_plot, plot_xlim, offset_dimplot)

    def fmt_tick(val, pos):
        return "" if abs(val) < 1e-8 else f"{val:g}"

    for ax in (a for row in axes for a in row if a is not None):
        ax.xaxis.set_major_locator(mticker.MaxNLocator(nbins=2))
        ax.yaxis.set_major_locator(mticker.MaxNLocator(nbins=2))
        ax.xaxis.set_major_formatter(mticker.FuncFormatter(fmt_tick))
        ax.yaxis.set_major_formatter(mticker.FuncFormatter(fmt_tick))
    fig.tight_layout()
    fig.savefig(name_simu + "_multDim.png", dpi=dpi)
    plt.close(fig)


def pairplots_single(xtest, std_norm, std_test_plot, datatype, name_simu,
                     dimplot=2, offset_dimplot=0, crop_data_plot=False,
                     plot_crop=3, plot_xlim=3, log_scale_pdf=False,
                     columns_plot=None, dpi=200, height_seaborn=2.5, ssize=10,
                     results_dir="results"):
    """Corner grid of one sample set (seaborn's ``pairplot``): scatters
    below the diagonal, count histograms (bins "auto", one y scale) on it,
    each axis at ±plot_xlim·std_norm·std_test_plot (own_plotting.py:
    301-330). Saves ``<results_dir>/<name_simu>.png``."""
    std_norm = _np(std_norm)
    std_test_plot = _np(std_test_plot)
    test = def_pd(xtest, std_norm, std_test_plot, datatype, dimplot=dimplot,
                  offset_dimplot=offset_dimplot,
                  crop_data_plot=crop_data_plot, plot_crop=plot_crop,
                  columns_plot=columns_plot)
    plt, fig, axes = _corner_grid(test.columns, height_seaborn)
    n, top = len(test.columns), 0.0
    for i in range(n):
        for j in range(i):
            axes[i, j].scatter(test.values[:, j], test.values[:, i], s=ssize,
                               color="C0")
        x = test.values[:, i].astype(np.float64)
        x = x[np.isfinite(x)]
        if x.size:
            counts, edges = np.histogram(x, bins="auto")
            axes[i, i].stairs(counts, edges, fill=True, color="C0",
                              alpha=0.75)
            top = max(top, float(counts.max()))
    for i in range(n):
        if top > 0:
            axes[i, i].set_ylim(0, 1.05 * top)
    _axis_limits(axes, std_norm, std_test_plot, plot_xlim, offset_dimplot)
    fig.tight_layout()
    os.makedirs(results_dir, exist_ok=True)
    fig.savefig(os.path.join(results_dir, name_simu + ".png"), dpi=dpi)
    plt.close(fig)


# ---------------------------------------------------------------------------
# Forward-noising diagnostics (reference: own_plotting.py:333-422)
# ---------------------------------------------------------------------------


def covariance_panels(xtest, x_forward):
    """The four matrices of the covariance figure, on the samples' device
    in float64 and returned on the host: cov(xtest), cov(x_forward)
    (unbiased, as np.cov), the converged law var̄·I (var̄ the test
    samples' mean variance) and converged − forward, by title."""
    xt = torch.as_tensor(xtest).double()
    xf = torch.as_tensor(x_forward, device=xt.device).double()
    cov_t, cov_f = torch.cov(xt.T), torch.cov(xf.T)
    conv = xt.var(dim=0, correction=0).mean() * torch.eye(
        xt.shape[1], dtype=torch.float64, device=xt.device)
    return {title: m.cpu().numpy() for title, m in (
        ("Cov(xtest)", cov_t), ("Cov(xgen_forward)", cov_f),
        ("Cov(converged)", conv), ("Cov(converged - forward)", conv - cov_f))}


def preprocessing(xtest, xs_forward, num_steps_forward, name_simu_root,
                  offset_dimplot=0, noising_plots=True,
                  folder_results="results", val_hist=3.0, std_norm=None,
                  std_test_plot=None, log_fn=print):
    """The forward-SDE convergence report of the noising trajectory
    xs_forward (S, N, d) of the test samples: its stats logged, the
    covariance panels (``<name_simu_root>_cov.png``) and, with
    noising_plots, the noising strip (``_Forward.png``) and the per-step
    plots of every eighth step (``plot_signal``) under folder_results.
    Returns the stats as floats."""
    xs_t = torch.as_tensor(xs_forward)
    xt = torch.as_tensor(xtest, device=xs_t.device)
    stats = {k: float(v) for k, v in
             forward_convergence_stats(xt, xs_t[-1]).items()}
    log_fn("dist cov_xtest to cov converged (dist to weak white noise) = "
           f"{stats['d_cov_test_to_converged']}")
    log_fn("dist cov_xgen_forward to cov converged = "
           f"{stats['d_cov_forward_to_converged']}")
    log_fn("dist cov_xgen_forward to weak white noise (w. same var.) = "
           f"{stats['d_cov_forward_to_wwn']}")
    log_fn(f"energy_xtest = {stats['energy_test']}")
    log_fn(f"energy_xgen_forward = {stats['energy_forward']}")
    log_fn(f"energy ratio = {stats['energy_ratio']}")

    panels = covariance_panels(xt, xs_t[-1])
    scale = list(panels.values())[:3]  # the difference panel shares them
    vmin = min(m.min() for m in scale)
    vmax = max(m.max() for m in scale)
    plt = pyplot()
    fig, axs = plt.subplots(1, 4, figsize=(20, 5))
    for ax, (title, mat) in zip(axs, panels.items()):
        im = ax.imshow(mat, cmap="viridis", vmin=vmin, vmax=vmax)
        ax.set_title(title)
        ax.set_xlabel("Dimension")
    fig.colorbar(im, ax=axs).set_label("Covariance value")
    name_fig = os.path.join(folder_results, name_simu_root + "_cov.png")
    os.makedirs(os.path.dirname(name_fig), exist_ok=True)
    fig.savefig(name_fig)
    plt.close("all")

    if noising_plots:
        fig_step = max(1, int(num_steps_forward / 8))
        inds_forward = range(0, num_steps_forward + 1, fig_step)
        stp = (_np(std_test_plot)[offset_dimplot]
               if std_test_plot is not None else 1.0)
        fig = plot_selected_inds(
            xs_t, inds_forward, use_xticks=True, use_yticks=False,
            offset_dimplot=offset_dimplot, include_t0=True, backward=False,
            val=val_hist * stp)
        fig.savefig(os.path.join(folder_results,
                                 name_simu_root + "_Forward.png"))
        plt.close("all")
        prefix = os.path.join(folder_results, name_simu_root + "_Forward")
        plot_signal(xs_t, inds_forward, prefix, std_norm=std_norm,
                    std_test_plot=std_test_plot, time_to_duplicate=0)
    return stats


# ---------------------------------------------------------------------------
# Per-step signal and image plots (reference: own_plotting.py:425-492)
# ---------------------------------------------------------------------------


def plots_vort(U, vmin=-2, vmax=2):
    """Vorticity pcolormesh panel of the image U; returns the figure
    (own_plotting.py:484-492)."""
    plt = pyplot()
    fig, axs = plt.subplots(1, 1, figsize=(6, 5), constrained_layout=True)
    pcm = axs.pcolormesh(U[-1:0:-1, :], shading="auto", vmin=vmin, vmax=vmax)
    axs.set_title("vorticity (1/s)")
    axs.set_aspect("equal")
    fig.colorbar(pcm, ax=axs)
    return fig


def plot_signal(xs, inds, prefix_save, std_norm=None, std_test_plot=None,
                time_to_duplicate=None):
    """Per-step plots of the trajectory xs (S, N, d) at the steps inds:
    an image where d is a square of a side ≥ 16
    (``<prefix>_imageAtt<step>_sample<i>_.png``), else a time series
    (``_timeserieAtt``); nothing for d ≤ 16. One sample a step, ten (at
    most N) at step time_to_duplicate (−1: the last state)
    (own_plotting.py:425-481)."""
    dim = xs[-1].shape[1]
    std_norm = _np(std_norm) if std_norm is not None else np.ones(dim)
    std_test_plot = (_np(std_test_plot) if std_test_plot is not None
                     else np.ones(dim))
    nb_samples = 10 if time_to_duplicate is not None else 1
    nb_samples = min(nb_samples, xs.shape[1])
    if time_to_duplicate == -1:
        time_to_duplicate = xs.shape[0] - 1
    npixelx = int(np.sqrt(dim))
    factor_caxis = (std_norm * std_test_plot).max()
    if dim <= 4**2:
        return
    plt = pyplot()
    is_image = (dim == npixelx**2) and (npixelx >= 16)
    for ind in inds:
        n_loc = nb_samples if ind == time_to_duplicate else 1
        for i in range(n_loc):
            series = std_norm * _np(xs[ind, i]).squeeze()
            if is_image:
                img = series.reshape((npixelx, npixelx), order="F")
                fig = plots_vort(img, -factor_caxis, factor_caxis)
                fig.savefig(f"{prefix_save}_imageAtt{ind}_sample{i}_.png")
            else:
                fig, ax = plt.subplots(figsize=(10, 5))
                ax.plot(np.arange(dim), series)
                ax.set_title(f"Noisy sample at step {ind}")
                ax.set_xlabel("time")
                ax.set_ylabel("Value")
                ax.set_ylim(-2 * factor_caxis, 2 * factor_caxis)
                fig.tight_layout()
                fig.savefig(f"{prefix_save}_timeserieAtt{ind}_sample{i}_.png")
            plt.close("all")


# ---------------------------------------------------------------------------
# Post-generation pipeline (reference: own_plotting.py:494-566)
# ---------------------------------------------------------------------------


def plot_survival_simple(x=None, x_ref=None, std_norm=None, prefix_save="surv",
                         figsize=(3, 2), n_points=200, tail_frac=0.05,
                         tail_k=None, colors=("#1f77b4", "#ff7f0e"),
                         ylim=(1e-3, 1.1), save_png=True, dpi=300):
    """Survival curves S(R) of the test (x_ref) and generated (x) norms,
    with their tail fits (``survival_analysis``); with save_png drawn
    log-log to ``<prefix_save>_survival.png``. Returns the analysis
    (own_plotting.py:688-860)."""
    surv = survival_analysis(x=x, x_ref=x_ref, std_norm=std_norm,
                             n_points=n_points, tail_frac=tail_frac,
                             tail_k=tail_k)
    if not save_png:
        return surv
    plt = pyplot()
    r = surv["R_grid"]
    fig, ax = plt.subplots(figsize=figsize)
    handles, labels = [], []
    for tag, label, color in (("reference", "test", colors[0]),
                              ("generated", "gen.", colors[1])):
        if surv[tag]["S"] is not None:
            (line,) = ax.plot(r, surv[tag]["S"], "-", color=color)
            handles.append(line)
            labels.append(label)
    ax.set_xscale("log")
    ax.set_yscale("log")
    s_ref = surv["reference"]["S"]
    if s_ref is not None and surv["reference"]["N"]:
        norms_ref_max = r[np.argmax(s_ref <= 0)] if (s_ref <= 0).any() \
            else r[-1]
        ax.set_xlim(max(r[0], 1e-12), min(norms_ref_max, 1e2))
    ax.set_xlabel("R")
    ax.set_ylabel(r"$S(R)=\mathbb{P}\left(\|\mathbf{x}\|>R\right)$")
    ax.grid(True, which="both", linestyle=":", linewidth=0.5, alpha=0.6)
    ax.set_ylim(max(ylim[0], 1e-300), ylim[1])
    if handles:
        ax.legend(handles, labels, frameon=False, loc="lower left", fontsize=7)
    fig.tight_layout()
    fig.savefig(f"{prefix_save}_survival.png", bbox_inches="tight", dpi=dpi)
    plt.close(fig)
    return surv


def postprocessing(inds, xs, xtest, std_norm, std_test_plot, datatype,
                   name_simu, dimplot=2, offset_dimplot=0,
                   crop_data_plot=False, plot_crop=3, plot_xlim=3,
                   plot_ref_pdf=False, pdf_theor=None, log_scale_pdf=False,
                   columns_plot=None, scatter_plots=True,
                   denoising_plots=True, include_t0_reverse=True,
                   dpi=200, height_seaborn=1.0, ssize=1.0, lmbd=0.0,
                   val_hist=3.0, save_results=True, first_run=True,
                   mmd_inputs=None, make_plots=True, log_fn=print):
    """One sampling run's trajectory xs (S, N, d): its last state saved to
    ``<name_simu>.npy`` (save_results), the blown-up rows dropped
    (``filter_blowups``, their count logged); with make_plots, the pair
    grid (scatter_plots, first run), the survival figure, the denoising
    strip at the steps inds (denoising_plots, first run) and the per-step
    plots; with mmd_inputs = (x_train, max_n), the metrics
    (``sample_metrics``: the MMD and SWD of the generated and of the train
    samples to the test samples). Returns dict(nan_count, survival, mmd,
    mmd_ref, swd, swd_ref), None where not computed. Without make_plots
    (the CLI's --no-plots) nothing is drawn; the JAX function still draws
    the survival figure and the per-step plots there."""
    xgen = xs[-1]
    if save_results:
        np.save(name_simu + ".npy", _np(xgen))
    xgen, nan_count = filter_blowups(xgen)
    if nan_count > 0:
        log_fn(f"Number of rows with NaN or large value: {nan_count}")

    result = dict(nan_count=nan_count, survival=None, mmd=None, mmd_ref=None,
                  swd=None, swd_ref=None)
    if make_plots:
        if scatter_plots and first_run:
            pairplots(xgen, xtest, std_norm, std_test_plot, datatype,
                      name_simu, dimplot=dimplot,
                      offset_dimplot=offset_dimplot,
                      crop_data_plot=crop_data_plot, plot_crop=plot_crop,
                      plot_xlim=plot_xlim, plot_ref_pdf=plot_ref_pdf,
                      pdf_theor=pdf_theor, log_scale_pdf=log_scale_pdf,
                      columns_plot=columns_plot, dpi=dpi,
                      height_seaborn=height_seaborn, ssize=ssize)
        result["survival"] = plot_survival_simple(
            x=xgen, x_ref=xtest, std_norm=None, prefix_save=name_simu,
            figsize=(3, 2), tail_frac=0.05)
        if denoising_plots and first_run:
            stp = _np(std_test_plot)[offset_dimplot]
            fig = plot_selected_inds(xs, inds, True, False, lmbd,
                                     offset_dimplot=offset_dimplot,
                                     include_t0=include_t0_reverse,
                                     val=val_hist * stp)
            fig.savefig(name_simu + ".png")
            pyplot().close("all")
        plot_signal(xs, inds, name_simu + "_Gen", std_norm=std_norm,
                    std_test_plot=std_test_plot, time_to_duplicate=-1)

    if mmd_inputs is not None:
        x_train, max_n = mmd_inputs
        result.update(sample_metrics(xgen, xtest, x_train, std_norm,
                                     max_n=max_n, log_fn=log_fn))
    return result
