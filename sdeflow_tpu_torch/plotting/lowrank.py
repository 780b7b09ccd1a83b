"""Low-rank tensor latent-dynamics figures.

Port of sdeflow_tpu/plotting/lowrank.py:21-125 (the reference's
standalone ``LowRankTensorPlot.py``): the analytic simulation of the 4-D
block-rotation MSGM latent dynamics (two rotation speeds λ1, λ2 driven by
one shared Brownian motion), numpy on the host on the same
``RandomState(seed)`` stream as the JAX package's, so bit for bit with it,
and the 2D and 3D scatter figures, drawn by matplotlib (imported by
``make_figures``).
"""

from __future__ import annotations

import os

import numpy as np

from sdeflow_tpu_torch.plotting.plots import pyplot


def simulate_block_rotation(T=100.0, N=20000, lambda1=1.0, lambda2=10.0,
                            trajectory=False, from_uniform=False,
                            random_init=False, init_value=1.0,
                            kill_dim34=False, seed=0):
    """Analytic solution of the d = 4 block-rotation SDE dY = G(Y)∘dB with
    G two rotation generators at speeds λ1, λ2: each 2-plane rotates by
    the angle √d·λ_i·B (λ_i·U with from_uniform, U uniform on [0, 1000)).
    With trajectory, one path of N steps of dt = T/N from one start;
    otherwise N − 1 independent draws of B ~ N(0, T) (the first and last
    of N + 1 dropped, as the reference does). Returns (x1, x2, x3, x4)."""
    d = 4
    sqrt_d = np.sqrt(d)
    rng = np.random.RandomState(seed)
    dt = T / N

    if trajectory:
        n_init = 1
        dW = np.sqrt(dt) * rng.randn(N)
        B = np.concatenate([[0.0], np.cumsum(dW)])
        U = None
    else:
        n_init = N + 1
        if from_uniform:
            U = 1e3 * rng.rand(N + 1)
            B = None
        else:
            B = np.sqrt(T) * rng.randn(N + 1)
            U = None

    if random_init:
        x0 = 1.0 + 0.1 * rng.randn(4, n_init)
    else:
        iv = init_value * (np.sqrt(2) if kill_dim34 else 1.0)
        x0 = np.ones((4, n_init)) * iv
        if kill_dim34:
            x0[2:] = 0.0

    if from_uniform:
        th1, th2 = lambda1 * U, lambda2 * U
    else:
        th1, th2 = sqrt_d * lambda1 * B, sqrt_d * lambda2 * B
    idx = np.zeros(N + 1, dtype=int) if trajectory else np.arange(N + 1)

    x1 = x0[1, idx] * np.sin(th1) + x0[0, idx] * np.cos(th1)
    x2 = x0[1, idx] * np.cos(th1) - x0[0, idx] * np.sin(th1)
    x3 = x0[3, idx] * np.sin(th2) + x0[2, idx] * np.cos(th2)
    x4 = x0[3, idx] * np.cos(th2) - x0[2, idx] * np.sin(th2)

    if not trajectory:
        x1, x2, x3, x4 = x1[1:-1], x2[1:-1], x3[1:-1], x4[1:-1]
    return x1, x2, x3, x4


def make_figures(out_dir=".", fig_size=2, **kwargs):
    """The four 2D scatters (x1_x2, x1_x3, x1_x4, x4_x3: the last three
    on the first's limits) and the 3D scatter (x1_x2_x3) of
    ``simulate_block_rotation(**kwargs)`` as PNG files under out_dir;
    returns their paths."""
    plt = pyplot()
    x1, x2, x3, x4 = simulate_block_rotation(**kwargs)
    col = "#1f77b4"
    os.makedirs(out_dir, exist_ok=True)
    paths = []

    def scatter2d(a, b, la, lb, name, lims=None):
        plt.figure(figsize=(fig_size, fig_size))
        plt.scatter(a, b, s=3, c=col, alpha=0.25, edgecolors="none")
        if lims is None:
            plt.axis("equal")
            out = plt.xlim(), plt.ylim()
        else:
            plt.xlim(lims[0])
            plt.ylim(lims[1])
            out = lims
        plt.xlabel(la)
        plt.ylabel(lb)
        plt.tight_layout()
        p = os.path.join(out_dir, name)
        plt.savefig(p)
        plt.close()
        paths.append(p)
        return out

    lims = scatter2d(x1, x2, r"$x_1$", r"$x_2$", "x1_x2.png")
    scatter2d(x1, x3, r"$x_1$", r"$x_3$", "x1_x3.png", lims)
    scatter2d(x1, x4, r"$x_1$", r"$x_4$", "x1_x4.png", lims)
    scatter2d(x4, x3, r"$x_4$", r"$x_3$", "x4_x3.png", lims)

    fig = plt.figure(figsize=(4, 2))
    ax = fig.add_subplot(111, projection="3d")
    z_norm = (x3 - x3.min()) / (x3.max() - x3.min() + 1e-9)
    colors = plt.cm.Blues(0.3 + 0.7 * z_norm)
    ax.scatter(x1, x2, x3, s=6, c=colors, edgecolors="none",
               depthshade=True, alpha=0.85)
    ax.set_xlabel(r"$x_1$", labelpad=3, fontsize=8)
    ax.set_ylabel(r"$x_2$", labelpad=3, fontsize=8)
    ax.set_zlabel(r"$x_3$", labelpad=3, fontsize=8)
    ax.grid(False)
    fig.subplots_adjust(left=0.0, right=0.95, bottom=0.23, top=0.95)
    p = os.path.join(out_dir, "x1_x2_x3.png")
    fig.savefig(p, dpi=300, pad_inches=0.1)
    plt.close(fig)
    paths.append(p)
    return paths


if __name__ == "__main__":
    print(make_figures())
