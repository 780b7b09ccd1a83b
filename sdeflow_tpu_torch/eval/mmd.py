"""Sample-quality metrics: Gaussian-kernel MMD and sliced Wasserstein.

Port of sdeflow_tpu/eval/mmd.py:25-100. The kernel is
k(x, y) = exp(−‖x−y‖²/d²), the reference's bandwidth; each row block of
x against all of y is formed from the ‖a‖² + ‖b‖² − 2·a·bᵀ expansion, one
``torch.matmul``, so the (N, N) matrix is never materialized. The JAX
package computes these outside any Pallas kernel, so PyTorch's own matmul
and sort are the port here.

Every product runs in IEEE float32 whatever the global TF32 flags say: at
d = 256 each centered kernel mean is near −2/d ≈ −7.8e-3 while MMD² near
the train-to-test floor is about 2.5e-5, so the combination
k̄xx + k̄yy − 2k̄xy keeps about 3e-3 of relative room, which products
rounded to TF32's 10-bit mantissa can use up.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _ieee_fp32():
    """Float32 products in full precision (no TF32) inside the block."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _block_kernel_sum(xb, y, y2, dim, centered):
    """Sum of exp(−‖a−b‖²/d²) (expm1 with centered) over a row block."""
    x2 = torch.sum(xb * xb, dim=1, keepdim=True)
    sq = torch.clamp(x2 + y2 - 2.0 * (xb @ y.T), min=0.0)
    e = -sq / (dim * dim)
    return torch.sum(torch.expm1(e) if centered else torch.exp(e))


def compute_kernel_mean(x, y, block=1024, centered=False):
    """Mean of the Gaussian kernel over all (x_i, y_j) pairs, in row
    blocks of x (the last block holds the remainder rows); a 0-d tensor.

    centered=True returns the mean of k − 1 (expm1 of the exponent): at
    large d every kernel entry is ≈ 1, so means of k lose their
    information to the leading 1, and the centered mean keeps it."""
    n, dim = x.shape
    y2 = torch.sum(y * y, dim=1)[None, :]
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    with _ieee_fp32():
        for i in range(0, n, block):
            total = total + _block_kernel_sum(x[i:i + block], y, y2, dim,
                                              centered)
    return total / (n * y.shape[0])


def compute_mmd(x, y, block=1024):
    """MMD² estimate k̄xx + k̄yy − 2k̄xy (the biased V-statistic, as the
    reference); report √MMD.

    Computed from centered kernel means (k − 1 via expm1): the three 1s
    cancel exactly, so it equals the naive combination in exact arithmetic,
    but the naive one subtracts three numbers near 1 and quantizes MMD² to
    ulp(1) ≈ 6e-8 in float32, where the centered one resolves it."""
    kxx = compute_kernel_mean(x, x, block=block, centered=True)
    kyy = compute_kernel_mean(y, y, block=block, centered=True)
    kxy = compute_kernel_mean(x, y, block=block, centered=True)
    return kxx + kyy - 2.0 * kxy


def sliced_wasserstein(generator, x, y, num_projections=128, p=2,
                       dirs=None):
    """Sliced Wasserstein-p distance over random 1-D projections: both
    sets projected onto `num_projections` unit directions (one (N, d) ×
    (d, L) product each), sorted along the samples, and the p-th power
    quantile differences averaged. The directions are normal draws from
    `generator`, normalized, unless `dirs` (d, L) gives them (they are
    normalized here either way). Needs equal sample counts."""
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"sliced_wasserstein needs equal sample counts, "
                         f"got {x.shape[0]} and {y.shape[0]}")
    if dirs is None:
        dirs = torch.randn((x.shape[1], num_projections), generator=generator,
                           device=x.device, dtype=x.dtype)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=0, keepdim=True)
    with _ieee_fp32():
        px = torch.sort(x @ dirs, dim=0).values
        py = torch.sort(y @ dirs, dim=0).values
    return torch.mean(torch.abs(px - py) ** p) ** (1.0 / p)
