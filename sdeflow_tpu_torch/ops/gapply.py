"""Multiplicative-noise tensor G: construction and application.

Port of sdeflow_tpu/ops/gapply.py:41-102. The MSGM diffusion operator is
g(t,y)·w = √β(t) · Σ_{j,k} G[i,j,k] y_j w_k with skew-symmetric slices
G[:,:,k]. The dense G (d ≤ ~32) is a random (d, d, d) tensor normalized so
that tr(L_G) = −d/2; its action is two matrix products, never a (B, d, d)
tensor per sample. The circulant G has G[k, k+1, k] = c and
G[k+1, k, k] = −c, so its action is a two-roll stencil (kernel K1 on the
card, ops/kernels/circulant.py); ``circulant_ijk`` and ``circulant_dense``
give its COO indices and its dense form for checks.
"""

from __future__ import annotations

import math

import torch

# circulant slice coefficient c = √2/2, chosen so tr(L_G) = −d/2
# (sdeflow_tpu/ops/gapply.py:35-38)
CIRCULANT_COEF = math.sqrt(2.0) / 2.0


def dense_ito_tensor(G):
    """L_G = ½ Σ_k G_k @ G_k, (n, n)."""
    return 0.5 * torch.einsum("ijk,jmk->im", G, G)


def make_dense_G(generator, n, dtype=torch.float32):
    """A random dense G (n, n, n) with skew-symmetric slices G[:,:,k],
    scaled so that tr(L_G) = −n/2, and its Itô tensor L_G (n, n), drawn
    from `generator` on its device."""
    F = torch.randn((n, n, n), generator=generator, dtype=dtype,
                    device=generator.device)
    G = 0.5 * (F - F.permute(1, 0, 2))
    tr_L = torch.trace(dense_ito_tensor(G))
    G = torch.sqrt(-0.5 * n / tr_L) * G
    return G, dense_ito_tensor(G)


def dense_sigma_apply(G, sqrt_beta, y, w):
    """(g·w)_i = √β Σ_{j,k} G[i,j,k] y_j w_k for G (d, d, d), sqrt_beta a
    number or (B, 1), y and w (B, d): (B, d). Two products: G·w, the
    (B, d·d) product of w with G's k index, then its (i, j) rows against
    √β·y, a batched matrix-vector product."""
    b, d = y.shape
    gw = (w @ G.permute(2, 0, 1).reshape(d, d * d)).reshape(b, d, d)
    return torch.bmm(gw, (sqrt_beta * y)[:, :, None])[:, :, 0]


def circulant_sigma_apply(sqrt_beta, y, w):
    """(g·w)_i = √β · c · (y_{i+1} w_i − y_{i−1} w_{i−1}), as two rolls."""
    c = CIRCULANT_COEF
    yb = sqrt_beta * y
    return c * (torch.roll(yb, -1, dims=-1) * w - torch.roll(yb * w, 1, dims=-1))


def circulant_ijk(n, device=None):
    """COO (I, J, K, V) of the circulant G: int64 indices and fp32
    values ±c, two entries per slice."""
    k = torch.arange(n, device=device)
    I = torch.stack([k, (k + 1) % n], dim=1).reshape(-1)
    J = torch.stack([(k + 1) % n, k], dim=1).reshape(-1)
    K = torch.stack([k, k], dim=1).reshape(-1)
    c = CIRCULANT_COEF
    V = torch.tensor([c, -c], dtype=torch.float32, device=device).repeat(n)
    return I, J, K, V


def circulant_dense(n, dtype=torch.float32, device=None):
    """The circulant G as a dense (n, n, n) tensor (checks only)."""
    I, J, K, V = circulant_ijk(n, device)
    G = torch.zeros((n, n, n), dtype=dtype, device=device)
    G.index_put_((I, J, K), V.to(dtype), accumulate=True)
    return G
