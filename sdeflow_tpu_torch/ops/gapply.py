"""Multiplicative-noise tensor G: the circulant diffusion action.

Port of sdeflow_tpu/ops/gapply.py (circulant case only). The MSGM diffusion
operator is g(t,y)·w = √β(t) · Σ_{j,k} G[i,j,k] y_j w_k with skew-symmetric
slices G[:,:,k]. The circulant G has G[k, k+1, k] = c and G[k+1, k, k] = −c,
so its action is a two-roll stencil, never a materialized tensor.
The dense G comes with ROADMAP Queue 1 item 2 (SDE core).
"""

from __future__ import annotations

import math

import torch

# circulant slice coefficient c = √2/2, chosen so tr(L_G) = −d/2
# (sdeflow_tpu/ops/gapply.py:35-38)
CIRCULANT_COEF = math.sqrt(2.0) / 2.0


def circulant_sigma_apply(sqrt_beta, y, w):
    """(g·w)_i = √β · c · (y_{i+1} w_i − y_{i−1} w_{i−1}), as two rolls."""
    c = CIRCULANT_COEF
    yb = sqrt_beta * y
    return c * (torch.roll(yb, -1, dims=-1) * w - torch.roll(yb * w, 1, dims=-1))
