"""Adaptive Dormand–Prince 4(5) ODE solve with dense output.

Port of the forward solve of ``jax.experimental.ode.odeint``, which the JAX
package's adaptive PF-ODE paths call (sdeflow_tpu/ops/ode.py:125-153,
sdeflow_tpu/eval/nll.py:160-165): the same initial step (Hairer, Nørsett
and Wanner, Sec. II.4), the Dormand–Prince tableau with first-same-as-last,
one error ratio over the whole state (the RMS over every element of every
tensor of it, as ``odeint`` ravels its pytree: one step size for the whole
batch), the same step-size control (safety 0.9, growth at most 10, shrink
at most 0.2 after a rejection, order 5) and the fourth-order dense output
at the capture times, so that both solvers take the same accepted steps on
the same field. The step size and the clock are float32 numbers on the
host, computed as JAX computes them; each attempt reads its error ratio
back once to accept or reject it.

The state is a tensor or a tuple of tensors (``exact_logp``'s (y, ℓ)).
``func(state, t)`` gets the time as a Python number and returns the
state's derivative in the same structure.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the Dormand–Prince tableau (jax/experimental/ode.py:100-124)
_ALPHA = np.array([1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0, 0.0], np.float32)
_BETA = [
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_C_SOL = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]
_C_ERROR = [35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085,
            125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
            11 / 84 - 649 / 6300, -1.0 / 60.0]
# the midpoint of the dense output (jax/experimental/ode.py:60-67)
_DPS_C_MID = [6025192743 / 30085553152 / 2, 0,
              51252292925 / 65400821598 / 2, -2691868925 / 45128329728 / 2,
              187940372067 / 1594534317056 / 2,
              -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2]

_F32 = np.float32


def _ravel(state):
    """(the flat 1-D tensor, unravel, unravel_stack) of a tensor or a tuple
    of tensors; unravel_stack takes (n, size) to leaves with a leading n."""
    leaves = [state] if isinstance(state, torch.Tensor) else list(state)
    shapes = [leaf.shape for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]

    def unravel(flat):
        parts = [p.reshape(s) for p, s in
                 zip(torch.split(flat, sizes, dim=-1), shapes)]
        return parts[0] if isinstance(state, torch.Tensor) else tuple(parts)

    def unravel_stack(flat):
        parts = [p.reshape(flat.shape[0], *s) for p, s in
                 zip(torch.split(flat, sizes, dim=-1), shapes)]
        return parts[0] if isinstance(state, torch.Tensor) else tuple(parts)

    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    return flat, unravel, unravel_stack


class _Tableau:
    """The tableau's rows as tensors on the state's device, made once a
    solve (a copy from the host between two stages would wait for the
    device)."""

    def __init__(self, like):
        def row(c):
            return torch.tensor(c, dtype=like.dtype, device=like.device)

        self.beta = [row(b) for b in _BETA]
        self.c_sol, self.c_error, self.c_mid = (
            row(c) for c in (_C_SOL, _C_ERROR, _DPS_C_MID))


def _dot(c, k):
    """Σ_i c[i]·k[i] over the rows that the coefficients reach."""
    return c @ k[:c.shape[0]]


def _norm(v):
    return torch.linalg.vector_norm(v)


def initial_step_size(fun, t0, y0, order, rtol, atol, f0):
    """The first step (jax/experimental/ode.py:78-98): one extra
    evaluation of `fun`, two reads of norms to the host."""
    scale = atol + torch.abs(y0) * rtol
    d0, d1 = (_F32(v) for v in torch.stack(
        [_norm(y0 / scale), _norm(f0 / scale)]).tolist())
    h0 = (_F32(1e-6) if (d0 < 1e-5) or (d1 < 1e-5)
          else _F32(0.01) * d0 / d1)
    y1 = y0 + float(h0) * f0
    f1 = fun(y1, float(t0 + h0))
    d2 = _F32(_norm((f1 - f0) / scale).item()) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = np.maximum(_F32(1e-6), h0 * _F32(1e-3))
    else:
        h1 = (_F32(0.01) / np.maximum(d1, d2)) ** _F32(1.0 / (order + 1.0))
    return np.minimum(_F32(100.0) * h0, h1)


def runge_kutta_step(func, y0, f0, t0, dt, tab):
    """One Dormand–Prince step from (t0, y0) with f0 = func(y0, t0):
    (y1, f1, the error estimate, the stages k (7, n))
    (jax/experimental/ode.py:100-136)."""
    k = y0.new_empty((7, y0.shape[0]))
    k[0] = f0
    for i in range(1, 7):
        ti = t0 + dt * _ALPHA[i - 1]
        yi = y0 + float(dt) * _dot(tab.beta[i - 1], k)
        k[i] = func(yi, float(ti))
    y1 = float(dt) * _dot(tab.c_sol, k) + y0
    y1_error = float(dt) * _dot(tab.c_error, k)
    return y1, k[-1], y1_error, k


def mean_error_ratio(error_estimate, rtol, atol, y0, y1):
    """The RMS of the error over its tolerance, one number for the state."""
    err_tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return torch.sqrt(torch.mean((error_estimate / err_tol) ** 2))


def optimal_step_size(last_step, ratio, safety=0.9, ifactor=10.0,
                      dfactor=0.2, order=5.0):
    """The next step from the last and its error ratio, in float32
    (jax/experimental/ode.py:143-150); a NaN ratio gives a NaN step,
    which ends the solve as it does in JAX."""
    if ratio == 0:
        return last_step * _F32(ifactor)
    dfactor = _F32(1.0) if ratio < 1 else _F32(dfactor)
    factor = np.minimum(_F32(ifactor), np.maximum(
        ratio ** _F32(-1.0 / order) * _F32(safety), dfactor))
    return last_step * factor


def interp_fit_dopri(y0, y1, k, dt, tab):
    """The quartic through a step (jax/experimental/ode.py:60-76), its
    coefficients from the highest power down."""
    y_mid = y0 + float(dt) * _dot(tab.c_mid, k)
    dt = float(dt)
    dy0, dy1 = k[0], k[-1]
    a = -2. * dt * dy0 + 2. * dt * dy1 - 8. * y0 - 8. * y1 + 16. * y_mid
    b = 5. * dt * dy0 - 3. * dt * dy1 + 18. * y0 + 14. * y1 - 32. * y_mid
    c = -4. * dt * dy0 + dt * dy1 - 11. * y0 - 5. * y1 + 16. * y_mid
    return [a, b, c, dt * dy0, y0]


def _polyval(coefs, x):
    y = coefs[0]
    for c in coefs[1:]:
        y = y * x + c
    return y


def odeint(func, y0, t, *, rtol=1.4e-8, atol=1.4e-8, mxstep=math.inf,
           stats=None):
    """The solution of dy/dt = func(y, t) from y(t[0]) = y0 at the times t
    (strictly increasing numbers), with a leading axis of len(t) on each
    tensor of the state; the first entry is y0.

    mxstep bounds the attempts between two capture times (JAX's default:
    none). stats, if given, is a dict that receives the solve's counts:
    ``nfe`` (evaluations of func), ``accepted`` and ``rejected`` steps.
    """
    ts = np.asarray(t, dtype=np.float32)
    flat0, unravel, unravel_stack = _ravel(y0)

    counts = dict(nfe=0, accepted=0, rejected=0)

    def counted(y, ti):
        counts["nfe"] += 1
        return _ravel(func(unravel(y), ti))[0]

    tab = _Tableau(flat0)
    f0 = counted(flat0, float(ts[0]))
    dt = np.maximum(initial_step_size(counted, ts[0], flat0, 4, rtol, atol,
                                      f0), _F32(0.0))
    y, f, t_cur, last_t = flat0, f0, ts[0], ts[0]
    coefs = [flat0] * 5
    out = [flat0]
    for target in ts[1:]:
        i = 0
        while t_cur < target and i < mxstep and dt > 0:
            next_y, next_f, err, k = runge_kutta_step(counted, y, f, t_cur,
                                                      dt, tab)
            ratio = _F32(mean_error_ratio(err, rtol, atol, y, next_y).item())
            if ratio <= 1.0:
                coefs = interp_fit_dopri(y, next_y, k, dt, tab)
                y, f, last_t, t_cur = next_y, next_f, t_cur, t_cur + dt
                counts["accepted"] += 1
            else:
                counts["rejected"] += 1
            dt = np.maximum(optimal_step_size(dt, ratio), _F32(0.0))
            i += 1
        rel = (target - last_t) / (t_cur - last_t)
        out.append(_polyval(coefs, float(rel)))
    if stats is not None:
        stats.update(counts)
    return unravel_stack(torch.stack(out))
