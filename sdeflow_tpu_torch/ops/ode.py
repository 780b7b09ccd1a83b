"""Probability-flow ODE integrators.

Port of sdeflow_tpu/ops/ode.py. The probability-flow ODE (Song et al.
2021, eq. 13) shares the reverse SDE's marginals and gives deterministic
generation and exact likelihoods; its drift is ``PluginReverseSDE.mu_ode``
(sde/reverse.py). The JAX package runs a fixed-step solve as one
``lax.scan``; here it is a Python loop, as ``ops/integrators.integrate_sde``
is, with the optional per-sample norm re-projection after every step (for
MSGM the exact PF-ODE drift ½·g·a is orthogonal to y, so every norm is
conserved and the projection removes the learned score's radial error).
"dopri" is the adaptive Dormand–Prince solve of ``ops/odeint.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from sdeflow_tpu_torch.ops.integrators import Trajectory, _norm_project
from sdeflow_tpu_torch.ops.odeint import odeint


def euler_ode_step(drift, t, x, delta):
    return x + drift(t, x) * delta


def heun_ode_step(drift, t, x, delta):
    k1 = drift(t, x)
    k2 = drift(t + delta, x + k1 * delta)
    return x + (k1 + k2) * (delta / 2)


def rk4_ode_step(drift, t, x, delta):
    k1 = drift(t, x)
    k2 = drift(t + delta / 2, x + k1 * (delta / 2))
    k3 = drift(t + delta / 2, x + k2 * (delta / 2))
    k4 = drift(t + delta, x + k3 * delta)
    return x + (k1 + 2 * k2 + 2 * k3 + k4) * (delta / 6)


_ODE_STEP_FNS = {"em": euler_ode_step, "euler": euler_ode_step,
                 "heun": heun_ode_step, "rk4": rk4_ode_step}

# the "dopri" error-control tolerances (sdeflow_tpu/ops/ode.py:54-55)
DOPRI_RTOL = 1e-5
DOPRI_ATOL = 1e-5


def _norm0(x0, norm_correction):
    return (torch.linalg.vector_norm(x0, dim=-1, keepdim=True)
            if norm_correction else None)


def integrate_ode(flow, x0, num_steps, *, method="rk4", T=None,
                  norm_correction=False, keep_all=False, include_t0=False,
                  rtol=DOPRI_RTOL, atol=DOPRI_ATOL, stats=None):
    """Integrate the reverse-time probability-flow ODE
    dx/ds = ``flow.mu_ode(s, x)`` from x0 (B, d) over [0, T] (T defaults
    to ``flow.T``) in `num_steps` uniform steps of method "euler" ("em"),
    "heun" or "rk4", or adaptively with "dopri" (Dormand–Prince 4(5) to
    rtol/atol; num_steps then only sets the capture grid of keep_all,
    and stats, if given, receives the solve's counts, ``ops/odeint``).

    norm_correction re-projects to the latents' norms (MSGM): after every
    fixed step, or, for "dopri", the captured states afterwards. keep_all
    returns the (S, B, d) trajectory, S = num_steps (+1 with include_t0).
    Deterministic: the same latents give the same samples. Times are
    Python numbers: t = i·δ.
    """
    if method == "dopri":
        return _integrate_dopri(flow, x0, num_steps, T=T, rtol=rtol,
                                atol=atol, norm_correction=norm_correction,
                                keep_all=keep_all, include_t0=include_t0,
                                stats=stats)
    step_fn = _ODE_STEP_FNS[method]
    T = float(flow.T if T is None else T)
    delta = T / num_steps
    norm0 = _norm0(x0, norm_correction)
    x = x0
    out = Trajectory(x0, num_steps, keep_all, include_t0)
    for i in range(num_steps):
        x = step_fn(flow.mu_ode, i * delta, x, delta)
        if norm_correction:
            x = _norm_project(x, norm0)
        out.keep(i, x)
    return out.result()


def _integrate_dopri(flow, x0, num_steps, *, T, rtol, atol, norm_correction,
                     keep_all, include_t0, stats=None):
    """The adaptive solve (sdeflow_tpu/ops/ode.py:125-153): the drift's
    time clipped to [0, T] (the solver's last step may pass T before it
    interpolates back), the captured states projected afterwards."""
    T = np.float32(flow.T if T is None else T)
    n_cap = num_steps if keep_all else 1
    ts = np.linspace(0.0, T, n_cap + 1, dtype=np.float32)

    def f(y, t):
        return flow.mu_ode(min(max(t, 0.0), float(T)), y)

    ys = odeint(f, x0, ts, rtol=rtol, atol=atol, stats=stats)
    if norm_correction:
        ys = _norm_project(ys, _norm0(x0, True)[None])
    if not keep_all:
        return ys[-1]
    return ys if include_t0 else ys[1:]


class _Reversed:
    """The minimal flow that encode_ode integrates: the forward-time drift
    −mu_ode(span − τ, y) over τ ∈ [0, span]."""

    def __init__(self, flow, span):
        self.flow, self.T = flow, span

    def mu_ode(self, tau, y):
        return -self.flow.mu_ode(self.T - tau, y)


def encode_ode(flow, x, num_steps, *, method="rk4", T=None, t0=0.0,
               norm_correction=False, keep_all=False, include_t0=False,
               rtol=DOPRI_RTOL, atol=DOPRI_ATOL):
    """Encode data into the PF-ODE latent space
    (sdeflow_tpu/ops/ode.py:157-206): the forward-time probability-flow
    ODE from t = t0 (data) to t = T (the latent prior), whose drift is
    the reverse clock's mirrored. With t0 = 0 it inverts integrate_ode up
    to the integration error; ``t0=flow.base_sde.t_epsilon`` gives
    ``eval/nll.exact_logp``'s latent. The other arguments are
    integrate_ode's."""
    span = float(flow.T if T is None else T) - float(t0)
    return integrate_ode(_Reversed(flow, span), x, num_steps, method=method,
                         T=span, norm_correction=norm_correction,
                         keep_all=keep_all, include_t0=include_t0,
                         rtol=rtol, atol=atol)
