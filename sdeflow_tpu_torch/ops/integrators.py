"""Stochastic integrators.

Port of sdeflow_tpu/ops/integrators.py: the EM, Heun and RK4 steps and the
fixed-step solve. The JAX package runs the solve as one ``lax.scan``; here it
is a Python loop (a CUDA graph of the loop is later work). One Wiener
increment per step is shared by all Runge-Kutta stages. ``integrate_select``
and the whole-step override hook come with ROADMAP Queue 1 item 1, the
Langevin corrector with item 3.

The flow protocol: ``T``; ``mu(t, y, lmbd)`` (Itô drift, EM);
``mu_strato(t, y, lmbd)`` (Stratonovich drift, Heun / RK4);
``sigma_apply(t, y, w, lmbd)`` (diffusion action g(t, y)·w).
"""

from __future__ import annotations

import torch


def em_step(flow, t, x, delta, dW, lmbd=0.0):
    """Euler–Maruyama step with the Itô drift."""
    return x + flow.mu(t, x, lmbd) * delta + flow.sigma_apply(t, x, dW, lmbd)


def heun_step(flow, t, x, delta, dW, lmbd=0.0):
    """Heun (RK2) predictor-corrector in Stratonovich form."""
    mu1 = flow.mu_strato(t, x, lmbd)
    s1 = flow.sigma_apply(t, x, dW, lmbd)
    x_pred = x + mu1 * delta + s1
    mu2 = flow.mu_strato(t + delta, x_pred, lmbd)
    s2 = flow.sigma_apply(t + delta, x_pred, dW, lmbd)
    return x + (mu1 + mu2) * (delta / 2) + (s1 + s2) / 2


def rk4_step(flow, t, x, delta, dW, lmbd=0.0):
    """RK4 for Stratonovich SDEs with skew-symmetric noise; dW is shared
    across the four stages."""

    def stage(ti, xi):
        return (flow.mu_strato(ti, xi, lmbd) * delta
                + flow.sigma_apply(ti, xi, dW, lmbd))

    k1 = stage(t, x)
    k2 = stage(t + delta / 2, x + k1 / 2)
    k3 = stage(t + delta / 2, x + k2 / 2)
    k4 = stage(t + delta, x + k3)
    return x + (k1 + 2 * k2 + 2 * k3 + k4) / 6


STEP_FNS = {"em": em_step, "heun": heun_step, "rk4": rk4_step}


def _norm_project(x, norm0):
    """Exact norm re-projection x ← x·‖x_0‖/‖x‖."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x * (norm0 / torch.clamp(n, min=1e-12))


def integrate_sde(flow, x0, generator, num_steps, *, method="rk4", lmbd=0.0,
                  norm_correction=False, keep_all=False, include_t0=False,
                  noise=None):
    """Integrate `flow` from x0 (B, d) over `num_steps` uniform steps.

    noise: optional (num_steps, B, d) standard normal draws, one per step
    (dW = √δ·noise[i]); without it they are drawn from `generator`.
    keep_all returns the trajectory (S, B, d), S = num_steps (+1 with
    include_t0). Times are Python numbers: t = i·δ.
    """
    step_fn = STEP_FNS[method]
    delta = float(flow.T) / num_steps
    sqrt_delta = delta ** 0.5
    if noise is not None and tuple(noise.shape) != (num_steps, *x0.shape):
        raise ValueError(f"noise {tuple(noise.shape)} != "
                         f"{(num_steps, *x0.shape)}")
    norm0 = (torch.linalg.vector_norm(x0, dim=-1, keepdim=True)
             if norm_correction else None)
    x = x0
    traj = [x0] if keep_all and include_t0 else []
    for i in range(num_steps):
        z = noise[i] if noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)
        dW = sqrt_delta * z
        x = step_fn(flow, i * delta, x, delta, dW, lmbd)
        if norm_correction:
            x = _norm_project(x, norm0)
        if keep_all:
            traj.append(x)
    return torch.stack(traj) if keep_all else x
