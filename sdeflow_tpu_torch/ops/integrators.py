"""Stochastic integrators.

Port of sdeflow_tpu/ops/integrators.py: the EM, Heun and RK4 steps and the
fixed-step solve. The JAX package runs the solve as one ``lax.scan``; here it
is a Python loop (a CUDA graph of the loop is later work). One Wiener
increment per step is shared by all Runge-Kutta stages. A flow may override
a whole step (``ForwardFlow.rk4_step`` runs the circulant MSGM forward step
as kernel K2). ``integrate_select`` keeps, per sample, the state after its
own number of steps; a flow may override that whole solve
(``ForwardFlow.rk4_solve_select``: the circulant MSGM forward solve as one
launch of K2's solve). The Langevin corrector comes with ROADMAP Queue 1
item 3.

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


def _resolve_step_fn(flow, method):
    """The flow's whole-step override ``<method>_step`` if it has one (e.g.
    ForwardFlow.rk4_step), else the generic per-stage composition."""
    override = getattr(flow, f"{method}_step", None)
    if override is not None:
        return lambda flow, t, x, delta, dW, lmbd: override(
            t, x, delta, dW, lmbd)
    return STEP_FNS[method]


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
    step_fn = _resolve_step_fn(flow, method)
    delta = float(flow.T) / num_steps
    sqrt_delta = delta ** 0.5
    _check_noise(noise, num_steps, x0)
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


def integrate_select(flow, x0, generator, num_steps, select_idx, *,
                     method="rk4", lmbd=0.0, norm_correction=False,
                     noise=None):
    """Integrate `flow` from x0 (B, d) and return, per sample b, the state
    after select_idx[b] steps (select_idx (B,) integers in [0, num_steps];
    0 returns x0). A masked ``kept`` buffer replaces the trajectory, as in
    the JAX package; all num_steps steps run. noise: optional
    (num_steps, B, d) standard normal draws, as for integrate_sde.

    The flow's whole-solve override ``<method>_solve_select`` takes the
    solve where it has one and lmbd == 0 without norm correction; it draws
    the normals of all steps at once when none are given (on the CPU the
    same numbers as one draw per step)."""
    delta = float(flow.T) / num_steps
    sqrt_delta = delta ** 0.5
    _check_noise(noise, num_steps, x0)
    solve = getattr(flow, f"{method}_solve_select", None)
    if solve is not None and lmbd == 0 and not norm_correction:
        if noise is None:
            noise = torch.randn((num_steps, *x0.shape), generator=generator,
                                device=x0.device, dtype=x0.dtype)
        return solve(x0, noise, delta, select_idx)
    step_fn = _resolve_step_fn(flow, method)
    norm0 = (torch.linalg.vector_norm(x0, dim=-1, keepdim=True)
             if norm_correction else None)
    x = kept = x0
    sel = select_idx.reshape(-1, 1)
    for i in range(num_steps):
        z = noise[i] if noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = step_fn(flow, i * delta, x, delta, sqrt_delta * z, lmbd)
        if norm_correction:
            x = _norm_project(x, norm0)
        kept = torch.where(sel == i + 1, x, kept)
    return kept


def _check_noise(noise, num_steps, x0):
    if noise is not None and tuple(noise.shape) != (num_steps, *x0.shape):
        raise ValueError(f"noise {tuple(noise.shape)} != "
                         f"{(num_steps, *x0.shape)}")
