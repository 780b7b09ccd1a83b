"""Stochastic integrators.

Port of sdeflow_tpu/ops/integrators.py: the EM, Heun and RK4 steps and the
fixed-step solve. The JAX package runs the solve as one ``lax.scan``; here it
is a Python loop (a CUDA graph of the loop is later work). One Wiener
increment per step is shared by all Runge-Kutta stages. A flow may override
a whole step (``ForwardFlow.rk4_step`` runs the circulant MSGM forward step
as kernel K2). ``integrate_select`` keeps, per sample, the state after its
own number of steps; a flow may override that whole solve
(``ForwardFlow.rk4_solve_select``: the circulant MSGM forward solve as one
launch of K2's solve). ``integrate_sde`` with ``corrector_steps`` > 0 is
predictor–corrector sampling: after each predictor step that many Langevin
steps (``langevin_corrector``), whose normals come from streams disjoint
from the predictor's (``ops/rng.py`` ``fold_in`` with the JAX package's
integers).

The flow protocol: ``T``; ``mu(t, y, lmbd)`` (Itô drift, EM);
``mu_strato(t, y, lmbd)`` (Stratonovich drift, Heun / RK4);
``sigma_apply(t, y, w, lmbd)`` (diffusion action g(t, y)·w); for the
corrector ``corrector_drift(t, y)`` and ``corrector_noise(t, y, z)``.
"""

from __future__ import annotations

import torch

from sdeflow_tpu_torch.ops.rng import fold_in


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


def langevin_corrector(flow, x, generator, t, num_corrector, *, snr=0.16,
                       norm0=None, noise=None):
    """`num_corrector` preconditioned Langevin steps at the frozen reverse
    time t (sdeflow_tpu/ops/integrators.py:98-134):
    x ← x + ε·d + √(2ε)·g·z with d = ``flow.corrector_drift(t, x)``,
    g·z = ``flow.corrector_noise(t, x, z)`` and the step size
    ε = 2·(snr·‖g·z‖/‖d‖)² from batch-mean norms; where ‖d‖ ≤ 1e-12·‖g·z‖
    (a zero score carries no information) no step is taken. Step j's
    normals are noise[j] if given (noise (num_corrector, B, d); generator
    may then be None), else drawn from ``fold_in(generator, j)``. With
    norm0 each state is re-projected to that norm. Returns (x, the step
    sizes ε as a (num_corrector,) tensor)."""
    if noise is not None and tuple(noise.shape) != (num_corrector,
                                                    *x.shape):
        raise ValueError(f"corrector noise {tuple(noise.shape)} != "
                         f"{(num_corrector, *x.shape)}")
    eps_all = []
    for j in range(num_corrector):
        z = noise[j] if noise is not None else torch.randn(
            x.shape, generator=fold_in(generator, j), device=x.device,
            dtype=x.dtype)
        d = flow.corrector_drift(t, x)
        gz = flow.corrector_noise(t, x, z)
        n_z = torch.linalg.vector_norm(gz.reshape(gz.shape[0], -1),
                                       dim=-1).mean()
        n_d = torch.linalg.vector_norm(d.reshape(d.shape[0], -1),
                                       dim=-1).mean()
        eps = torch.where(n_d > 1e-12 * n_z,
                          2.0 * (snr * n_z / torch.clamp(n_d, min=1e-20))**2,
                          torch.zeros_like(n_d))
        x = x + eps * d + torch.sqrt(2.0 * eps) * gz
        if norm0 is not None:
            x = _norm_project(x, norm0)
        eps_all.append(eps)
    return x, torch.stack(eps_all)


def integrate_sde(flow, x0, generator, num_steps, *, method="rk4", lmbd=0.0,
                  norm_correction=False, keep_all=False, include_t0=False,
                  noise=None, corrector_steps=0, snr=0.16,
                  corrector_noise=None):
    """Integrate `flow` from x0 (B, d) over `num_steps` uniform steps.

    noise: optional (num_steps, B, d) standard normal draws, one per step
    (dW = √δ·noise[i]); without it they are drawn from `generator`.
    corrector_steps > 0 runs that many Langevin steps
    (``langevin_corrector``, with `snr`) after each predictor step, at the
    reverse time after it and with the predictor's norm0 under
    norm_correction; the normals of step i's corrector are
    corrector_noise[i] if given ((num_steps, corrector_steps, B, d)), else
    drawn from ``fold_in(generator, num_steps + 1 + i)`` folded again by
    the corrector step (the JAX package's keys).
    keep_all returns the trajectory (S, B, d), S = num_steps (+1 with
    include_t0), written state by state into one preallocated tensor (it
    is held once). Times are Python numbers: t = i·δ.
    """
    step_fn = _resolve_step_fn(flow, method)
    delta = float(flow.T) / num_steps
    sqrt_delta = delta ** 0.5
    _check_noise(noise, num_steps, x0)
    if corrector_noise is not None and tuple(corrector_noise.shape) != (
            num_steps, corrector_steps, *x0.shape):
        raise ValueError(
            f"corrector_noise {tuple(corrector_noise.shape)} != "
            f"{(num_steps, corrector_steps, *x0.shape)}")
    norm0 = (torch.linalg.vector_norm(x0, dim=-1, keepdim=True)
             if norm_correction else None)
    x = x0
    first = 1 if include_t0 else 0
    if keep_all:
        traj = x0.new_empty((num_steps + first, *x0.shape))
        if include_t0:
            traj[0] = x0
    for i in range(num_steps):
        z = noise[i] if noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)
        dW = sqrt_delta * z
        x = step_fn(flow, i * delta, x, delta, dW, lmbd)
        if norm_correction:
            x = _norm_project(x, norm0)
        if corrector_steps:
            x, _ = langevin_corrector(
                flow, x, (fold_in(generator, num_steps + 1 + i)
                          if corrector_noise is None else None),
                (i + 1) * delta, corrector_steps, snr=snr, norm0=norm0,
                noise=(None if corrector_noise is None
                       else corrector_noise[i]))
        if keep_all:
            traj[first + i] = x
    return traj if keep_all else x


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
