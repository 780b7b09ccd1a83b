"""Exact log-likelihood through the probability-flow ODE.

Port of sdeflow_tpu/eval/nll.py. The PF-ODE turns the trained score model
into a continuous normalizing flow with a computable density:

    log p_0(x) = log p_T(y_T) + ∫_{t0}^T ∇·f̃(t, y_t) dt,
    dy/dt = f̃(t, y) := f(t, y) − ½∇·Σ(t, y) − ½·g·a(y, t),

integrated forward in time (data → latent) with the divergence carried in
the state. The divergence is a Hutchinson estimate with probes drawn once a
solve (``ops/hutchinson.hutchinson_div``, one ``torch.func.jvp`` of the
field a probe; the first JVP's primal is the field itself), or exact: the
JAX package maps ``jax.jvp`` over the basis with ``jax.vmap``, which the
kernels' ``autograd.Function``s do not take, so here each JVP takes a
chunk of k basis tangents against the batch tiled k times (k·B rows, at
most ``JVP_ROWS``), and the score net runs its kernels on every row. The
lower limit t0 defaults to t_epsilon, below which the score net is never
trained.

Run it under ``torch.no_grad()`` (``nll_summary`` does): forward-mode AD
needs no graph, and the solve's hundreds of stages would otherwise keep
one through the score net's parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sdeflow_tpu_torch.ops.hutchinson import hutchinson_div, sample_v
from sdeflow_tpu_torch.ops.ode import _ODE_STEP_FNS, DOPRI_ATOL, DOPRI_RTOL
from sdeflow_tpu_torch.ops.odeint import odeint

# the rows of one JVP of the exact divergence (k basis tangents against
# the batch tiled k times, k·B ≤ JVP_ROWS): what bounds its memory
JVP_ROWS = 4096


def _pf_field(gen_sde, t, y):
    """The forward-time PF-ODE drift f̃ (see the module docstring)."""
    base = gen_sde.base_sde
    a = gen_sde.score(y, t)
    return (base.f(t, y) - 0.5 * base.div_sigma(t, y)
            - 0.5 * base.sigma_apply(t, y, a))


def _make_aug_drift(gen_sde, divergence, probes):
    """(t, (y, ℓ)) ↦ (f̃(t, y), ∇·f̃(t, y)) with ∇· exact or Hutchinson
    (the mean over the probes (n_probes, B, d))."""

    def div_hutch(t, y):
        field = lambda yy: _pf_field(gen_sde, t, yy)  # noqa: E731
        ests, primals = zip(*(hutchinson_div(field, y, v) for v in probes))
        return primals[0], torch.stack(ests).mean(dim=0)

    def div_exact(t, y):
        field = lambda yy: _pf_field(gen_sde, t, yy)  # noqa: E731
        batch, d = y.shape
        k = max(1, min(d, JVP_ROWS // batch))
        div = y.new_zeros((batch,))
        for j0 in range(0, d, k):
            kk = min(k, d - j0)
            cols = torch.arange(j0, j0 + kk, device=y.device)
            basis = torch.zeros((kk, batch, d), dtype=y.dtype,
                                device=y.device)
            basis[torch.arange(kk), :, cols] = 1.0
            _, tang = torch.func.jvp(field, (y.repeat(kk, 1),),
                                     (basis.reshape(kk * batch, d),))
            tang = tang.reshape(kk, batch, d)
            div = div + tang[torch.arange(kk), :, cols].sum(dim=0)
        return field(y), div

    div = div_exact if divergence == "exact" else div_hutch

    def drift(t, state):
        return div(t, state[0])

    return drift


def _tuple_step(step_fn, drift, t, state, delta):
    """An array-state ODE step over the (y, ℓ) tuple, as one (B, d + 1)
    array (the steps are linear combinations of their stages, so the
    stacking is exact)."""
    y, logdet = state
    z = torch.cat([y, logdet[:, None]], dim=-1)

    def zdrift(ti, zi):
        dy, dl = drift(ti, (zi[:, :-1], zi[:, -1]))
        return torch.cat([dy, dl[:, None]], dim=-1)

    z_new = step_fn(zdrift, t, z, delta)
    return z_new[:, :-1], z_new[:, -1]


def exact_logp(gen_sde, x, generator=None, *, num_steps=128, method="rk4",
               divergence="hutchinson", vtype="rademacher", n_probes=1,
               t0=None, return_latent=False, prior="exact", rtol=DOPRI_RTOL,
               atol=DOPRI_ATOL, probes=None, stats=None):
    """log p(x) (B,) in nats of the generative model at the data x (B, d).

    The forward PF-ODE from t0 (default t_epsilon) to T: `num_steps`
    fixed steps of "euler", "heun" or "rk4", or "dopri" (adaptive to
    rtol/atol; stats, if given, receives its counts). divergence:
    "hutchinson" (n_probes JVPs a stage; probes of `vtype` drawn once from
    `generator`, or injected as probes (n_probes, B, d)) or "exact"
    (chunks of basis tangents, JVP_ROWS rows a JVP). prior: "exact" (the
    SDE's normalized latent density, ``log_latent_pdf_exact`` where it has
    one: MSGM) or "model" (``log_latent_pdf``, MSGM's reference-faithful
    unnormalized one). return_latent also returns y_T.
    """
    base = gen_sde.base_sde
    t0 = float(base.t_epsilon if t0 is None else t0)
    T = float(gen_sde.T)
    if divergence == "hutchinson":
        if probes is None:
            if generator is None:
                raise ValueError("hutchinson divergence needs a generator "
                                 "or probes")
            probes = sample_v(generator, (n_probes, *x.shape), vtype=vtype,
                              device=x.device, dtype=x.dtype)
    elif divergence == "exact":
        probes = None
    else:
        raise ValueError(f"unknown divergence {divergence!r} "
                         "(hutchinson|exact)")
    drift = _make_aug_drift(gen_sde, divergence, probes)
    init = (x, x.new_zeros((x.shape[0],)))

    if method == "dopri":
        t0_32, T_32 = np.float32(t0), np.float32(T)

        def f_aug(state, t):
            return drift(min(max(t, float(t0_32)), float(T_32)), state)

        ys = odeint(f_aug, init, [t0_32, T_32], rtol=rtol, atol=atol,
                    stats=stats)
        y_T, int_div = ys[0][-1], ys[1][-1]
    else:
        step_fn = _ODE_STEP_FNS[method]
        delta = (T - t0) / num_steps
        state = init
        for i in range(num_steps):
            state = _tuple_step(step_fn, drift, t0 + i * delta, state, delta)
        y_T, int_div = state

    if prior == "exact":
        lp_fn = getattr(base, "log_latent_pdf_exact", base.log_latent_pdf)
    elif prior == "model":
        lp_fn = base.log_latent_pdf
    else:
        raise ValueError(f"unknown prior {prior!r} (exact|model)")
    lp_prior = lp_fn(y_T).reshape(x.shape[0], -1).sum(dim=1)
    logp = lp_prior + int_div
    return (logp, y_T) if return_latent else logp


def nll_bits_per_dim(gen_sde, x, generator=None, **kwargs):
    """The negative log-likelihood in bits per dimension."""
    logp = exact_logp(gen_sde, x, generator, **kwargs)
    d = x.reshape(x.shape[0], -1).shape[1]
    return -logp / (d * math.log(2.0))


def nll_summary(gen_sde, x, generator, *, num_steps=64, max_points=512,
                divergence="hutchinson", **kwargs):
    """The NLL report of a trained model (sdeflow_tpu/eval/nll.py:191-218):
    bits/dim over at most max_points rows of a test batch, Hutchinson
    divergence by default, under no_grad, non-finite values dropped.
    Returns {mean, stderr, n, steps}, mean and stderr None when no value
    is finite (a diverged arm), so that it dumps as strict JSON."""
    x = x[: min(max_points, x.shape[0])]
    with torch.no_grad():
        bpd = nll_bits_per_dim(gen_sde, x, generator, num_steps=num_steps,
                               divergence=divergence, **kwargs)
    bpd = bpd.detach().cpu().numpy()
    finite = bpd[np.isfinite(bpd)]
    if finite.size == 0:
        return dict(mean=None, stderr=None, n=0, steps=int(num_steps))
    return dict(mean=float(finite.mean()),
                stderr=float(finite.std() / finite.size ** 0.5),
                n=int(finite.size), steps=int(num_steps))
