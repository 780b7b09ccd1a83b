"""Exponential integrators (the DPM-Solver family) for the VP-SDE PF-ODE.

Port of sdeflow_tpu/ops/expint.py. For the SGM VP-SDE the probability-flow
ODE's linear drift −½β(s)y integrates exactly; in the log-SNR
λ(s) = log(α(s)/σ(s)) the solution is

    y(s_next) = (α_next/α_cur)·y(s_cur) − σ_next ∫ e^{λ−λ_next} ε̂ dλ

with ε̂ the noise prediction, and a Taylor expansion of ε̂ in λ gives
solvers of one or two score evaluations a step (Lu et al. 2022):

  * ``dpm1``   first order (DDIM), 1 NFE a step;
  * ``dpm2``   single-step midpoint (DPM-Solver-2), 2 NFE a step;
  * ``dpm2m``  multistep data prediction (DPM-Solver++ 2M), 1 NFE a step;
  * ``dpm3m``  third-order multistep (DPM-Solver++ 3M), warmed up through
               orders 1 and 2 on its first two intervals;
  * ``sdpm1``  stochastic first order (SDE-DPM-Solver-1), the noise with
               its exact conditional variance σ_next²(e^{2h} − 1);
  * ``sdpm2m`` stochastic multistep (SDE-DPM-Solver++(2M)).

Scope: an SDE with a closed-form Gaussian kernel (``mean_weight``,
``var``): SGM. The time grid (uniform in λ by default, ``"time"`` uniform
in s, ``"karras"`` the EDM ρ = 7 schedule) and every step's coefficients
are computed once, in float32 on the host, by interpolating a dense
monotone λ(s) table; the solve is a Python loop of one or two score-net
calls and a few axpy updates a step, the coefficients Python numbers. The
noise bridge: ε̂(y, s) = −(σ(s)/√β(s))·a(y, s). The stochastic methods
draw their normals from an explicit generator, one draw a step, or take
them injected as ``noise`` (num_steps, B, d).
"""

from __future__ import annotations

import functools
import math

import torch

from sdeflow_tpu_torch.ops.integrators import Trajectory

_NFE_PER_STEP = {"dpm1": 1, "dpm2": 2, "dpm2m": 1, "dpm3m": 1,
                 "sdpm1": 1, "sdpm2m": 1}
_HOST = torch.device("cpu")


def _check_kernel(base_sde):
    if not (hasattr(base_sde, "mean_weight") and hasattr(base_sde, "var")):
        raise ValueError(
            "DPM-Solver sampling requires a closed-form Gaussian forward "
            "kernel (mean_weight/var), i.e. the SGM VP-SDE; got "
            f"{type(base_sde).__name__}. Use sampler='sde'/'ode' for MSGM.")


def interp(x, xp, fp):
    """``jnp.interp``: piecewise-linear interpolation of (xp, fp) at x, xp
    increasing, fp[0] below xp[0] and fp[-1] above xp[-1]."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = torch.finfo(xp.dtype).eps
    dx0 = torch.abs(dx) <= eps * eps  # np.spacing(eps) in xp's format
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _lam(base_sde, s):
    return torch.log(base_sde.mean_weight(s)) - 0.5 * torch.log(
        base_sde.var(s))


def _dense_table(base_sde, dtype, dense=4096):
    """(s increasing, λ(s) decreasing) over [t_epsilon, T]: the monotone
    table that the grids and dpm2's midpoints interpolate."""
    s_dense = torch.linspace(base_sde.t_epsilon, base_sde.T, dense,
                             dtype=dtype, device=_HOST)
    return s_dense, _lam(base_sde, s_dense)


def _s_of_lambda(lam_targets, s_dense, lam):
    """Invert λ(s) by interpolation (xp must increase: both reversed)."""
    return interp(lam_targets, lam.flip(0), s_dense.flip(0))


def _grid(base_sde, num_steps, dtype, grid="logsnr", dense=4096):
    """The time grid s_0 = T > s_1 > … > s_N = t_epsilon, (N + 1,) on the
    host: uniform in λ (``logsnr``), in s (``time``) or the EDM ρ = 7
    schedule on the noise scale e^{−λ} (``karras``), the endpoints pinned
    (sdeflow_tpu/ops/expint.py:89-120)."""
    T, t_eps = base_sde.T, base_sde.t_epsilon
    if grid == "time":
        return torch.linspace(T, t_eps, num_steps + 1, dtype=dtype,
                              device=_HOST)
    if grid not in ("logsnr", "karras"):
        raise ValueError(f"unknown dpm grid {grid!r} (logsnr|time|karras)")
    s_dense, lam = _dense_table(base_sde, dtype, dense)
    if grid == "karras":
        rho = 7.0
        sig_max = torch.exp(-lam[-1])  # λ(T): the high-noise end
        sig_min = torch.exp(-lam[0])   # λ(t_eps): the low-noise end
        r = torch.linspace(0.0, 1.0, num_steps + 1, dtype=dtype,
                           device=_HOST)
        inv = 1.0 / rho
        sig = (sig_max**inv + r * (sig_min**inv - sig_max**inv)) ** rho
        targets = -torch.log(sig)
    else:
        targets = torch.linspace(float(lam[-1]), float(lam[0]),
                                 num_steps + 1, dtype=dtype, device=_HOST)
    s = _s_of_lambda(targets, s_dense, lam)
    s[0], s[-1] = T, t_eps
    return s


def _coefs(base_sde, s):
    """(α, σ, λ, c_ε) at the grid points s: c_ε = σ/√β scales the drift
    to the noise prediction."""
    alpha = base_sde.mean_weight(s)
    sigma = torch.sqrt(base_sde.var(s))
    return (alpha, sigma, torch.log(alpha) - torch.log(sigma),
            sigma / torch.sqrt(base_sde.beta(s)))


@functools.lru_cache(maxsize=32)
def dpm_schedule(base_sde, num_steps, method, grid, dtype):
    """The solve's host-side schedule as Python numbers: the grid s and
    its α, σ, λ and c_ε, and for dpm2 its midpoints (s, α, σ, c_ε), else
    None. Kept per (SDE, steps, method, grid, dtype), so that a traced
    solve (``serving.export_sampler`` computes it before tracing) reads
    it without computing it."""
    s_grid = _grid(base_sde, num_steps, dtype, grid=grid)
    alpha, sigma, lam, c_eps = (v.tolist() for v in _coefs(base_sde, s_grid))
    mid = None
    if method == "dpm2":
        lam_g = _lam(base_sde, s_grid)
        s_mid = _s_of_lambda(0.5 * (lam_g[:-1] + lam_g[1:]),
                             *_dense_table(base_sde, dtype))
        a_mid, sg_mid, _, c_mid = (v.tolist() for v in _coefs(base_sde,
                                                              s_mid))
        mid = (s_mid.tolist(), a_mid, sg_mid, c_mid)
    return s_grid.tolist(), alpha, sigma, lam, c_eps, mid


def integrate_dpm(flow, x0, num_steps, *, method="dpm2m", grid="logsnr",
                  keep_all=False, include_t0=False, generator=None,
                  noise=None):
    """Solve the reverse process from the latents x0 (B, d) with a
    DPM-Solver exponential integrator over `num_steps` grid intervals
    (NFE = ``nfe(method, num_steps)``). flow: a PluginReverseSDE over an
    SDE with a closed-form kernel (SGM). method: dpm1 | dpm2 | dpm2m |
    dpm3m | sdpm1 | sdpm2m; grid: logsnr | time | karras. The stochastic
    methods need `generator` (one standard normal draw a step) or `noise`
    (num_steps, B, d). keep_all / include_t0 as in ``ops/ode``."""
    if method not in _NFE_PER_STEP:
        raise ValueError(f"unknown dpm method {method!r} "
                         "(dpm1|dpm2|dpm2m|dpm3m|sdpm1|sdpm2m)")
    stochastic = method.startswith("sdpm")
    if stochastic and generator is None and noise is None:
        raise ValueError(f"{method} is stochastic: pass generator= or noise=")
    if noise is not None and tuple(noise.shape) != (num_steps, *x0.shape):
        raise ValueError(f"noise {tuple(noise.shape)} != "
                         f"{(num_steps, *x0.shape)}")
    base = flow.base_sde
    _check_kernel(base)
    s, alpha, sigma, lam, c_eps, mid = dpm_schedule(base, num_steps, method,
                                                    grid, x0.dtype)
    if method == "dpm2":
        s_mid, a_mid, sg_mid, c_mid = mid

    def eps_hat(y, sv, c):
        return -c * flow.score(y, sv)

    def normal(i, y):
        if noise is not None:
            return noise[i]
        return torch.randn(y.shape, generator=generator, device=y.device,
                           dtype=y.dtype)

    y = x0
    x_prev = m1 = m2 = None  # the multistep methods' history
    h_prev, h1, h2 = 1.0, 1.0, 1.0
    out = Trajectory(x0, num_steps, keep_all, include_t0)
    for i in range(num_steps):
        h = lam[i + 1] - lam[i]  # > 0: λ rises as s falls
        a_cur, a_nxt, sg_cur, sg_nxt = alpha[i], alpha[i + 1], sigma[i], \
            sigma[i + 1]
        e = eps_hat(y, s[i], c_eps[i])
        if method == "dpm1":
            y = (a_nxt / a_cur) * y - sg_nxt * math.expm1(h) * e
        elif method == "sdpm1":
            z = normal(i, y)
            y = ((a_nxt / a_cur) * y - 2.0 * sg_nxt * math.expm1(h) * e
                 + sg_nxt * math.sqrt(math.expm1(2.0 * h)) * z)
        elif method == "dpm2":
            u = (a_mid[i] / a_cur) * y - sg_mid[i] * math.expm1(0.5 * h) * e
            e2 = eps_hat(u, s_mid[i], c_mid[i])
            y = (a_nxt / a_cur) * y - sg_nxt * math.expm1(h) * e2
        elif method == "dpm3m":
            # DPM-Solver++(3M): the order-3 correction, order 2 on
            # interval 1, none on interval 0
            m0 = (y - sg_cur * e) / a_cur
            phi1 = math.expm1(-h)
            if i == 0:
                corr = 0.0
            else:
                r0, r1 = h1 / h, h2 / h
                d1_0 = (m0 - m1) / r0
                if i == 1:
                    corr = -0.5 * phi1 * d1_0
                else:
                    d1_1 = (m1 - m2) / r1
                    d1 = d1_0 + r0 / (r0 + r1) * (d1_0 - d1_1)
                    d2 = (d1_0 - d1_1) / (r0 + r1)
                    phi2 = phi1 / h + 1.0
                    phi3 = phi2 / h - 0.5
                    corr = phi2 * d1 - phi3 * d2
            y = (sg_nxt / sg_cur) * y - a_nxt * phi1 * m0 + a_nxt * corr
            m1, m2, h1, h2 = m0, m1, h, h1
        else:  # dpm2m, sdpm2m: the 2nd-order multistep x̂ extrapolation
            x_pred = (y - sg_cur * e) / a_cur
            d = (x_pred if i == 0
                 else x_pred + (h / (2.0 * h_prev)) * (x_pred - x_prev))
            if method == "dpm2m":
                y = (sg_nxt / sg_cur) * y - a_nxt * math.expm1(-h) * d
            else:
                z = normal(i, y)
                y = ((sg_nxt / sg_cur) * math.exp(-h) * y
                     - a_nxt * math.expm1(-2.0 * h) * d
                     + sg_nxt * math.sqrt(-math.expm1(-2.0 * h)) * z)
            x_prev, h_prev = x_pred, h
        out.keep(i, y)
    return out.result()


def nfe(method, num_steps):
    """Score-net evaluations of a `num_steps`-interval DPM solve."""
    return _NFE_PER_STEP[method] * num_steps
