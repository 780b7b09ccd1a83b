"""Serving: the sampling program.

Port of ``make_sampler_fn`` and ``_solve_from`` (sdeflow_tpu/serving.py:
27-82): a latent draw, then one reverse solve with the score net inside it,
under ``torch.no_grad()`` (sampling records no graph): the reverse SDE
(``sampler="sde"``, with ``corrector_steps`` Langevin corrector steps after
each predictor step when asked: predictor–corrector sampling), the
probability-flow ODE (``"ode"``, ``ops/ode.py``: deterministic, the
generator seeds only the latent draw) or a DPM-Solver exponential
integrator (``"dpm"``, ``ops/expint.py``, SGM only: deterministic but for
the stochastic sdpm methods). The JAX package's export/reload
(``export_sampler``, ``Sampler``, ``export_encoder``) comes with ROADMAP
Queue 1 item 12.
"""

from __future__ import annotations

import torch

from sdeflow_tpu_torch.ops.expint import integrate_dpm
from sdeflow_tpu_torch.ops.integrators import integrate_sde
from sdeflow_tpu_torch.ops.kernels.common import resolve_device
from sdeflow_tpu_torch.ops.ode import integrate_ode

SAMPLERS = ("sde", "ode", "dpm")


def make_sampler_fn(gen_sde, num_samples, dim, num_steps, *, method="rk4",
                    lmbd=0.0, norm_correction=False, keep_all=False,
                    include_t0=False, sampler="sde", corrector_steps=0,
                    snr=0.16, dpm_grid="logsnr", device="cuda"):
    """Close the generative program over a PluginReverseSDE:
    ``sample(generator, x0=None, noise=None) -> (num_samples, dim)``
    samples (or the trajectory with keep_all). x0 replaces the latent draw,
    noise (num_steps, num_samples, dim) the solve's standard normal draws
    (the SDE's predictor, the sdpm methods). sampler: "sde" (method em,
    heun or rk4; corrector_steps Langevin steps with snr after each
    predictor step, ``ops/integrators.integrate_sde``), "ode" (method
    euler, heun, rk4 or dopri) or "dpm" (method dpm1, dpm2, dpm2m, dpm3m,
    sdpm1 or sdpm2m, dpm2m for any other name; dpm_grid logsnr, time or
    karras)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} (sde|ode|dpm)")
    device = resolve_device(device)

    @torch.no_grad()
    def sample(generator, x0=None, noise=None):
        if x0 is None:
            x0 = gen_sde.latent_sample(generator, num_samples, dim)
        if x0.device.type != device.type or tuple(x0.shape) != (num_samples,
                                                                  dim):
            raise ValueError(f"x0 {tuple(x0.shape)} on {x0.device}, expected "
                             f"{(num_samples, dim)} on {device}")
        return _solve_from(
            gen_sde, x0, generator, num_steps, method=method, lmbd=lmbd,
            norm_correction=norm_correction, keep_all=keep_all,
            include_t0=include_t0, sampler=sampler,
            corrector_steps=corrector_steps, snr=snr, dpm_grid=dpm_grid,
            noise=noise)

    return sample


def _solve_from(gen_sde, x0, generator, num_steps, *, method, lmbd,
                norm_correction, keep_all, include_t0, sampler,
                corrector_steps, snr, dpm_grid="logsnr", noise=None):
    """One reverse solve from the latents x0 by `sampler`."""
    if sampler == "dpm":
        m = method if method.startswith(("dpm", "sdpm")) else "dpm2m"
        stochastic = m.startswith("sdpm")
        return integrate_dpm(
            gen_sde, x0, num_steps, method=m, grid=dpm_grid,
            keep_all=keep_all, include_t0=include_t0,
            generator=generator if stochastic else None,
            noise=noise if stochastic else None)
    if sampler == "ode":
        return integrate_ode(
            gen_sde, x0, num_steps, method=method,
            norm_correction=norm_correction, keep_all=keep_all,
            include_t0=include_t0)
    return integrate_sde(
        gen_sde, x0, generator, num_steps, method=method, lmbd=lmbd,
        norm_correction=norm_correction, keep_all=keep_all,
        include_t0=include_t0, noise=noise,
        corrector_steps=corrector_steps, snr=snr)
