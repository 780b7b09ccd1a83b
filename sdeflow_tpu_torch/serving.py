"""Serving: the sampling program.

Port of ``make_sampler_fn`` (sdeflow_tpu/serving.py:27-82), ``sampler="sde"``
branch: a latent draw, then the reverse-SDE solve with the score net inside
it, under ``torch.no_grad()``: sampling records no graph. The JAX
package's export/reload (``export_sampler``, ``Sampler``), the PF-ODE and
DPM-Solver samplers and the Langevin corrector come with ROADMAP Queue 1
items 10 and 12.
"""

from __future__ import annotations

import torch

from sdeflow_tpu_torch.ops.integrators import integrate_sde
from sdeflow_tpu_torch.ops.kernels.common import resolve_device


def make_sampler_fn(gen_sde, num_samples, dim, num_steps, *, method="rk4",
                    lmbd=0.0, norm_correction=False, keep_all=False,
                    include_t0=False, sampler="sde", corrector_steps=0,
                    device="cuda"):
    """Close the generative program over a PluginReverseSDE:
    ``sample(generator, x0=None, noise=None) -> (num_samples, dim)`` samples
    (or the trajectory with keep_all). x0 replaces the latent draw, noise
    (num_steps, num_samples, dim) the solver's standard normal draws."""
    if sampler != "sde":
        raise NotImplementedError(
            f"sampler={sampler!r}: ROADMAP Queue 1 item 10 (samplers)")
    if corrector_steps:
        raise NotImplementedError(
            "Langevin corrector: ROADMAP Queue 1 item 3 (integrators)")
    device = resolve_device(device)

    @torch.no_grad()
    def sample(generator, x0=None, noise=None):
        if x0 is None:
            x0 = gen_sde.latent_sample(generator, num_samples, dim)
        if x0.device.type != device.type or tuple(x0.shape) != (num_samples,
                                                                  dim):
            raise ValueError(f"x0 {tuple(x0.shape)} on {x0.device}, expected "
                             f"{(num_samples, dim)} on {device}")
        return integrate_sde(
            gen_sde, x0, generator, num_steps, method=method, lmbd=lmbd,
            norm_correction=norm_correction, keep_all=keep_all,
            include_t0=include_t0, noise=noise)

    return sample
