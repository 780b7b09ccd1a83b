"""Hutchinson probe vectors and the JVP divergence estimator.

Port of sdeflow_tpu/ops/hutchinson.py. vᵀ(∂fn/∂y)v is one forward-mode
``torch.func.jvp`` (one extra pass of fn), as the JAX package does with
``jax.jvp``; under ``.backward()`` of the result the parameter gradients
flow through the tangent. Probes come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch


def sample_rademacher(generator, shape, *, device, dtype=torch.float32):
    """±1 with equal probability, as (uniform ≥ 0.5)·2 − 1."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u >= 0.5).to(dtype) * 2.0 - 1.0


def sample_gaussian(generator, shape, *, device, dtype=torch.float32):
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


def randu_on_sphere(generator, shape, *, device, dtype=torch.float32):
    """Uniform on S^{d-1}: a normalized Gaussian draw."""
    x = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def sample_v(generator, shape, vtype="rademacher", *, device,
             dtype=torch.float32):
    """A Hutchinson probe of kind `vtype`: rademacher, normal (gaussian) or
    uniform (on the sphere)."""
    if vtype == "rademacher":
        return sample_rademacher(generator, shape, device=device, dtype=dtype)
    if vtype in ("normal", "gaussian"):
        return sample_gaussian(generator, shape, device=device, dtype=dtype)
    if vtype == "uniform":
        return randu_on_sphere(generator, shape, device=device, dtype=dtype)
    raise ValueError(f"vtype {vtype} not supported")


def hutchinson_div(fn, y, v, has_aux=False):
    """vᵀ(∂fn/∂y)v with one forward-mode JVP. fn: y -> (B, d) field, or
    (field, aux) with has_aux. Returns (est (B,), fn(y)[, aux])."""
    if has_aux:
        primal, tangent, aux = torch.func.jvp(fn, (y,), (v,), has_aux=True)
    else:
        primal, tangent = torch.func.jvp(fn, (y,), (v,))
    est = torch.sum(tangent * v, dim=tuple(range(1, v.ndim)))
    return (est, primal, aux) if has_aux else (est, primal)
