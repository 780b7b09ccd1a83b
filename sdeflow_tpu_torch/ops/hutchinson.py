"""Probe vectors. Port of sdeflow_tpu/ops/hutchinson.py: only the uniform
draw on the sphere that the MSGM latent prior needs; the Hutchinson probes
and divergence come with the SSM loss (ROADMAP Queue 1 item 1)."""

from __future__ import annotations

import torch


def randu_on_sphere(generator, shape, *, device, dtype=torch.float32):
    """Uniform on S^{d-1}: a normalized Gaussian draw."""
    x = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
