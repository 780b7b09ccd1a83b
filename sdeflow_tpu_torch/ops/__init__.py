"""Numerical ops: the diffusion action, probes, integrators, kernels."""
