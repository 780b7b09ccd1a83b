"""ELBO evaluation. Port of sdeflow_tpu/eval/elbo.py."""

from __future__ import annotations

import math


def evaluate(gen_sde, generator, x_test, **draws):
    """Mean and standard error of the ELBO over a test batch (the error
    over the batch size, not the intT-expanded count). `draws` inject
    elbo_random_t_slice's draws. Returns two 0-d tensors."""
    elbo = gen_sde.elbo_random_t_slice(generator, x_test, **draws)
    n = x_test.shape[0]
    return elbo.mean(), elbo.std(correction=0) / math.sqrt(n)
