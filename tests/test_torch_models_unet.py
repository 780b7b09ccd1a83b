"""The whole score net, the JAX package's VorticityUNet against the
port's, at the small and at grf16's widths and on the "unfused" route, on
the same random non-zero weights (carried over by models/convert.py) and
the same inputs; atol 1e-4 in float32 (a few tens of layers, sums in
another order). The pair and the widths are tests/test_torch_models.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import ATOL, GRF16, SMALL, _pair


@pytest.mark.parametrize("arch,batch", [
    (SMALL, 3), (GRF16, 2), (dict(SMALL, attention_impl="unfused"), 3)],
    ids=["small", "grf16", "small-unfused"])
def test_vorticity_unet_matches_jax(arch, batch):
    jmodel, tmodel, params, x, t = _pair(arch, batch)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                           jnp.asarray(t)))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
