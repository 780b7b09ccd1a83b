"""The VP SDE's methods (the SGM arm's SDE) against the JAX package's on
the same numpy inputs, float32: rtol 1e-6 / atol 1e-5 (β up to 20
multiplies products taken in another order). The inputs and the methods'
table are tests/test_torch_sgm.py's."""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_sgm import METHODS, _inputs, _Torch, sdes  # noqa: F401


@pytest.mark.parametrize("name", sorted(METHODS))
def test_sgm_method_matches_jax(sdes, name):
    jsde, tsde = sdes
    y, w, t = _inputs()
    ref = np.asarray(METHODS[name](jsde, jnp, y, w, t))
    out = METHODS[name](tsde, _Torch, y, w, t).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)
