"""The low-rank block-rotation figures (sdeflow_tpu_torch/plotting/
lowrank.py) against the JAX package's: ``simulate_block_rotation`` bit for
bit over its flags (one path or independent draws, Gaussian or uniform
angles (independent draws only: the uniform angles have no single-path
form in either package), the start: ones, random, or the last two
coordinates killed), on
the same ``RandomState`` stream, and ``make_figures``' files."""

import numpy as np
import pytest

from sdeflow_tpu.plotting import lowrank as jax_lowrank
from sdeflow_tpu_torch.plotting import lowrank

STARTS = {"ones": {}, "random": dict(random_init=True),
          "kill_dim34": dict(kill_dim34=True, init_value=0.5)}


@pytest.mark.parametrize("trajectory,from_uniform", [
    (False, False), (False, True), (True, False)])  # no uniform single path
@pytest.mark.parametrize("start", sorted(STARTS))
def test_simulate_block_rotation_is_jax_bit_for_bit(trajectory, from_uniform,
                                                   start):
    kw = dict(T=10.0, N=400, lambda1=1.5, lambda2=7.0, trajectory=trajectory,
              from_uniform=from_uniform, seed=3, **STARTS[start])
    ref = jax_lowrank.simulate_block_rotation(**kw)
    out = lowrank.simulate_block_rotation(**kw)
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        assert o.shape == ((kw["N"] + 1,) if trajectory else (kw["N"] - 1,))
        np.testing.assert_array_equal(o, r)


def test_make_figures_writes_the_jax_files(tmp_path):
    paths = lowrank.make_figures(str(tmp_path / "torch"), N=300)
    ref = jax_lowrank.make_figures(str(tmp_path / "jax"), N=300)
    names = ["x1_x2.png", "x1_x3.png", "x1_x4.png", "x4_x3.png",
             "x1_x2_x3.png"]
    assert [p.rsplit("/", 1)[1] for p in paths] == names
    assert [p.rsplit("/", 1)[1] for p in ref] == names
    assert all((tmp_path / "torch" / n).stat().st_size > 0 for n in names)
