"""The survival statistics (sdeflow_tpu_torch/eval/survival.py) and the
forward-convergence statistics (eval/diagnostics.py) against the JAX
package's on the same numpy draws: the shared R grid, S(R), the counts,
the tail exponent and its k, for Student-t samples (heavy tails, alpha ~
3) with and without a std_norm, one side missing, a tail_k given, and
fewer than 10 samples; the convergence distances and energies of an MSGM
forward solve's stand-in in float32 (rtol 1e-5) and float64 (rtol 1e-10)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdeflow_tpu.eval import diagnostics as jax_diag
from sdeflow_tpu.eval import survival as jax_surv
from sdeflow_tpu_torch.eval import diagnostics, survival

torch.set_num_threads(1)


def _samples(n, d, seed, df=3.0):
    rng = np.random.default_rng(seed)
    return rng.standard_t(df, (n, d)).astype(np.float32)


def _same(out, ref):
    """The survival dicts equal: the grid and S to 1e-12 (norms of float32
    rows, summed in another order), counts, N and the fits' k exactly, the
    fits' alpha to 1e-5."""
    np.testing.assert_allclose(out["R_grid"], ref["R_grid"], rtol=1e-6)
    for tag in ("reference", "generated"):
        o, r = out[tag], ref[tag]
        assert o["N"] == r["N"]
        if r["S"] is None:
            assert o["S"] is None and o["counts"] is None
        else:
            np.testing.assert_array_equal(o["counts"], r["counts"])
            np.testing.assert_array_equal(o["S"], r["S"])
        fo, fr = out["fits"][tag], ref["fits"][tag]
        assert fo["k"] == fr["k"]
        if fr["alpha"] is None:
            assert fo["alpha"] is None
        else:
            assert fo["alpha"] == pytest.approx(fr["alpha"], rel=1e-5)


@pytest.mark.parametrize("case", ["both", "std_norm", "gen_only",
                                  "tail_k", "few"])
def test_survival_analysis_matches_jax(case):
    n = 8 if case == "few" else 2000
    x, x_ref = _samples(n, 16, 0), _samples(n + 37, 16, 1)
    kw = {}
    if case == "std_norm":
        kw["std_norm"] = np.linspace(0.5, 2.0, 16).astype(np.float32)
    if case == "tail_k":
        kw["tail_k"] = 40
    if case == "gen_only":
        x_ref = None
    ref = jax_surv.survival_analysis(
        x=jnp.asarray(x), x_ref=None if x_ref is None else jnp.asarray(x_ref),
        **kw)
    out = survival.survival_analysis(
        x=torch.from_numpy(x),
        x_ref=None if x_ref is None else torch.from_numpy(x_ref), **kw)
    _same(out, ref)
    if case == "both":
        alpha = out["fits"]["generated"]["alpha"]
        assert 1.5 < alpha < 6.0  # a Student-t(3) tail


def test_survival_refuses_no_samples():
    with pytest.raises(ValueError, match="At least one"):
        survival.survival_analysis()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_forward_convergence_stats_match_jax(dtype):
    rng = np.random.default_rng(2)
    x_test = (rng.standard_normal((512, 24)) @ rng.standard_normal((24, 24))
              ).astype(dtype)
    x_fwd = (np.linalg.norm(x_test, axis=1, keepdims=True)
             * rng.standard_normal((512, 24)) / np.sqrt(24)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = {k: float(v) for k, v in jax_diag.forward_convergence_stats(
            jnp.asarray(x_test), jnp.asarray(x_fwd)).items()}
    out = diagnostics.forward_convergence_stats(torch.from_numpy(x_test),
                                                torch.from_numpy(x_fwd))
    assert set(out) == set(ref)
    for k, v in out.items():
        assert v.ndim == 0 and v.dtype == torch.from_numpy(x_test).dtype
        assert float(v) == pytest.approx(
            ref[k], rel=1e-5 if dtype == np.float32 else 1e-10), k
