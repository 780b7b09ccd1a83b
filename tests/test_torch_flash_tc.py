"""The tensor-core attention kernels (csrc/flash_fwd.cu and its body
csrc/flash_fwd.cuh: K4, K7a, and K6 above T = 64; csrc/attention_bwd.cu:
K7b) on the CPU, where they cannot run: the
arithmetic argument for their 3xTF32 products, their tile constants against
the Python mirrors that size their launches, and their shared memory.

(a) An emulation of ``cvt.rna.tf32.f32`` (the low 13 mantissa bits rounded
to nearest, ties away from zero) shows that the 3xTF32 product of a
(4096, 64)·(64, 4096) score tile with the 1.5×-scaled inputs of the card
tests stays within 2e-6·max |float64 product|, and that one TF32 product
does not (it is beyond 1e-4): so the kernels keep the fp32 tolerances of
tests/test_torch_kernels_cuda.py, and plain TF32 would not.
(b) Every ``constexpr int`` tile constant of the attention sources
against its mirror in ops/kernels/attention.py.
(c) The shared memory of the new kernels within a block's 232,448 bytes
for every head width 1–128, computed from the parsed constants and equal to
the Python functions.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from sdeflow_tpu_torch.ops.kernels import attention as A

CSRC = Path(A.__file__).resolve().parents[2] / "csrc"
SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block


def tf32(x):
    """cvt.rna.tf32.f32 on float32 x: round the low 13 mantissa bits to
    nearest, ties away from zero (adding half an ulp to the magnitude
    carries into the kept bits), then clear them."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    cases = np.array([1.0, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11)], np.float32)
    want = np.array([one, one, one + ulp, one + 2 * ulp, -(one + ulp)],
                    np.float32)
    np.testing.assert_array_equal(tf32(cases), want)
    x = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    big, small = split(x)
    assert (big.view(np.uint32) & 0x1FFF == 0).all()
    assert np.abs(x - big).max() <= 2.0 ** -11 * np.abs(x).max()
    # the two halves hold x to ~22 bits
    assert np.abs(x - big - small).max() <= 2.0 ** -21 * np.abs(x).max()


def test_3xtf32_score_tile_keeps_fp32_accuracy():
    rng = np.random.default_rng(0)
    q = 1.5 * rng.standard_normal((4096, 64)).astype(np.float32)
    k = 1.5 * rng.standard_normal((4096, 64)).astype(np.float32)
    (qb, qs), (kb, ks) = split(q), split(k)
    worst3, worst1, top = 0.0, 0.0, 0.0
    for r in range(0, 4096, 512):  # row slabs keep the memory small
        exact = q[r:r + 512].astype(np.float64) @ k.T.astype(np.float64)
        # each TF32 product is exact in fp32; sums in fp32, small terms first
        three = (qs[r:r + 512] @ kb.T + qb[r:r + 512] @ ks.T
                 + qb[r:r + 512] @ kb.T)
        one = qb[r:r + 512] @ kb.T
        top = max(top, np.abs(exact).max())
        worst3 = max(worst3, np.abs(three - exact).max())
        worst1 = max(worst1, np.abs(one - exact).max())
    assert worst3 <= 2e-6 * top, worst3 / top
    assert worst1 > 1e-4 * top, worst1 / top


def _constants(name):
    """The namespace-scope ``constexpr int`` constants of csrc/<name>,
    evaluated in order (C++ integer division written as Python's)."""
    src = (CSRC / name).read_text()
    out = {}
    for key, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                re.M):
        expr = re.sub(r"(?<!/)/(?!/)", "//", expr)
        out[key] = eval(expr, {}, dict(out))  # noqa: S307 - our own source
    return out


def test_tile_constants_match_the_python_mirrors():
    k6 = _constants("attention.cu")
    assert (k6["kWarps"], k6["kShortT"]) == (A._K6_WARPS, A._K6_SHORT_T)
    assert (k6["kPadQK"], k6["kPadV"]) == (A._PAD_QK, A._PAD_V)
    fwd = _constants("flash_fwd.cuh")
    assert (fwd["kRows"], fwd["kKeys"]) == (A._FWD_ROWS, A._FWD_KEYS)
    bwd = _constants("attention_bwd.cu")
    assert (bwd["kKeys"], bwd["kQRows"], bwd["kQRowsWide"],
            bwd["kWideFrom"]) == (A._BWD_KEYS, A._BWD_ROWS,
                                  A._BWD_ROWS_WIDE, A._BWD_WIDE_FROM)
    for c in (fwd, bwd):
        assert (c["kStages"], c["kPadQK"]) == (A._STAGES, A._PAD_QK)
    assert (fwd["kPadV"], bwd["kPadDS"]) == (A._PAD_V, A._PAD_DS)
    # the widths the C entries pad to (ch <= 32, <= 64, else 128)
    for name in ("flash_fwd.cu", "attention_bwd.cu", "attention.cu"):
        src = (CSRC / name).read_text()
        cuts = {int(w) for w in re.findall(r"if \(ch <= (\d+)\)", src)}
        widths = {int(w) for w in re.findall(r"launch_w<(\d+)[,>]", src)}
        assert tuple(sorted(cuts)) + (A.MAX_HEAD_WIDTH,) == A._WIDTHS
        assert widths == set(A._WIDTHS)


def _fwd_bytes(c, w):
    """flash_fwd.cuh's Layout<W>::bytes from its parsed constants."""
    ld, ldv = w + c["kPadQK"], w + c["kPadV"]
    return 4 * (2 * c["kRows"] * ld + c["kStages"] * c["kKeys"] * (ld + ldv))


def _bwd_bytes(c, w):
    """attention_bwd.cu's Layout<W>::bytes from its parsed constants."""
    rows = c["kQRowsWide"] if w >= c["kWideFrom"] else c["kQRows"]
    ld = w + c["kPadQK"]
    assert c["kKeys"] * (rows + c["kPadDS"]) <= 2 * rows * ld  # dS^T fits
    return 4 * (2 * c["kKeys"] * ld + c["kStages"] * (2 * rows * ld + 2 * rows))


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_shared_memory_fits_a_block_at_every_head_width(kernel):
    fwd, bwd = _constants("flash_fwd.cuh"), _constants("attention_bwd.cu")
    for ch in range(1, A.MAX_HEAD_WIDTH + 1):
        w = A._padded_width(ch)
        assert ch <= w and w % 8 == 0
        if kernel == "fwd":
            got, want = A.flash_fwd_smem_bytes(ch), _fwd_bytes(fwd, w)
        else:
            got, want = A.bwd_smem_bytes(ch), _bwd_bytes(bwd, w)
        assert got == want and got <= SMEM_LIMIT, (ch, got, want)
    # the widest head, and two K7b blocks per SM at W = 64
    assert A.flash_fwd_smem_bytes(128) == 204_800
    assert A.bwd_smem_bytes(128) == 135_680
    assert 2 * (A.bwd_smem_bytes(64) + 1024) <= 233_472  # 1 KB per block
