"""The tensor-core kernels K6 (csrc/attention.cu) and K3 (csrc/attnblock.cu)
on the CPU, where they cannot run: their constants against the Python
mirrors that size their launches, their shared memory at every shape they
take, and the arithmetic argument for K3's projections.

(a) Every ``constexpr int`` constant of attnblock.cu against its mirror in
ops/kernels/attnblock.py, and K6's short-sequence layout (attention.cu)
recomputed from its parsed constants against ``attention.smem_bytes``.
(b) K6's block within 232,448 bytes at every T up to 1024 and head width
up to 128; K3's plan (``block_plan``) found and within a block at every
(T, C, groups, heads) that the CUDA-core design it replaced took (T ≤ 256,
heads 1–8), so that no "auto" AttentionBlock changes route (that case, one
T at a time, in test_torch_attn_tc_plans.py).
(c) An emulation of K3's projection chain at C = 128 (the 3xTF32 split of
``cvt.rna.tf32.f32``, each mma's exact products added to its fp32
accumulator with rounding toward zero, as the tensor cores do, each ring
tile's eight k-steps in fresh big and small accumulators added in fp32)
stays within phase 3's rtol/atol 1e-5 of the float64 product; one chain
of all 16 k-steps with the terms together does not keep the same margin.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from sdeflow_tpu_torch.ops.kernels import attention as A
from sdeflow_tpu_torch.ops.kernels import attnblock as K3

CSRC = Path(A.__file__).resolve().parents[2] / "csrc"
SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block


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


def _up(x, m):
    return -(-x // m) * m


def test_constants_match_the_python_mirrors():
    c = _constants("attnblock.cu")
    assert (c["kPassRows"], c["kKc"], c["kNc"], c["kStages"], c["kPadA"],
            c["kPadV"], c["kPadW"]) == (K3._PASS_ROWS, K3._KC, K3._NC,
                                        K3._STAGES, K3._PAD_A, K3._PAD_V,
                                        K3._PAD_W)
    assert c["kItems"] * c["kWarps"] == 2 * c["kPassRows"] // 16
    k6 = _constants("attention.cu")
    for t in range(1, k6["kShortT"] + 1):
        tp = _up(t, 16)
        units = k6["kWarps"] // (tp // 16)
        for ch in (1, 8, 16, 20, 64, 128):
            w = _up(ch, 8)
            want = 4 * units * tp * (2 * (w + k6["kPadQK"]) + w + k6["kPadV"])
            assert A.smem_bytes(t, ch) == want, (t, ch)
    # above T = 64 K6 is flash_fwd.cuh's K6 variant: raw Q, 32-key tiles
    f = _constants("flash_fwd.cuh")
    assert f["kKeysK6"] == A._K6_KEYS
    for ch in (1, 32, 33, 64, 100, 128):
        w = A._padded_width(ch)
        want = 4 * (f["kRows"] * (w + f["kPadQK"]) + f["kStages"]
                    * f["kKeysK6"] * (2 * w + f["kPadQK"] + f["kPadV"]))
        assert A.smem_bytes(65, ch) == want, ch
    assert 2 * (A.smem_bytes(1024, 128) + 1024) <= 233_472  # 2 per SM


def test_k6_shared_memory_fits_a_block_at_every_shape():
    worst = max(A.smem_bytes(t, ch) for t in range(1, 1025)
                for ch in range(1, A.MAX_HEAD_WIDTH + 1))
    assert worst <= SMEM_LIMIT
    # grf16's shapes: 4 units of T = 16 at ch = 128, 1 of T = 64 at 64
    assert A.smem_bytes(16, 128) == 4 * 4 * 16 * (2 * 132 + 136)
    assert A.smem_bytes(64, 64) == 4 * 64 * (2 * 68 + 72)


def _cuda_core_query_chunk(t, c, groups):
    """The CUDA-core kernel's chunk of Q rows (its smem_bytes with 256
    threads), or None: the shapes it took."""
    def smem(tq):
        return 4 * (t * c + t * (c + 1) + t * c + tq * c + 8 * t + c
                    + 2 * groups)
    tq = t
    while smem(tq) > SMEM_LIMIT:
        if tq <= 8:
            return None
        tq = (tq + 1) // 2
    return tq


def tf32(x):
    """cvt.rna.tf32.f32: the low 13 mantissa bits rounded to nearest, ties
    away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    big = tf32(x)
    return big, tf32(x - big)


def _rz(v):
    """float64 -> float32 rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma(acc, a, b):
    """acc + a·b over one k-step of 8 (tf32 products exact), rounded toward
    zero into the fp32 accumulator."""
    return _rz(acc.astype(np.float64)
               + a.astype(np.float64) @ b.astype(np.float64))


def _projection(h, w, chunk):
    """h·w as K3 forms it: k-steps of 8 in 3xTF32, big products into one
    accumulator and the small terms into another, both fresh every `chunk`
    k-steps and then added in fp32 (chunk = all k-steps: one chain)."""
    (hb, hs), (wb, ws) = _split(h), _split(w)
    total = np.zeros((h.shape[0], w.shape[1]), np.float32)
    steps = h.shape[1] // 8
    for c0 in range(0, steps, chunk):
        big = np.zeros_like(total)
        small = np.zeros_like(total)
        for k in range(8 * c0, 8 * min(steps, c0 + chunk), 8):
            small = _mma(small, hs[:, k:k + 8], wb[k:k + 8])
            small = _mma(small, hb[:, k:k + 8], ws[k:k + 8])
            big = _mma(big, hb[:, k:k + 8], wb[k:k + 8])
        total = total + (big + small)
    return total


def test_3xtf32_projection_chain_keeps_fp32_accuracy():
    # C = 128, 64 rows of h (4 samples at T = 16), Wqkv's 384
    # columns; h as a GroupNorm leaves it, the weights of chip_smoke.py
    rng = np.random.default_rng(0)
    c = 128
    h = (rng.standard_normal((64, c)) * 1.1 + 0.1).astype(np.float32)
    w = (rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32)
    exact = h.astype(np.float64) @ w.astype(np.float64)
    kernel = _projection(h, w, K3._KC // 8)  # 8 k-steps per ring tile
    err = np.abs(kernel - exact)
    assert (err <= 1e-5 + 1e-5 * np.abs(exact)).all()
    top = np.abs(exact).max()
    assert err.max() <= 3e-7 * top, err.max() / top  # plain fp32: 4.1e-7
    # the same products in one chain of 16 k-steps drift further
    one_chain = _projection(h, w, c // 8)
    assert np.abs(one_chain - exact).max() > err.max()
