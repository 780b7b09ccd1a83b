"""The bf16 body of K4 and K7a (csrc/flash_fwd.cu, on wgmma) on the CPU,
where it cannot run: its Python mirrors against the constants parsed
from the source, and its plain twins in bf16 against the
JAX package at a T that is ragged for the kernel's 64-key tiles.

(a) The query rows per block and the grid per (B, T, heads):
``attention.flash_fwd_bf16_rows`` at the paths' shapes and at both edges
of ``bf_groups``' rule, with the rule's parsed constants.
(b) Shared memory per head width 1-128 for both blocks, from the parsed
``LayoutBf`` constants, within one block's 232,448 bytes; at W = 64 at
least two blocks an SM by shared memory (with the stages' mbarriers),
threads and the registers that ``__launch_bounds__`` leaves a thread.
(c) ``attention_flash_stats_math`` (K7a's twin, the kernel body's rounding
points) against ``_attention_flash_stats`` in interpret mode, and
``attention_flash_math`` (K4's twin, the math version's) against
``_attention_flash_math`` and ``_attention_math``, in bf16 at T = 100,
held as tests/test_torch_attention_bf16.py holds them.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdeflow_tpu.ops.pallas import attention as jax_attn
from sdeflow_tpu.ops.pallas.common import force_interpret
from sdeflow_tpu_torch.ops.kernels import attention as A
from test_torch_attention_bf16 import BF, _inputs, _jax, _np, \
    assert_bf16_close
from test_torch_flash_tc import _constants

torch.set_num_threads(1)
SRC = Path(A.__file__).resolve().parents[2] / "csrc" / "flash_fwd.cu"
SMEM_LIMIT, SM_SMEM = 232_448, 233_472  # a block's; an SM's (1 KB a block)
SMS, SM_THREADS, SM_REGS = 132, 2048, 65_536  # the H100's
C = _constants("flash_fwd.cu")


# (B, T, heads) -> rows per block and blocks: the long-sequence block
# (4, 4096, 64), the request's (16, 4096, 64) and the DSM step's
# (128, 4096, 64); 264 and 253 blocks of 128 rows at the rule's edge;
# phase 23's ragged K7a (2, 1000, 64)
PLANS = [((4, 4096, 1), 64, 256), ((16, 4096, 1), 128, 512),
         ((128, 4096, 1), 128, 4096), ((24, 1408, 1), 128, 264),
         ((23, 1408, 1), 64, 506), ((2, 1000, 1), 64, 32)]


@pytest.mark.parametrize("shape,rows,blocks", PLANS,
                         ids=["long-block", "request", "dsm", "edge-264",
                              "edge-253", "ragged"])
def test_rows_and_grid_match_the_chooser(shape, rows, blocks):
    b, t, heads = shape
    assert (C["kBfGroupRows"], C["kBfWideFrom"]) == (
        A._FWD_BF_GROUP_ROWS, A._FWD_BF_WIDE_FROM) == (64, 2 * SMS)
    assert A.flash_fwd_bf16_rows(b, t, heads) == rows
    assert b * heads * -(-t // rows) == blocks


@pytest.mark.parametrize("rows", [64, 128])
def test_shared_memory_fits_a_block_at_every_head_width(rows):
    stages, keys = C["kBfStages"], C["kBfKeys"]
    assert (stages, keys) == (A._FWD_BF_STAGES, A._FWD_BF_KEYS)
    for ch in range(1, A.MAX_HEAD_WIDTH + 1):
        w = 64 if ch <= 64 else 128
        want = 1024 + 2 * rows * w + stages * 2 * 2 * keys * w
        got = A.flash_fwd_smem_bytes(ch, BF, rows)
        assert got == want <= SMEM_LIMIT, (ch, got, want)
    # the fp32 layout is untouched by the rows
    assert A.flash_fwd_smem_bytes(64, torch.float32, rows) == \
        A.flash_fwd_smem_bytes(64)


def test_two_blocks_per_sm_at_head_width_64():
    src = SRC.read_text()
    bounds = re.findall(r"__launch_bounds__\(128 \* G, W == 64 \? (\d+) : 1\)"
                        r"\nflash_fwd(?:_stats)?_bf16_kernel", src)
    assert len(bounds) == 2 and len(set(bounds)) == 1  # both symbols
    least = int(bounds[0])  # __launch_bounds__'s blocks an SM at W = 64
    assert least >= 2
    # the static shared memory beside the dynamic: the stages' mbarriers
    assert re.search(r"__shared__ __align__\(8\) uint64_t full\[kBfStages\];",
                     src)
    static = 8 * C["kBfStages"]
    for groups in (1, 2):
        threads, rows = 128 * groups, 64 * groups
        smem = A.flash_fwd_smem_bytes(64, BF, rows)
        # what holds `least` blocks: threads, the registers that the bound
        # leaves a thread (at least 128) and shared memory
        assert least * threads <= SM_THREADS
        assert SM_REGS // (least * threads) >= 128
        assert least * (smem + static + 1024) <= SM_SMEM, (groups, smem)
    assert A.flash_fwd_smem_bytes(64, BF, 128) == 82_944
    assert A.flash_fwd_smem_bytes(64, BF, 64) == 74_752


@pytest.mark.parametrize("heads,kv_block", [(1, 16), (2, None)],
                         ids=["1head-tiles16", "2heads"])
def test_flash_stats_math_bf16_ragged_matches_jax_kernel(
        monkeypatch, heads, kv_block):
    """K7a's twin at T = 100 (ragged for the kernel's 64-key tiles; with
    kv_block, for its own 16-key tiles too) against JAX's K7a body."""
    if kv_block:
        monkeypatch.setattr(A, "_FLASH_KV_BLOCK", kv_block)
    b, t, c = 2, 100, 64
    qkv = _inputs((b, t, 3 * c), 11)
    with force_interpret():
        ref = {dt: jax_attn._attention_flash_stats(_jax(qkv, dt), heads)
               for dt in (jnp.bfloat16, jnp.float32)}
    out, lse = A.attention_flash_stats_math(torch.from_numpy(qkv).to(BF),
                                            heads)
    assert out.dtype == BF and lse.shape == (b, heads, t)
    assert_bf16_close(out, ref[jnp.bfloat16][0], ref[jnp.float32][0], "out")
    np.testing.assert_allclose(lse.numpy(), _np(ref[jnp.bfloat16][1]),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("heads", [1, 2])
def test_flash_math_bf16_ragged_matches_jax(heads):
    """K4's twin at T = 100 with key tiles of 16 (T % 16 ≠ 0: both sides
    fall back to the math version) against _attention_flash_math and
    _attention_math."""
    qkv = _inputs((2, 100, 3 * 64), 12)
    out = A.attention_flash_math(torch.from_numpy(qkv).to(BF), heads,
                                 kv_block=16)
    assert out.dtype == BF
    for fn in (lambda q: jax_attn._attention_flash_math(q, heads,
                                                        kv_block=16),
               lambda q: jax_attn._attention_math(q, heads)):
        ref = {dt: fn(_jax(qkv, dt)) for dt in (jnp.bfloat16, jnp.float32)}
        assert_bf16_close(out, ref[jnp.bfloat16], ref[jnp.float32], "out")
