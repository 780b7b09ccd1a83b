#!/usr/bin/env python3
"""K3's bf16 kernel of this tree against the same kernel built from another
tree of the package, bit for bit, on one NVIDIA GPU.

    python3 tools/torch_k3_bf16_parent.py PARENT_DIR

PARENT_DIR holds another checkout of the repository (for example the
parent commit unpacked by ``git archive`` into the git-ignored
``_parent/``). Both trees' ``csrc/attnblock.cu`` are built with nvcc; K3 in
bf16 runs through this tree's wrapper on both libraries at grf16's two
AttentionBlock shapes, (B, T, C) = (1024, 64, 64) and (1024, 16, 128), and
at (16, 64, 64) with four heads, with random non-zero weights; exits
non-zero unless every output is equal bit for bit.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sdeflow_tpu_torch.models.common import group_count  # noqa: E402
from sdeflow_tpu_torch.ops.kernels import attnblock as ab  # noqa: E402
from sdeflow_tpu_torch.ops.kernels import common  # noqa: E402

SHAPES = [(1024, 64, 64, 1), (1024, 16, 128, 1), (16, 64, 64, 4)]


def main(parent):
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    src = (Path(parent).resolve() / "sdeflow_tpu_torch" / "csrc"
           / "attnblock.cu")
    other = common.Kernel("attn_block_parent", str(src), ab.K3.signatures)
    libs = {"this tree": ab.K3.lib(), "parent": other.lib()}
    g = torch.Generator(device="cuda").manual_seed(0)
    equal = True
    for b, t, c, heads in SHAPES:
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device="cuda")

        args = [(2.0 * rnd(b, t, c) + 0.5).to(torch.bfloat16),
                1.0 + 0.1 * rnd(c), 0.1 * rnd(c), rnd(c, 3 * c) / c**0.5,
                0.1 * rnd(3 * c), rnd(c, c) / c**0.5, 0.1 * rnd(c)]
        outs = {}
        with torch.no_grad():
            for name, lib in libs.items():
                ab.K3._lib = lib
                outs[name] = ab._launch(*args, group_count(c), heads)
        ab.K3._lib = libs["this tree"]
        torch.cuda.synchronize()
        same = torch.equal(outs["this tree"].view(torch.int16),
                           outs["parent"].view(torch.int16))
        equal &= same
        print(f"K3 bf16 at {(b, t, c)} heads={heads}: bit for bit "
              f"{'equal' if same else 'DIFFERENT'} to the parent's")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
