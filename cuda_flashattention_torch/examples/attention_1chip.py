"""Ladder stage 03: the one-card FlashAttention-2 forward against the
exact oracle, at the ring's shape.

    python -m cuda_flashattention_torch.examples.attention_1chip [--cpu]

Counterpart of examples/03_attention_1chip.py (the reference's rank-0
sanity stage): fp32 Q, K, V [1, 1, SEQ, 64] from `seeded_random` (seeds
42, 43, 44; Q and K x 0.1), SEQ = 5096 (not a tile multiple; or
$CFA_LADDER_SEQ), scale 1.0, not causal.
`flash_attention_forward` (on the card: K1b, where "auto" routes a
non-causal call, with its guarded fallback) against
`ops/naive.py::naive_attention`, through `compare_outputs(rtol=5e-3,
atol=1e-3)` as the JAX stage gates it. `--ranks` and `--one-card` are
taken for the ladder's sake and unused: the stage runs on card 0.
"""

from __future__ import annotations

import sys

import torch

from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_torch.ops.naive import naive_attention
from cuda_flashattention_torch.utils.testing import (
    compare_outputs,
    seeded_random,
)

D, SCALE = 64, 1.0


def inputs(seq: int, device):
    """The stages' fp32 Q, K, V [1, 1, seq, 64]."""
    q = torch.from_numpy(seeded_random((1, 1, seq, D), seed=42)) * 0.1
    k = torch.from_numpy(seeded_random((1, 1, seq, D), seed=43)) * 0.1
    v = torch.from_numpy(seeded_random((1, 1, seq, D), seed=44))
    return q.to(device), k.to(device), v.to(device)


def main(argv=None) -> int:
    args = _ladder.parse(__doc__, argv)
    dev = _ladder.devices(1, args.cpu)[0]
    seq = _ladder.LADDER_SEQ
    q, k, v = inputs(seq, dev)
    o, _ = flash_attention_forward(q, k, v, scale=SCALE)
    o_ref, _ = naive_attention(q, k, v, scale=SCALE)
    ok = compare_outputs(o, o_ref, rtol=5e-3, atol=1e-3,
                         name=f"fa2 vs naive @{seq}x{D}")
    print(f"fp32 forward on {dev}: max |O - oracle| "
          f"{(o - o_ref).abs().max().item():.3e}", flush=True)
    return _ladder.report("03_attention_1chip", ok)


if __name__ == "__main__":
    sys.exit(main())
