"""Ladder stage 06: the paged-cache serving lifecycle.

    python -m cuda_flashattention_torch.examples.paged_serving [--cpu]

Counterpart of examples/06_paged_serving.py: fp32 pools of 16 pages of 16
tokens (B = 2, Hkv = 2, H = 4, d = 32, 6 table slots per sequence). A
page-aligned 32-token prompt per sequence goes in through `reserve_for`
and `paged_bulk_append`; then 10 steps of `reserve_for`, `paged_append`
and `paged_decode_step`, each held within 1e-5 against
`decode_attention` on a contiguous shadow of the same keys; then sequence
0 retires (3 pages reclaimed) and a reservation of 16 tokens takes one of
them back. Inputs are numpy draws seeded with 11, as the JAX stage's.

The shadow's `decode_attention` takes `block_k=page`, as in the JAX
stage: on the card K6 then splits the context into pages of keys (its
split size), so each split sums one page's keys; on the CPU the plain
version takes no tile. On the card `paged_decode_step` runs K7's fp32
build at d = 32 and the shadow's `decode_attention` K6's. `--ranks` and
`--one-card` are taken for the ladder's sake and unused: the stage runs
on card 0.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.ops.decode import decode_attention
from cuda_flashattention_torch.ops.paged import (
    PageAllocator,
    init_paged_cache,
    paged_append,
    paged_bulk_append,
    paged_decode_step,
)

B, HKV, H, PAGE, MAX_PAGES, D = 2, 2, 4, 16, 6, 32
N_PAGES, PROMPT, STEPS, GATE = 16, 32, 10, 1e-5


def draws(seed: int = 11):
    """The stage's inputs as numpy fp32 arrays, drawn in the JAX stage's
    order: (k_prompt, v_prompt [B, HKV, PROMPT, D], and per decode step
    (k_new, v_new [B, HKV, D], q [B, H, D]))."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    k_prompt, v_prompt = u(B, HKV, PROMPT, D), u(B, HKV, PROMPT, D)
    return k_prompt, v_prompt, [(u(B, HKV, D), u(B, HKV, D), u(B, H, D))
                                for _ in range(STEPS)]


def run(dev):
    """The lifecycle on `dev`: (the paged O of each decode step, the
    contiguous shadow's O of each, the pages the retirement reclaimed,
    the free pages after the new reservation less those before the
    retirement)."""
    k_prompt, v_prompt, steps = draws()

    def put(x):
        return torch.from_numpy(x).to(dev)

    cache = init_paged_cache(N_PAGES, B, MAX_PAGES, HKV, PAGE, D,
                             dtype=torch.float32, device=dev)
    alloc = PageAllocator(N_PAGES)

    # prefill: one page-aligned chunk of PROMPT tokens per sequence
    for i in range(B):
        alloc.reserve_for(cache, i, PROMPT)
    paged_bulk_append(cache, put(k_prompt), put(v_prompt))

    # decode, each step against a contiguous shadow of the same keys
    shadow_k = torch.zeros((B, HKV, PAGE * MAX_PAGES, D), device=dev)
    shadow_v = torch.zeros_like(shadow_k)
    shadow_k[:, :, :PROMPT] = put(k_prompt)
    shadow_v[:, :, :PROMPT] = put(v_prompt)
    outs, refs = [], []
    for t, (k_new, v_new, q) in enumerate(steps):
        for i in range(B):
            alloc.reserve_for(cache, i, 1)
        paged_append(cache, put(k_new), put(v_new))
        shadow_k[:, :, PROMPT + t] = put(k_new)
        shadow_v[:, :, PROMPT + t] = put(v_new)
        outs.append(paged_decode_step(put(q), cache)[0])
        lengths = torch.full((B,), PROMPT + 1 + t, dtype=torch.int32,
                             device=dev)
        refs.append(decode_attention(put(q), shadow_k, shadow_v, lengths,
                                     block_k=PAGE)[0])

    # retire sequence 0, reuse its pages
    free_before = len(alloc.free)
    alloc.release_sequence(cache, 0)
    freed = len(alloc.free) - free_before
    alloc.reserve_for(cache, 0, 16)
    return outs, refs, freed, len(alloc.free) - free_before


def main(argv=None) -> int:
    args = _ladder.parse(__doc__, argv)
    dev = _ladder.devices(1, args.cpu)[0]
    outs, refs, freed, kept = run(dev)
    d_max = max((o - r).abs().max().item() for o, r in zip(outs, refs))
    print(f"{STEPS} paged decode steps vs contiguous shadow: max diff "
          f"{d_max:.2e}", flush=True)
    print(f"sequence retired: {freed} pages reclaimed", flush=True)
    # ceil(42 / 16) pages reclaimed, one of them taken back
    ok = d_max < GATE and freed == 3 and kept == 2
    return _ladder.report("06_paged_serving", ok)


if __name__ == "__main__":
    sys.exit(main())
