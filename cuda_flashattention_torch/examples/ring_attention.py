"""Ladder stage 04: ring attention over the ranks against the exact
oracle, forward and backward.

    python -m cuda_flashattention_torch.examples.ring_attention [--ranks N]
                                                                [--one-card]
                                                                [--cpu]

Counterpart of examples/04_ring_attention.py (the reference's last
stage): stage 03's fp32 inputs (SEQ = 5096, d 64, scale 1.0) cut over the
ranks of a sequence axis, the rank count lowered until it divides SEQ as
the reference requires (8 ranks: 637 rows each, not a tile multiple). It
runs `parallel.ring.ring_attention`:
  - the full ring forward (the reference's only mode): every step K1b;
  - the causal ring forward: diagonal steps K1 (online: 637 rows), steps
    behind the diagonal K1b, steps ahead skipped;
  - the causal ring backward, through torch.autograd on `ring_attention`
    with dO from `seeded_random` (seed 45): K4 on every step that is not
    skipped;
against `ops/naive.py::naive_attention` and `naive_attention_backward`,
gated by `compare_outputs` as the JAX stage gates them (O: rtol 5e-3,
atol 1e-3; gradients: rtol 5e-3, atol 1e-2). Under the launcher every
process makes the same inputs, the ring spans the processes, and each
checks the global O and gradients it gets back.
"""

from __future__ import annotations

import sys

import torch

from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.examples.attention_1chip import SCALE, inputs
from cuda_flashattention_torch.parallel import mesh as mesh_mod
from cuda_flashattention_torch.ops.naive import (
    naive_attention,
    naive_attention_backward,
)
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.parallel.ring import ring_attention
from cuda_flashattention_torch.utils.testing import (
    compare_outputs,
    seeded_random,
)


def run(seq: int, devs):
    """The stage's three ring calls on `devs` → (O full, O causal, (dQ,
    dK, dV) causal) and the inputs (q, k, v, dO), all on this process's
    device."""
    mesh = make_mesh((len(devs),), ("sp",), devs)
    q, k, v = inputs(seq, mesh.home)
    do = torch.from_numpy(seeded_random((1, 1, seq, q.shape[-1]),
                                        seed=45)).to(mesh.home)
    o = ring_attention(q, k, v, mesh=mesh, axis_name="sp", scale=SCALE)
    oc = ring_attention(q, k, v, mesh=mesh, axis_name="sp", scale=SCALE,
                        causal=True)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ring_attention(*leaves, mesh=mesh, axis_name="sp", scale=SCALE,
                         causal=True)
    grads = torch.autograd.grad((out * do).sum(), leaves)
    return o, oc, grads, (q, k, v, do)


def main(argv=None) -> int:
    args = _ladder.parse(__doc__, argv)
    devs = _ladder.devices(args.ranks, args.cpu, args.one_card)
    seq = _ladder.LADDER_SEQ
    n = len(devs)
    while seq % n:
        n -= 1  # the largest rank count that divides SEQ
    if n != len(devs):
        print(f"seq {seq} does not divide over {len(devs)} ranks (the "
              f"reference aborts there); using {n} ranks")
    devs = devs[:n]
    o, oc, (dq, dk, dv), (q, k, v, do) = run(seq, devs)
    mesh = make_mesh((n,), ("sp",), devs)
    first = mesh_mod.process_index() == 0
    if first:
        print(f"ring of {_ladder.where(devs)}, {seq // n} rows each",
              flush=True)
    ok = True
    o_ref, _ = naive_attention(q, k, v, scale=SCALE)
    ok &= compare_outputs(o, o_ref, rtol=5e-3, atol=1e-3,
                          name="ring fwd (full)")
    oc_ref, _ = naive_attention(q, k, v, scale=SCALE, causal=True)
    ok &= compare_outputs(oc, oc_ref, rtol=5e-3, atol=1e-3,
                          name="ring fwd (causal)")
    refs = naive_attention_backward(q, k, v, do, scale=SCALE, causal=True)
    for name, g, ref in zip(("dQ", "dK", "dV"), (dq, dk, dv), refs):
        ok &= compare_outputs(g, ref, rtol=5e-3, atol=1e-2,
                              name=f"ring {name}")
    if first:
        print("max |diff| against the oracle: "
              + ", ".join(f"{name} {(a - b).abs().max().item():.3e}"
                          for name, a, b in (
                              ("O", o, o_ref), ("O causal", oc, oc_ref),
                              ("dQ", dq, refs[0]), ("dK", dk, refs[1]),
                              ("dV", dv, refs[2]))), flush=True)
    return _ladder.report("04_ring_attention", _ladder.agree(mesh, ok))


if __name__ == "__main__":
    sys.exit(main())
