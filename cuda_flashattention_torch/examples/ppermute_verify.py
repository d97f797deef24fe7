"""Ladder stage 01: the ring's topology, checked hop by hop.

    python -m cuda_flashattention_torch.examples.ppermute_verify [--ranks N]
                                                                 [--one-card]
                                                                 [--cpu]

Counterpart of examples/01_ppermute_verify.py (the reference's NCCL ring
verifier): every rank fills an [8, 128] int32 buffer with its own id, and
the buffers go around the ring n times, each hop a `Mesh.send` from rank
r to rank r + 1 on the receiver's copy stream. After step s rank r must
hold the id r − s (mod n), and after n steps its own again; the stage
counts the elements that say otherwise, which must be none.
"""

from __future__ import annotations

import sys

import torch

from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.parallel.mesh import make_mesh


def main(argv=None) -> int:
    args = _ladder.parse(__doc__, argv)
    devs = _ladder.devices(args.ranks, args.cpu, args.one_card)
    n = len(devs)
    mesh = make_mesh((n,), ("ring",), devs)
    ranks = mesh.axis_ranks("ring")
    bad = {}
    with mesh.region(ranks, devs[0]) as reg:
        buf = {}
        for r in ranks:
            with mesh.on(r):
                buf[r] = torch.full((8, 128), r, dtype=torch.int32,
                                    device=mesh.device(r))
                bad[r] = torch.zeros((), dtype=torch.int64,
                                     device=mesh.device(r))
        for step in range(1, n + 1):
            moving = {(r + 1) % n: mesh.send(buf[r], r, (r + 1) % n)
                      for r in ranks}
            for r in ranks:
                reg.keep(buf[r])
                buf[r] = moving[r].wait()
                with mesh.on(r):
                    # provenance: the id that left rank r − step
                    bad[r] += (buf[r] != (r - step) % n).sum()
        for r in ranks:
            with mesh.on(r):
                bad[r] += (buf[r] != r).sum()  # home after n hops
            reg.keep(buf[r], bad[r])
    total = sum(int(bad[r].item()) for r in ranks)
    print(f"ring of {_ladder.where(devs)}: {total} provenance mismatches")
    return _ladder.report("01_ppermute_verify", total == 0)


if __name__ == "__main__":
    sys.exit(main())
