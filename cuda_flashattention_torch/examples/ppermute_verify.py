"""Ladder stage 01: the ring's topology, checked hop by hop.

    python -m cuda_flashattention_torch.examples.ppermute_verify [--ranks N]
                                                                 [--one-card]
                                                                 [--cpu]

Counterpart of examples/01_ppermute_verify.py (the reference's NCCL ring
verifier): every rank fills an [8, 128] int32 buffer with its own id, and
the buffers go around the ring n times, each hop a `Mesh.send` from rank
r to rank r + 1 on the receiver's copy stream. After step s rank r must
hold the id r − s (mod n), and after n steps its own again; the stage
counts the elements that say otherwise, which must be none (the ranks'
counts summed by `all_reduce`). Under the launcher the ring spans the
processes: a hop between them is a `Mesh.send` pair.
"""

from __future__ import annotations

import sys

import torch

from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.parallel import mesh as mesh_mod
from cuda_flashattention_torch.parallel.collectives import all_reduce
from cuda_flashattention_torch.parallel.mesh import make_mesh


def main(argv=None) -> int:
    args = _ladder.parse(__doc__, argv)
    devs = _ladder.devices(args.ranks, args.cpu, args.one_card)
    n = len(devs)
    mesh = make_mesh((n,), ("ring",), devs)
    ranks = mesh.axis_ranks("ring")
    mine = mesh.local(ranks)
    bad = {}
    with mesh.region(ranks, mesh.home) as reg:
        buf = {}
        for r in mine:
            with mesh.on(r):
                buf[r] = torch.full((8, 128), r, dtype=torch.int32,
                                    device=mesh.device(r))
                bad[r] = torch.zeros(1, dtype=torch.float32,
                                     device=mesh.device(r))
        like = ((8, 128), torch.int32)
        for step in range(1, n + 1):
            moving = {(r + 1) % n: mesh.send(buf.get(r), r, (r + 1) % n,
                                             like=like)
                      for r in ranks}
            for r in mine:
                reg.keep(buf[r])
                buf[r] = moving[r].wait()
                with mesh.on(r):
                    # provenance: the id that left rank r − step
                    bad[r] += (buf[r] != (r - step) % n).sum()
        for r in mine:
            with mesh.on(r):
                bad[r] += (buf[r] != r).sum()  # home after n hops
            reg.keep(buf[r], bad[r])
    # every rank's count, summed over the ring (across processes too)
    total = int(next(iter(all_reduce(mesh, "ring", bad).values())).item())
    if mesh_mod.process_index() == 0:
        print(f"ring of {_ladder.where(devs)}: {total} provenance "
              f"mismatches")
    return _ladder.report("01_ppermute_verify", total == 0)


if __name__ == "__main__":
    sys.exit(main())
