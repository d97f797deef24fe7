"""Ladder stage 00: a sharded vector add and its all-reduced checksum.

    python -m cuda_flashattention_torch.examples.psum_vecadd [--ranks N]
                                                             [--one-card]
                                                             [--cpu]

Counterpart of examples/00_psum_vecadd.py (the reference's MPI vecadd): a
vector of 1,000,000 fp32 elements, a = 0, 1, 2, ... and b = 2, is split
over the ranks with a remainder (`tensor_split`), each rank adds its part
on its own device and stream, and the ranks' partial sums go through
`parallel.collectives.all_reduce`. Every rank's checksum must be within
1e-3 of Σ (i + 2) relatively, and the first elements 2, 3, 4, 5, 6. It
proves the mesh, the placement on the ranks and a cross-rank sum before
any attention. The add is timed with CUDA events (the host's clock on
--cpu). Under the launcher the vector is split over every process's
ranks and the all-reduce spans them.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.parallel import mesh as mesh_mod
from cuda_flashattention_torch.parallel.collectives import (
    all_gather,
    all_reduce,
)
from cuda_flashattention_torch.parallel.mesh import make_mesh

N = 1_000_000  # the reference's vector


def main(argv=None) -> int:
    args = _ladder.parse(__doc__, argv)
    devs = _ladder.devices(args.ranks, args.cpu, args.one_card)
    mesh = make_mesh((len(devs),), ("dp",), devs)
    ranks = mesh.axis_ranks("dp")
    mine = mesh.local(ranks)
    a = torch.arange(N, dtype=torch.float32, device=mesh.home)
    b = torch.full((N,), 2.0, device=mesh.home)
    parts = dict(zip(ranks, zip(a.tensor_split(len(ranks)),
                                b.tensor_split(len(ranks)))))

    def add():
        """Each rank's c = a + b and its sum, then the all-reduce."""
        c, sums = {}, {}
        with mesh.region(ranks, mesh.home) as reg:
            for r in mine:
                with mesh.on(r):
                    ar, br = (x.to(mesh.device(r), non_blocking=True)
                              for x in parts[r])
                    c[r] = ar + br
                    sums[r] = c[r].sum().reshape(1)
                reg.keep(ar, br, c[r], sums[r])
        return c, all_reduce(mesh, "dp", sums)

    c, total = add()
    timed = _ladder.time_ms(add, devs)
    expected = float(np.sum(np.arange(N, dtype=np.float64) + 2.0))
    # every rank's checksum, gathered from every process
    got = all_gather(mesh, "dp", total, 0)[mine[0]].tolist()
    ok = all(abs(x - expected) < 1e-3 * abs(expected) for x in got)
    ok &= len(set(got)) == 1  # the same bits on every rank
    first = c[mine[0]][:5].cpu()
    start = sum(p[0].numel() for r, p in parts.items() if r < mine[0])
    ok &= bool(torch.equal(first, torch.arange(
        start, start + 5, dtype=torch.float32) + 2))
    ok = _ladder.agree(mesh, ok)
    if mesh_mod.process_index() == 0:
        print(f"vecadd over {_ladder.where(devs)}: {timed} ({N} elements)",
              flush=True)
        print(f"checksum {got[0]:.6e} on every rank (expected "
              f"{expected:.6e})")
    return _ladder.report("00_psum_vecadd", ok)


if __name__ == "__main__":
    sys.exit(main())
