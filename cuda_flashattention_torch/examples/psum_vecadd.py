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
--cpu).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.parallel.collectives import all_reduce
from cuda_flashattention_torch.parallel.mesh import make_mesh

N = 1_000_000  # the reference's vector


def main(argv=None) -> int:
    args = _ladder.parse(__doc__, argv)
    devs = _ladder.devices(args.ranks, args.cpu, args.one_card)
    mesh = make_mesh((len(devs),), ("dp",), devs)
    ranks = mesh.axis_ranks("dp")
    a = torch.arange(N, dtype=torch.float32, device=devs[0])
    b = torch.full((N,), 2.0, device=devs[0])
    parts = list(zip(a.tensor_split(len(ranks)), b.tensor_split(len(ranks))))

    def add():
        """Each rank's c = a + b and its sum, then the all-reduce."""
        c, sums = {}, {}
        with mesh.region(ranks, devs[0]) as reg:
            for r, (ar, br) in zip(ranks, parts):
                with mesh.on(r):
                    ar, br = (x.to(mesh.device(r), non_blocking=True)
                              for x in (ar, br))
                    c[r] = ar + br
                    sums[r] = c[r].sum().reshape(1)
                reg.keep(ar, br, c[r], sums[r])
        return c, all_reduce(mesh, "dp", sums)

    c, total = add()
    print(f"vecadd over {_ladder.where(devs)}: "
          f"{_ladder.time_ms(add, devs)} ({N} elements)", flush=True)
    expected = float(np.sum(np.arange(N, dtype=np.float64) + 2.0))
    got = [total[r].item() for r in ranks]
    ok = all(abs(x - expected) < 1e-3 * abs(expected) for x in got)
    ok &= len(set(got)) == 1  # the same bits on every rank
    first = c[ranks[0]][:5].cpu()
    ok &= bool(torch.equal(first, torch.arange(5, dtype=torch.float32) + 2))
    print(f"checksum {got[0]:.6e} on every rank (expected {expected:.6e})")
    return _ladder.report("00_psum_vecadd", ok)


if __name__ == "__main__":
    sys.exit(main())
