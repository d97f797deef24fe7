"""Ladder stage 02: copies under compute, on each rank's two streams.

    python -m cuda_flashattention_torch.examples.overlap [--ranks N]
                                                         [--one-card] [--cpu]

Counterpart of examples/02_overlap.py (the reference's dual-stream
template): every rank holds a 256 x 128 fp32 block and a 128 x 128 weight
w; the blocks rotate around the ring, each hop a `Mesh.send` queued on the
receiver's copy stream BEFORE the step's product acc += block @ w is
queued on its compute stream, and awaited after it. After n steps every
rank holds Σ_s block_s @ w, which must be within 1e-3 of the sequential
sum. The products are plain `torch.matmul` in fp32 with TF32 off. The
stage prints the loop's time and, on a card, the share of the copies'
time that ran under a product (torch.profiler; `--cpu` prints "not
measured"). Under the launcher the ring spans the processes (each
process's ranks hold their blocks; the error is each process's, and the
verdict every process's).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.parallel import mesh as mesh_mod
from cuda_flashattention_torch.parallel.mesh import make_mesh

ROWS, D, GATE = 256, 128, 1e-3


def main(argv=None) -> int:
    args = _ladder.parse(__doc__, argv)
    devs = _ladder.devices(args.ranks, args.cpu, args.one_card)
    n = len(devs)
    mesh = make_mesh((n,), ("ring",), devs)
    ranks = mesh.axis_ranks("ring")
    mine = mesh.local(ranks)
    rng = np.random.default_rng(0)
    kv = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, ROWS, D))
                          .astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (D, D)).astype(np.float32))
    blocks = {r: kv[i].to(mesh.device(r)) for i, r in enumerate(ranks)
              if r in mine}
    ws = {r: w.to(mesh.device(r)) for r in mine}

    def ring():
        acc = {}
        with mesh.region(ranks, mesh.home) as reg:
            cur = dict(blocks)
            for r in mine:
                with mesh.on(r):
                    acc[r] = torch.zeros((ROWS, D), device=mesh.device(r))
            for step in range(n):
                # the next blocks start moving before this step's products
                moving = ({(r + 1) % n: mesh.send(
                    cur.get(r), r, (r + 1) % n, like=((ROWS, D),
                                                       torch.float32))
                    for r in ranks} if step < n - 1 else {})
                for r in mine:
                    with mesh.on(r):
                        acc[r] += cur[r] @ ws[r]
                for r in mine:
                    if r in moving:
                        reg.keep(cur[r])
                        cur[r] = moving[r].wait()
            reg.keep(*cur.values(), *acc.values())
        return acc

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = ring()
        ref = torch.einsum("srd,de->re", kv.double(), w.double())
        err = max((acc[r].double().cpu() - ref).abs().max().item()
                  for r in mine)
        timed, covered = _ladder.time_ms(ring, devs), _covered(ring, devs)
        ok = _ladder.agree(mesh, err < GATE)
        if mesh_mod.process_index() == 0:
            print(f"overlap loop over {_ladder.where(devs)}: {timed} "
                  f"({ROWS}x{D} block per rank); max |acc - sequential| "
                  f"{err:.3e}", flush=True)
            print(f"copy time under a product: {covered}", flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return _ladder.report("02_overlap", ok)


def _covered(fn, devs) -> str:
    """The share of the copies' device time during which a product ran
    (torch.profiler: copies are the profiler's Memcpy events, products
    the other kernels)."""
    if _ladder.home(devs).type != "cuda":
        return "not measured (CPU ranks)"
    from cuda_flashattention_torch.utils.profiling import (
        covered_share, device_events)
    events, _ = device_events(fn)
    copies = [e for e in events if "Memcpy" in e.name]
    products = [e for e in events if "Memcpy" not in e.name
                and "Memset" not in e.name]
    if not copies:
        return "not measured (the profiler recorded no copy)"
    ms = sum(e.end_us - e.start_us for e in copies) / 1e3
    return (f"{covered_share(copies, products):.1%} of {len(copies)} "
            f"copies ({ms:.3f} ms)")


if __name__ == "__main__":
    sys.exit(main())
