"""Ladder stage: the device-initiated ring exchange.

    python -m cuda_flashattention_torch.examples.device_ring [--ranks N]
                                                             [--width D]
                                                             [--cpu]

Counterpart of examples/07_device_ring.py. Every rank of a ring holds a
shard x_i [L, d] (L = 1024, d = 128 or `--width`, any d up to 256, bf16);
the ring rotates the shards
while each rank accumulates o = (Σ_i x_i) @ W. Two rings run on the same
inputs: `device_ring_matmul`, whose CUDA kernel pushes the shards and
orders the steps itself (csrc/device_ring.cu), and `ring_matmul_plain`,
the same ring with host-driven copies and one `torch.matmul` per step.
Both must come within 1e-2 of tile((Σ_i x_i) @ W) computed in fp32; the
stage prints both differences, the time per iteration of each ring (20
iterations) and `Test PASSED!` or `Test FAILED!`, and exits 0 or 1.

The ring runs over the visible cards, one rank per card; with a single
card `--ranks` ranks (default 4) share it, each with its own streams: the
kernel, its flags and its pushes are the same code either way. `--cpu`
runs the stage on CPU tensors, where both rings are the plain version.
Under the launcher (scripts/launch_multihost.py) the ring is the global
device list, its ranks in several processes: the kernel reaches the
other processes' buffers through CUDA IPC handles, the plain ring sends
between them, every process makes the same inputs from the same seed,
and process 0 prints the lines and the verdict of every process
(`_ladder.agree`).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from cuda_flashattention_torch import config
from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.parallel import mesh as mesh_mod
from cuda_flashattention_torch.parallel.device_ring import (
    device_ring_matmul,
    ring_matmul_plain,
)
from cuda_flashattention_torch.parallel.mesh import make_mesh

SHARD_ROWS, WIDTH, ITERS, GATE = 1024, 128, 20, 1e-2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the ring (default: one per visible "
                         "card, or 4 sharing a single card)")
    ap.add_argument("--width", type=int, default=WIDTH,
                    help=f"d of the shards and of W (default {WIDTH}; the "
                         f"card takes any d up to 256)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on CPU tensors (the plain version)")
    args = ap.parse_args(argv)
    args.cpu = args.cpu or config.CPU.as_bool  # the launcher's --cpu

    if _ladder.bootstrap(args.cpu):
        devices = _ladder.devices(args.ranks, args.cpu)
        n, where = len(devices), _ladder.where(devices)
    elif args.cpu:
        n = args.ranks or 4
        devices, where = ["cpu"] * n, "cpu"
    elif not torch.cuda.is_available():
        print("device_ring: needs an NVIDIA card (or --cpu for the plain "
              "version on CPU tensors)", file=sys.stderr)
        return 1
    else:
        cards = torch.cuda.device_count()
        n = args.ranks or (cards if cards > 1 else 4)
        devices = [torch.device("cuda", i % cards) for i in range(n)]
        where = (f"{cards} cards" if cards > 1
                 else f"one card shared by {n} ranks")
    say = mesh_mod.process_index() == 0
    mesh = make_mesh((n,), ("sp",), devices)
    dev = mesh.home

    width = args.width
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (n * SHARD_ROWS, width))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (width, width))
                         .astype(np.float32)).to(dev, torch.bfloat16)

    o_dev = device_ring_matmul(x, w, mesh)
    o_plain = ring_matmul_plain(x, w, mesh)
    ref = (x.float().view(n, SHARD_ROWS, width).sum(0) @ w.float()).repeat(
        n, 1)
    d_dev = (o_dev - ref).abs().max().item()
    d_plain = (o_plain - ref).abs().max().item()
    if say:
        print(f"devices={n} ({where}) d={width}  device-ring diff vs ref: "
              f"{d_dev:.2e}   plain-ring diff: {d_plain:.2e}")

    def sync():
        for d in mesh.distinct_devices():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    for name, fn in (("device", device_ring_matmul),
                     ("plain ", ring_matmul_plain)):
        fn(x, w, mesh)
        sync()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn(x, w, mesh)
        sync()
        if say:
            print(f"{name} ring: "
                  f"{(time.perf_counter() - t0) / ITERS * 1e6:.1f} us/iter")

    ok = _ladder.agree(mesh, d_dev < GATE and d_plain < GATE)
    if say:
        print("Test PASSED!" if ok else "Test FAILED!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
