"""Device-initiated ring: o = (Σ_shards x) @ W, every rank's shard pushed
around the ring by the kernel itself.

Counterpart of examples/07_device_ring.py (`device_ring_matmul`, kernel
`_ring_kernel`; `xla_ring_matmul` is its plain version there). Every rank
of a mesh axis holds a shard x_i [L, d] bf16 and W [d, d] bf16; the ring
rotates the shards while each rank accumulates o += shard @ W in fp32, so
that after n steps every rank holds (Σ_i x_i) @ W.

`device_ring_matmul` on CUDA tensors launches the hand-written Hopper
kernel of csrc/device_ring.cu (K9): the kernel stores the shard it holds
into its right neighbour's double buffer and orders the steps with
device-side flags. It reaches its neighbours through a table of per-rank
pointers: ranks that share a card (a mesh whose entries repeat) run in one
launch and their buffers are other allocations of that card; ranks on
different cards run in one launch per card and the buffers are peer-mapped
(peer access is checked and enabled here, else the call raises). On CPU
tensors it runs `ring_matmul_plain`: the same ring with a host-driven copy
per hop (`Mesh.send`) and one `torch.matmul` per step.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import KERNEL_HEAD_DIMS
from cuda_flashattention_torch.parallel.mesh import Mesh

KERNEL_TILE_ROWS = 64   # rows of o per CTA (csrc/device_ring.cu BM)
KERNEL_MAX_RANKS = 32   # entries of the kernel's pointer table
_FLAG_WORDS = 4         # per (rank, tile): barrier, recv, credit, unused


def _check(x: torch.Tensor, w: torch.Tensor, n: int):
    if x.ndim != 2 or w.ndim != 2 or w.shape != (x.shape[1], x.shape[1]):
        raise ValueError(f"expected x [n·L, d] and w [d, d], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] % n:
        raise ValueError(f"x rows {x.shape[0]} do not divide over the "
                         f"{n} ranks of the ring")
    return x.shape[0] // n, x.shape[1]


def ring_matmul_plain(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                      axis_name: str = "sp") -> torch.Tensor:
    """The plain version: the same ring with a copy per hop driven from
    the host (`Mesh.send`, queued before the step's product and awaited
    after it) and one fp32 `torch.matmul` per step. x [n·L, d] sharded on
    rows over `axis_name`, w [d, d] → o [n·L, d] fp32 on x's device, every
    rank's rows holding (Σ_i x_i) @ W."""
    ranks = mesh.axis_ranks(axis_name)
    n = len(ranks)
    _check(x, w, n)
    with mesh.region(ranks, x.device) as reg:
        cur, ws, acc = [], [], []
        for piece, r in zip(x.chunk(n, dim=0), ranks):
            with mesh.on(r):
                cur.append(piece.to(mesh.device(r)))
                ws.append(w.to(mesh.device(r)).float())
                acc.append(None)
        for step in range(n):
            pending = None
            if step < n - 1:
                pending = [mesh.send(cur[i], ranks[i], ranks[(i + 1) % n])
                           for i in range(n)]
            for i, r in enumerate(ranks):
                with mesh.on(r):
                    part = torch.matmul(cur[i].float(), ws[i])
                    acc[i] = part if acc[i] is None else acc[i] + part
            if pending is not None:
                reg.keep(*cur)
                cur = [pending[(i - 1) % n].wait() for i in range(n)]
        reg.keep(*cur, *acc)
    return torch.cat([a.to(x.device) for a in acc], dim=0)


def _device_ring_cuda(x, w, mesh: Mesh, axis_name: str) -> torch.Tensor:
    ranks = mesh.axis_ranks(axis_name)
    n = len(ranks)
    rows, d = _check(x, w, n)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA ring takes bf16 x and w, got {x.dtype} / {w.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA ring takes d in {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    if rows % KERNEL_TILE_ROWS:
        raise ValueError(f"the CUDA ring takes shards of a multiple of "
                         f"{KERNEL_TILE_ROWS} rows, got {rows}")
    if n > KERNEL_MAX_RANKS:
        raise ValueError(f"the CUDA ring takes at most {KERNEL_MAX_RANKS} "
                         f"ranks, got {n}")
    devs = [mesh.device(r) for r in ranks]
    for dev in devs:
        if dev.type != "cuda":
            raise ValueError(f"x is on {x.device} but the mesh holds {dev}: "
                             f"the CUDA ring needs every rank on a card")
    lib = _build.library()
    cards: Dict[torch.device, List[int]] = {}
    for i, dev in enumerate(devs):
        cards.setdefault(dev, []).append(i)
    # a kernel stores into both neighbours' allocations
    for i, dev in enumerate(devs):
        for other in (devs[(i + 1) % n], devs[(i - 1) % n]):
            if other == dev:
                continue
            if not torch.cuda.can_device_access_peer(dev.index, other.index):
                raise RuntimeError(
                    f"{dev} cannot access {other} as a peer: the device "
                    f"ring needs peer access between neighbouring cards")
            _build.check(lib.cfa_enable_peer_access(dev.index, other.index),
                         f"peer access {dev} -> {other}")

    x = x.contiguous()
    out = torch.empty((n * rows, d), dtype=torch.float32, device=x.device)
    main = torch.cuda.current_stream(x.device)
    ready = main.record_event()
    tiles = rows // KERNEL_TILE_ROWS
    shard_bytes = rows * d * x.element_size()
    # per-rank device addresses of the shard, W, the double buffer, the
    # flag words and the output; one allocation of each kind per card
    ptrs = {kind: [0] * n for kind in ("x", "w", "buf", "flags", "out")}
    keep, set_up = [], []
    for dev, idxs in cards.items():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ready)
            local = dev == x.device
            w_dev = w.contiguous().to(dev)
            x_dev = x if local else torch.cat(
                [x[i * rows:(i + 1) * rows] for i in idxs]).to(dev)
            out_dev = out if local else torch.empty(
                (len(idxs) * rows, d), dtype=torch.float32, device=dev)
            bufs = torch.empty((len(idxs), 2, rows, d), dtype=torch.bfloat16,
                               device=dev)
            # flags and counters: zero at launch, unique per call
            flags = torch.zeros((len(idxs), tiles, _FLAG_WORDS),
                                dtype=torch.int32, device=dev)
            keep.append((w_dev, x_dev, out_dev, bufs, flags))
            for j, i in enumerate(idxs):
                at = i if local else j  # the shard's place on this card
                ptrs["x"][i] = x_dev.data_ptr() + at * shard_bytes
                ptrs["out"][i] = out_dev.data_ptr() + at * 2 * shard_bytes
                ptrs["w"][i] = w_dev.data_ptr()
                ptrs["buf"][i] = bufs.data_ptr() + j * 2 * shard_bytes
                ptrs["flags"][i] = (flags.data_ptr()
                                    + j * tiles * _FLAG_WORDS * 4)
            set_up.append(stream.record_event())
    tables = [(ctypes.c_void_p * n)(*ptrs[kind])
              for kind in ("x", "w", "buf", "flags", "out")]
    done = []
    for dev, idxs in cards.items():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            for e in set_up:  # every card's flags are zero before any push
                stream.wait_event(e)
            grid = ctypes.c_int(0)
            err = lib.cfa_device_ring(
                *tables, n, (ctypes.c_int * len(idxs))(*idxs), len(idxs),
                rows, d, dev.index, ctypes.byref(grid), stream.cuda_stream)
            _build.check(err, "device_ring_matmul kernel launch")
            device_ring_matmul.launches += 1
            device_ring_matmul.last_grid = (grid.value, len(idxs))
            done.append(stream.record_event())
    for e in done:
        main.wait_event(e)
    for (_, _, out_dev, _, _), (dev, idxs) in zip(keep, cards.items()):
        if dev != x.device:
            for j, i in enumerate(idxs):
                out[i * rows:(i + 1) * rows].copy_(
                    out_dev[j * rows:(j + 1) * rows])
            # the peer copy reads out_dev on x's stream: its block must not
            # go back to the other card's stream before the copy has run
            out_dev.record_stream(main)
    # the other per-call buffers go back to the allocator of the stream
    # that made them, which is the stream the kernel ran on
    return out


def device_ring_matmul(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                       axis_name: str = "sp") -> torch.Tensor:
    """o = (Σ_shards x) @ w through the in-kernel ring: x [n·L, d] sharded
    on rows over `axis_name`, w [d, d] → o [n·L, d] fp32 on x's device,
    every rank's L rows holding the same (Σ_i x_i) @ W.

    On the card the kernel takes bf16 x and w, d in {64, 128}, L a
    multiple of 64 and at most 32 ranks, every one on a card; ranks on
    different cards need peer access. It raises otherwise: a CUDA tensor
    never takes the plain version. `device_ring_matmul.launches` counts
    the kernel's launches (one per card), `.last_grid` is the last
    launch's (CTAs per rank, ranks)."""
    if x.device != w.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ring_matmul_plain(x, w, mesh, axis_name)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _device_ring_cuda(x, w, mesh, axis_name)


device_ring_matmul.launches = 0
device_ring_matmul.last_grid = (0, 0)
