"""Device mesh, per-rank streams and the rank-to-rank copy.

Counterpart of cuda_flashattention_tpu/parallel/mesh.py. The JAX package
is single-controller: one process, a `Mesh` of devices, functions that
take and return global arrays. The port is the same thing. A `Mesh` here
is an array of `torch.device` with axis names; its entries may repeat, so
that N ranks share one card (each with its own compute stream and copy
stream) exactly as the JAX tests put 8 virtual devices on one CPU. The
parallel functions (`ring_attention`, `ring_decode`, `ulysses_attention`,
`gpipe_spmd`, `device_ring_matmul`) shard their global inputs over the
ranks of a mesh axis, run each rank's part on that rank's device and
stream, and gather a global result on the input's device.

This module owns the streams and the one primitive that moves a shard
from rank a to rank b (`Mesh.send`): a `copy_` on the receiver's copy
stream, ordered by events against the producer and the consumer; across
cards it is a peer copy. Nothing here falls back to the CPU when a card
is missing: `make_mesh` without `devices` takes the visible CUDA cards
and raises when there are too few.

A multi-process backing (`torch.distributed`, one process per card or per
host) is not ported: `initialize_distributed` is a no-op for one process
and raises NotImplementedError otherwise.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Transfer:
    """A shard on its way to `rank`: `wait()` orders the rank's compute
    stream after the copy and returns the tensor."""

    def __init__(self, mesh: "Mesh", rank: int, tensor: torch.Tensor,
                 event: Optional["torch.cuda.Event"]):
        self._mesh, self._rank = mesh, rank
        self._tensor, self._event = tensor, event

    def wait(self) -> torch.Tensor:
        if self._event is not None:
            self._mesh.streams(self._rank)[0].wait_event(self._event)
        return self._tensor


class _Region:
    """One fork/join of the rank streams (see `Mesh.region`)."""

    def __init__(self):
        self._kept: List[torch.Tensor] = []

    def keep(self, *tensors) -> None:
        """Hold tensors until the join: a buffer that one rank's stream
        allocated and another stream still reads must not go back to the
        allocator before every stream of the region has been joined."""
        self._kept.extend(t for t in tensors if t is not None)


class Mesh:
    """An array of devices with named axes. `shape[axis]` is the axis
    size; a rank is the flat (row-major) index of an entry."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(
            devices, dtype=object).reshape(-1)]
        for i, d in enumerate(flat):
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.reshape(-1)[i] = d
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim} mesh dims, {len(axis_names)} "
                             f"axis names")
        self.devices = devs
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devs.shape))
        self.size = int(devs.size)
        self._streams: Dict[int, tuple] = {}

    def __repr__(self) -> str:
        names = [str(d) for d in self.distinct_devices()]
        return f"Mesh({self.shape}, devices={names})"

    def device(self, rank: int) -> torch.device:
        return self.devices.reshape(-1)[rank]

    def rank_of(self, **coords: int) -> int:
        """Flat rank of the entry at `coords` (axes left out: index 0)."""
        for name in coords:
            if name not in self.shape:
                raise ValueError(f"mesh has no axis {name!r} "
                                 f"(axes {self.axis_names})")
        idx = tuple(coords.get(name, 0) for name in self.axis_names)
        return int(np.ravel_multi_index(idx, self.devices.shape))

    def axis_ranks(self, axis: str, **coords: int) -> List[int]:
        """The ranks along `axis`, the other axes fixed at `coords`."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} "
                             f"(axes {self.axis_names})")
        return [self.rank_of(**{**coords, axis: i})
                for i in range(self.shape[axis])]

    def coords(self, rank: int) -> Dict[str, int]:
        """The entry's index on each axis."""
        return dict(zip(self.axis_names, map(
            int, np.unravel_index(rank, self.devices.shape))))

    def fibers(self, axes, ranks: Sequence[int]) -> List[List[int]]:
        """`ranks` cut into the groups that differ only on `axes` (one axis
        name or several), each in rank order: for one axis, the
        `axis_ranks` of each fixed choice of the other coordinates. Every
        group must be whole."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for name in axes:
            if name not in self.shape:
                raise ValueError(f"mesh has no axis {name!r} "
                                 f"(axes {self.axis_names})")
        groups: Dict[tuple, List[int]] = {}
        for r in sorted(set(ranks)):
            key = tuple(c for name, c in self.coords(r).items()
                        if name not in axes)
            groups.setdefault(key, []).append(r)
        size = math.prod(self.shape[name] for name in axes)
        for group in groups.values():
            if len(group) != size:
                raise ValueError(f"ranks {group} hold {len(group)} of the "
                                 f"{size} entries of their {axes} group")
        return list(groups.values())

    def distinct_devices(self) -> List[torch.device]:
        seen: List[torch.device] = []
        for d in self.devices.reshape(-1):
            if d not in seen:
                seen.append(d)
        return seen

    # -- streams -----------------------------------------------------------

    def streams(self, rank: int):
        """(compute stream, copy stream) of a rank on a card, made on
        first use; (None, None) for a CPU rank."""
        dev = self.device(rank)
        if dev.type != "cuda":
            return None, None
        if rank not in self._streams:
            self._streams[rank] = (torch.cuda.Stream(device=dev),
                                   torch.cuda.Stream(device=dev))
        return self._streams[rank]

    @contextlib.contextmanager
    def on(self, rank: int):
        """Run the body on the rank's device and compute stream."""
        compute, _ = self.streams(rank)
        if compute is None:
            yield
            return
        with torch.cuda.device(self.device(rank)), torch.cuda.stream(compute):
            yield

    @contextlib.contextmanager
    def region(self, ranks: Sequence[int], source: torch.device):
        """Fork the ranks' streams from the current stream of `source`
        (the device the global inputs live on) and join them back into it
        at the end, so that the caller sees ordinary stream semantics:
        what it queued before the region is visible to every rank, and
        what the ranks produced is visible to what it queues after."""
        reg = _Region()
        cuda = [r for r in dict.fromkeys(ranks)
                if self.device(r).type == "cuda"]
        source = torch.device(source)
        if not cuda:
            yield reg
            return
        if source.type == "cuda":
            main = torch.cuda.current_stream(source)
        else:
            main = torch.cuda.current_stream(self.device(cuda[0]))
        start = main.record_event()
        for r in cuda:
            for s in self.streams(r):
                s.wait_event(start)
        try:
            yield reg
        finally:
            for r in cuda:
                for s in self.streams(r):
                    main.wait_event(s.record_event())
            reg._kept.clear()

    def barrier(self, ranks: Sequence[int]) -> None:
        """Every rank's compute stream waits for what every other rank's
        compute stream has queued so far."""
        cuda = [r for r in dict.fromkeys(ranks)
                if self.device(r).type == "cuda"]
        events = [self.streams(r)[0].record_event() for r in cuda]
        for r in cuda:
            for e in events:
                self.streams(r)[0].wait_event(e)

    def send(self, x: torch.Tensor, src: int, dst: int) -> Transfer:
        """Copy `x`, which rank `src` holds, to rank `dst`.

        The destination is allocated on `dst`'s compute stream; the copy
        runs on `dst`'s copy stream after everything `src`'s compute
        stream has queued so far (the producer) and everything `dst`'s
        compute stream has queued so far (the consumer of whatever lived
        in that memory before). `Transfer.wait()` makes `dst`'s compute
        stream wait for the copy. Queued before a step's kernels and
        awaited after them, the copy overlaps them. On CPU ranks it is a
        plain copy."""
        dev = self.device(dst)
        if dev.type != "cuda":
            return Transfer(self, dst, x.to(dev, copy=True), None)
        src_dev = self.device(src)
        compute, copy = self.streams(dst)
        with self.on(dst):
            out = torch.empty(x.shape, dtype=x.dtype, device=dev)
        copy.wait_event(compute.record_event())
        if src_dev.type == "cuda":
            src_compute, src_copy = self.streams(src)
            copy.wait_event(src_compute.record_event())
        with contextlib.ExitStack() as stack:
            if src_dev.type == "cuda" and src_dev != dev:
                # a peer copy synchronises with the source card's current
                # stream: make that the sender's copy stream
                src_copy.wait_event(src_compute.record_event())
                stack.enter_context(torch.cuda.stream(src_copy))
            stack.enter_context(torch.cuda.stream(copy))
            out.copy_(x, non_blocking=True)
        return Transfer(self, dst, out, copy.record_event())


_DISTRIBUTED_INITIALIZED = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-process bootstrap. A no-op for a single process with no
    coordinator configured (safe to call more than once), as the JAX
    function is; the multi-process backing on `torch.distributed` is not
    ported (ROADMAP queue 1, item 6) and raises NotImplementedError."""
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return
    if coordinator_address is None and num_processes in (None, 1):
        _DISTRIBUTED_INITIALIZED = True
        return
    raise NotImplementedError(
        "multi-process meshes (torch.distributed backing, "
        "scripts/launch_multihost.py) are not ported: ROADMAP queue 1, "
        "item 6. One process drives every card it can see.")


def _visible_cards() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present: a mesh is built over the visible "
            "cards by default; pass devices=[...] to place its ranks "
            "yourself (entries may repeat, e.g. [\"cpu\"] * 4)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """Build a Mesh over the given devices, or over the visible CUDA cards.

    `devices=None` takes the visible cards and raises when there are
    fewer than the mesh needs, or none. A given list may repeat a device
    (`[torch.device("cuda", 0)] * 4`, `["cpu"] * 8`): the ranks then share
    it, each with its own streams. Axis order convention: put the
    fastest-communicating axis last."""
    devs = list(_visible_cards() if devices is None else devices)
    n = int(math.prod(axis_sizes))
    if n > len(devs):
        raise ValueError(f"mesh {tuple(axis_sizes)} needs {n} devices, "
                         f"have {len(devs)}")
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = torch.device(devs[i])
    return Mesh(arr.reshape(tuple(axis_sizes)), tuple(axis_names))


def sequence_mesh(n_devices: Optional[int] = None, axis_name: str = "sp",
                  devices=None) -> Mesh:
    """1-axis mesh for sequence (ring / context) parallelism over
    `n_devices` ranks (default: every device given or visible)."""
    devs = list(_visible_cards() if devices is None else devices)
    n = n_devices or len(devs)
    return make_mesh((n,), (axis_name,), devs)


def shard_on_axis(mesh: Mesh, x: torch.Tensor, axis: int,
                  mesh_axis: str) -> List[torch.Tensor]:
    """Shard x along `axis` over `mesh_axis`: the list of the ranks'
    contiguous shards, each on its rank's device (the other mesh axes at
    index 0). `x.shape[axis]` must divide evenly."""
    n = mesh.shape[mesh_axis]
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not divide "
                         f"over the {n} ranks of {mesh_axis!r}")
    return [piece.contiguous().to(mesh.device(rank))
            for piece, rank in zip(x.chunk(n, dim=axis),
                                   mesh.axis_ranks(mesh_axis))]
