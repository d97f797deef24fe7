"""Device mesh, per-rank streams and the rank-to-rank copy, in one
process or over several.

Counterpart of cuda_flashattention_tpu/parallel/mesh.py. The JAX package
is single-controller: a `Mesh` of devices and functions that take and
return global arrays, and under `jax.distributed` the same program runs in
every process over one global device list. The port is the same thing. A
`Mesh` here is an array of devices with axis names; a rank is an entry,
and each entry is a device of this process or a `Place` (a process and its
device) of the global list that `initialize_distributed` builds. Entries
may repeat, so that N ranks share one card (each with its own compute
stream and copy stream) exactly as the JAX tests put 8 virtual devices on
one CPU. The parallel functions (`ring_attention`, `ring_decode`,
`ulysses_attention`, `gpipe_spmd`, the collectives, the sharded model)
run the ranks of this process (`Mesh.is_local`) and walk every rank's
part of their host loops in the same order in every process, so that the
transfers between processes pair up.

This module owns the streams and the one primitive that moves a shard
from rank a to rank b (`Mesh.send`). Between ranks of one process it is a
`copy_` on the receiver's copy stream, ordered by events against the
producer and the consumer; across cards it is a peer copy. Between
processes it is a point-to-point pair: the sender's process posts the
send, the receiver's posts the receive into a buffer it allocates from the
shape and dtype its caller gives (`like`), and a process that owns neither
side does nothing. The transport is chosen once, from the device
identities the processes exchange at `initialize_distributed`
(`TRANSPORT`):
  - "nccl": every process has a card of its own; NCCL send / recv on the
    copy streams.
  - "staged": processes share a card (NCCL refuses two ranks on one card):
    device to a pinned host buffer on the sender's copy stream, gloo
    isend / irecv (which takes no CUDA tensors), host to device on the
    receiver's copy stream. The sender's host waits for its copy before
    the send is posted.
  - "gloo": every process runs on the CPU; gloo isend / irecv.
Nothing falls back: a failed NCCL group raises, a peer that does not
answer raises within the group's timeout, and `make_mesh` without
`devices` takes the visible cards (or the global list) and raises when
there are too few.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import datetime
import json
import math
import os
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cuda_flashattention_torch import config


@dataclasses.dataclass(frozen=True)
class Place:
    """An entry of the global device list: a process and its device (as
    that process names it)."""
    process: int
    device: torch.device


class Transfer:
    """A shard on its way to `rank`: `wait()` finishes the receive where
    it comes from another process, orders the rank's compute stream after
    the copy and returns the tensor."""

    def __init__(self, mesh: "Mesh", rank: int, tensor: torch.Tensor,
                 event: Optional["torch.cuda.Event"],
                 finish: Optional[Callable[[], object]] = None):
        self._mesh, self._rank = mesh, rank
        self._tensor, self._event, self._finish = tensor, event, finish

    def wait(self) -> torch.Tensor:
        if self._finish is not None:
            self._event, self._finish = self._finish(), None
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


# ---------------------------------------------------------------------------
# The process group
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _World:
    """This process's view of the group: its index, its device, the
    global device list and the transport."""
    process: int
    nproc: int
    device: torch.device
    places: List[Place]
    transport: str
    nccl: object = None           # the NCCL group under "nccl"
    seq: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict)     # messages posted per (from, to) process
    sends: list = dataclasses.field(default_factory=list)  # not yet waited


_DISTRIBUTED_INITIALIZED = False
_WORLD: Optional[_World] = None
# the transport between processes once a group of several is up: "nccl",
# "staged" or "gloo" (module docstring); None in one process
TRANSPORT: Optional[str] = None
_TAG_LIMIT = 2 ** 31 - 1
# seconds a process of a group waits for a peer (its joining, a receive)
# before it raises: `initialize_distributed`'s default
DIST_TIMEOUT_S = 300.0
# what this process has moved to other processes: the bytes posted, and
# the host seconds spent waiting on transfers (the staged sends'
# device-to-host copies, the receives, the sends' completion)
transfer_stats = {"bytes": 0, "wait_s": 0.0}
# what `shutdown_distributed` runs before it leaves the group
_SHUTDOWN_HOOKS: List[Callable[[], None]] = []


def _waited(fn):
    """fn(), its host time added to `transfer_stats["wait_s"]`."""
    t0 = time.perf_counter()
    try:
        return fn()
    finally:
        transfer_stats["wait_s"] += time.perf_counter() - t0


def process_index() -> int:
    """This process's index in the group (0 without one)."""
    return _WORLD.process if _WORLD is not None else 0


def process_count() -> int:
    return _WORLD.nproc if _WORLD is not None else 1


def identity(device: torch.device) -> str:
    """What tells one device from another across processes: the card's
    UUID on its host, or the process itself on the CPU."""
    host = socket.gethostname()
    if device.type == "cpu":
        return f"{host}/cpu/{os.getpid()}"
    return f"{host}/{torch.cuda.get_device_properties(device).uuid}"


def choose_transport(identities: Sequence[str]) -> str:
    """The transport for processes whose devices have these identities
    (`identity`): "gloo" when every one is a CPU, "nccl" when each is a
    card of its own, "staged" when some processes share a card. A group
    that mixes CPUs and cards is refused."""
    cpu = ["/cpu/" in i for i in identities]
    if all(cpu):
        return "gloo"
    if any(cpu):
        raise ValueError("the processes mix CPUs and cards: run every "
                         "process on a card, or every one on the CPU")
    return "nccl" if len(set(identities)) == len(identities) else "staged"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           local_ranks: Optional[int] = None,
                           cpu: Optional[bool] = None,
                           timeout_s: float = DIST_TIMEOUT_S) -> None:
    """Multi-process bootstrap (the `init_mpi_nccl` equivalent). A no-op
    for a single process with no coordinator (safe to call more than once,
    as the JAX function is).

    With a coordinator ("host:port"), `num_processes` and `process_id`, it
    joins a `torch.distributed` group over `tcp://<coordinator>` whose
    peers must answer within `timeout_s` seconds, or the call that waits
    on them raises. The process takes card
    `process_id % torch.cuda.device_count()`, or the CPU when `cpu` is
    set (default $CFA_CPU); without a card and without `cpu` it raises.
    It puts `local_ranks` mesh ranks on that device (default
    $CFA_LOCAL_RANKS), publishes the device's identity in the group's
    store, reads every peer's, and builds the global device list
    (`global_devices`) and the transport (`TRANSPORT`) from them. An NCCL
    group is tried at once with one all-reduce, so that a failed one
    raises here."""
    global _DISTRIBUTED_INITIALIZED, _WORLD, TRANSPORT
    if _DISTRIBUTED_INITIALIZED:
        return
    if coordinator_address is None and num_processes in (None, 1):
        _DISTRIBUTED_INITIALIZED = True
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("a multi-process group needs coordinator_address, "
                         "num_processes and process_id")
    import torch.distributed as dist

    local_ranks = int(local_ranks or config.LOCAL_RANKS.as_int)
    cpu = config.CPU.as_bool if cpu is None else bool(cpu)
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present: a process of the group takes a "
            "card; pass cpu=True (the ladder's --cpu) to run it on the CPU")
    else:
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                    process_id):
        raise ValueError(f"the group already up is process "
                         f"{dist.get_rank()} of {dist.get_world_size()}")
    st = store()
    st.set(f"cfa/place/{process_id}", json.dumps(dict(
        identity=identity(device), type=device.type, index=device.index,
        ranks=local_ranks)))
    places, identities = [], []
    for p in range(num_processes):
        info = json.loads(st.get(f"cfa/place/{p}"))
        identities.append(info["identity"])
        places += [Place(p, torch.device(info["type"], info["index"]))
                   ] * info["ranks"]
    transport = choose_transport(identities)
    world = _World(process_id, num_processes, device, places, transport)
    if transport == "nccl":
        world.nccl = dist.new_group(backend="nccl")
        probe = torch.ones(1, device=device)
        dist.all_reduce(probe, group=world.nccl)
        torch.cuda.synchronize(device)
        if probe.item() != num_processes:
            raise RuntimeError(f"the NCCL group's first all-reduce gave "
                               f"{probe.item()}, not {num_processes}")
    _WORLD, TRANSPORT = world, transport
    _DISTRIBUTED_INITIALIZED = True
    atexit.register(shutdown_distributed)


def shutdown_distributed() -> None:
    """Wait for the sends still in flight, run what `at_shutdown`
    registered (in order) and leave the group together (`_leave`: the
    store's host, process 0, leaves last)."""
    global _DISTRIBUTED_INITIALIZED, _WORLD, TRANSPORT
    if _WORLD is None:
        return
    import torch.distributed as dist
    world = _WORLD
    try:
        _settle()
        while _SHUTDOWN_HOOKS:
            _SHUTDOWN_HOOKS.pop(0)()
    finally:
        _WORLD, TRANSPORT = None, None
        _DISTRIBUTED_INITIALIZED = False
        if dist.is_initialized():
            try:
                _leave(world)
            finally:
                dist.destroy_process_group()


_LEFT_KEY = "cfa/shutdown/left"


def _leave(world: "_World") -> None:
    """Process 0 hosts the group's store and takes it down when it
    destroys the group, so it must not leave while another process still
    needs the store: a process that comes to its shutdown later (its
    hooks' closing barriers, a last `store_barrier`) would then wait on a
    store that is gone, until its timeout. So every other process, once
    its hooks are done, counts itself out through the store (the last one
    out says so), and process 0 waits for that before it leaves."""
    if world.nproc < 2:
        return
    st = store()
    if world.process != 0:
        if st.add(_LEFT_KEY, 1) == world.nproc - 1:
            st.set(f"{_LEFT_KEY}/all", b"1")
    else:
        st.wait([f"{_LEFT_KEY}/all"])


def at_shutdown(fn: Callable[[], None]) -> None:
    """Run fn() in `shutdown_distributed`, while the group is still up (a
    release that the processes make together)."""
    if fn not in _SHUTDOWN_HOOKS:
        _SHUTDOWN_HOOKS.append(fn)


def store():
    """The group's key-value store (the one `initialize_distributed`
    exchanges the devices through)."""
    import torch.distributed as dist
    return dist.distributed_c10d._get_default_store()


def store_barrier(name: str, procs: Sequence[int],
                  prev: Optional[str] = None) -> None:
    """Wait until every process of `procs` has reached the barrier `name`
    (a name used once), through the group's store, within the group's
    timeout. `prev`: the name of these processes' previous barrier, whose
    keys the last to arrive deletes (everyone has left it)."""
    st = store()
    key = f"cfa/barrier/{name}"
    if st.add(key, 1) == len(procs):
        st.set(f"{key}/go", b"1")
        if prev is not None:
            for k in (f"cfa/barrier/{prev}", f"cfa/barrier/{prev}/go"):
                st.delete_key(k)
    else:
        st.wait([f"{key}/go"])


def global_devices() -> list:
    """Every rank's device: the `Place`s of every process (`local_ranks`
    entries each, in process order) in a group of several, else the
    visible cards. Raises without a card outside a group."""
    if _WORLD is not None:
        return list(_WORLD.places)
    return _visible_cards()


def _visible_cards() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present: a mesh is built over the visible "
            "cards by default; pass devices=[...] to place its ranks "
            "yourself (entries may repeat, e.g. [\"cpu\"] * 4)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


# -- the transport between processes -----------------------------------------

def _tag(src: int, dst: int) -> int:
    """The next message's tag from process src to process dst. Both sides
    count the messages of the pair, so a process that skipped one makes
    the next receive wait and time out instead of taking the wrong data."""
    n = _WORLD.seq.get((src, dst), 0)
    _WORLD.seq[(src, dst)] = n + 1
    return n % _TAG_LIMIT


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _stage(x: torch.Tensor, stream=None) -> torch.Tensor:
    """The bytes of `x` to post: under the staged transport a pinned host
    copy, made on `stream` (current, x ready on it) and waited for, since
    gloo reads the host buffer; else x's own."""
    data = _as_bytes(x)
    if _WORLD.transport == "nccl" or not data.is_cuda:
        return data
    host = torch.empty(data.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(data, non_blocking=True)
    _waited(stream.record_event().synchronize)
    return host


def _post(data: torch.Tensor, proc: int) -> None:
    """Post bytes from `_stage` to process `proc`."""
    import torch.distributed as dist
    w = _WORLD
    tag = _tag(w.process, proc)
    transfer_stats["bytes"] += data.numel()
    if w.transport == "nccl":
        work = dist.isend(data, proc, group=w.nccl)
    else:
        work = dist.isend(data, proc, tag=tag)
    w.sends.append(work)


def _post_send(x: torch.Tensor, proc: int, stream=None) -> None:
    """Post `x` to process `proc`. On a card, `stream` is current and x is
    ready on it."""
    if x.numel() > 0:
        _post(_stage(x, stream), proc)


def _post_recv(out: torch.Tensor, proc: int, stream=None) -> Callable:
    """Post a receive from process `proc` into the contiguous `out`;
    returns finish(), which completes it (on a card: queued on `stream`,
    current here and in finish)."""
    import torch.distributed as dist
    w = _WORLD
    if out.numel() == 0:
        return lambda: None
    tag, data = _tag(proc, w.process), _as_bytes(out)
    if w.transport == "nccl":
        work = dist.irecv(data, proc, group=w.nccl)
        work.wait()  # the stream waits for NCCL's
        return lambda: None
    if not data.is_cuda:
        work = dist.irecv(data, proc, tag=tag)
        return lambda: _waited(work.wait)
    host = torch.empty(data.shape, dtype=torch.uint8, pin_memory=True)
    work = dist.irecv(host, proc, tag=tag)  # staged

    def finish():
        _waited(work.wait)
        with torch.cuda.device(out.device), torch.cuda.stream(stream):
            data.copy_(host, non_blocking=True)
    return finish


def _settle() -> None:
    """Wait for every send this process has posted."""
    if _WORLD is None:
        return
    sends, _WORLD.sends = _WORLD.sends, []
    for work in sends:
        _waited(work.wait)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

class Mesh:
    """An array of devices with named axes. `shape[axis]` is the axis
    size; a rank is the flat (row-major) index of an entry. An entry is a
    device of this process or a `Place` of the global device list."""

    def __init__(self, devices, axis_names: Sequence[str]):
        entries = np.asarray(devices, dtype=object)
        devs = np.empty(entries.shape, dtype=object)
        procs = np.empty(entries.shape, dtype=np.int64)
        me = process_index()
        for idx, d in np.ndenumerate(entries):
            proc, d = ((d.process, torch.device(d.device))
                       if isinstance(d, Place) else (me, torch.device(d)))
            if proc == me and d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs[idx], procs[idx] = d, proc
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim} mesh dims, {len(axis_names)} "
                             f"axis names")
        self.devices = devs
        self.processes = procs
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devs.shape))
        self.size = int(devs.size)
        self._me = me
        self._streams: Dict[int, tuple] = {}

    def __repr__(self) -> str:
        names = [str(d) for d in self.distinct_devices()]
        procs = sorted(set(self.processes.reshape(-1).tolist()))
        over = f", processes={procs}" if len(procs) > 1 else ""
        return f"Mesh({self.shape}, devices={names}{over})"

    def device(self, rank: int) -> torch.device:
        """The rank's device, as the rank's own process names it."""
        return self.devices.reshape(-1)[rank]

    def process(self, rank: int) -> int:
        return int(self.processes.reshape(-1)[rank])

    def place(self, rank: int) -> Place:
        return Place(self.process(rank), self.device(rank))

    def is_local(self, rank: int) -> bool:
        """Whether this process runs the rank."""
        return self.process(rank) == self._me

    def local(self, ranks: Sequence[int]) -> List[int]:
        """The ranks of `ranks` that this process runs, in order."""
        return [r for r in ranks if self.is_local(r)]

    @property
    def spans_processes(self) -> bool:
        return bool((self.processes != self._me).any())

    @property
    def home(self) -> torch.device:
        """This process's device in the mesh (its first local rank's):
        where the global inputs and results of the parallel functions
        live."""
        for r in range(self.size):
            if self.is_local(r):
                return self.device(r)
        raise ValueError(f"process {self._me} holds no rank of {self}")

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
        group must be whole; on a mesh that spans processes the other
        processes' ranks of a group are added to it (a process names only
        the ranks it runs), so that every process sees the same groups."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for name in axes:
            if name not in self.shape:
                raise ValueError(f"mesh has no axis {name!r} "
                                 f"(axes {self.axis_names})")

        def key(r):
            return tuple(c for name, c in self.coords(r).items()
                         if name not in axes)

        given = set(ranks)
        groups: Dict[tuple, List[int]] = {}
        for r in sorted(given):
            groups.setdefault(key(r), [])
        size = math.prod(self.shape[name] for name in axes)
        for r in range(self.size):
            if key(r) in groups and (r in given or not self.is_local(r)):
                groups[key(r)].append(r)
        for group in groups.values():
            if len(group) != size:
                raise ValueError(f"ranks {group} hold {len(group)} of the "
                                 f"{size} entries of their {axes} group")
        return list(groups.values())

    def distinct_devices(self) -> List[torch.device]:
        """The devices of this process's ranks, each once."""
        seen: List[torch.device] = []
        for r in range(self.size):
            if self.is_local(r) and self.device(r) not in seen:
                seen.append(self.device(r))
        return seen

    # -- streams -----------------------------------------------------------

    def streams(self, rank: int):
        """(compute stream, copy stream) of a rank on a card, made on
        first use; (None, None) for a CPU rank."""
        if not self.is_local(rank):
            raise ValueError(f"rank {rank} runs in process "
                             f"{self.process(rank)}, not in {self._me}")
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
        """Fork the local ranks' streams from the current stream of
        `source` (a device of this process: the one the global inputs live
        on) and join them back into it at the end, so that the caller sees
        ordinary stream semantics: what it queued before the region is
        visible to every rank, and what the ranks produced is visible to
        what it queues after. The sends to other processes posted in the
        region are complete when it ends."""
        reg = _Region()
        cuda = [r for r in dict.fromkeys(ranks)
                if self.is_local(r) and self.device(r).type == "cuda"]
        source = torch.device(source)
        if not cuda:
            try:
                yield reg
            finally:
                _settle()
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
            _settle()
            reg._kept.clear()

    def barrier(self, ranks: Sequence[int]) -> None:
        """Every local rank's compute stream waits for what every other
        local rank's compute stream has queued so far."""
        cuda = [r for r in dict.fromkeys(ranks)
                if self.is_local(r) and self.device(r).type == "cuda"]
        events = [self.streams(r)[0].record_event() for r in cuda]
        for r in cuda:
            for e in events:
                self.streams(r)[0].wait_event(e)

    def send(self, x: Optional[torch.Tensor], src: int, dst: int,
             like=None) -> Optional[Transfer]:
        """Copy `x`, which rank `src` holds, to rank `dst`: a `Transfer`
        in `dst`'s process, None elsewhere.

        The destination is allocated on `dst`'s compute stream; the copy
        runs on `dst`'s copy stream after everything `src`'s compute
        stream has queued so far (the producer) and everything `dst`'s
        compute stream has queued so far (the consumer of whatever lived
        in that memory before). `Transfer.wait()` makes `dst`'s compute
        stream wait for the copy. Queued before a step's kernels and
        awaited after them, the copy overlaps them. On CPU ranks it is a
        plain copy.

        Between processes the sender's process posts the send (after its
        compute stream's work, on its copy stream) and the receiver's
        process posts the receive into a buffer shaped as `like` (a
        tensor, or a (shape, dtype) pair; x is None there). Every process
        must make the same calls in the same order."""
        src_here, dst_here = self.is_local(src), self.is_local(dst)
        if src_here and dst_here:
            return self._send_local(x, src, dst)
        if src_here:
            with self._after(src) as stream:
                _post_send(x, self.process(dst), stream)
            return None
        if not dst_here:
            return None
        shape, dtype = ((like.shape, like.dtype)
                        if isinstance(like, torch.Tensor) else like)
        dev = self.device(dst)
        with self.on(dst):
            out = torch.empty(shape, dtype=dtype, device=dev)
        with self._after(dst) as stream:
            finish = _post_recv(out, self.process(src), stream)

        def done():
            finish()
            return None if stream is None else stream.record_event()
        return Transfer(self, dst, out, None, done)

    @contextlib.contextmanager
    def _after(self, rank: int):
        """The rank's copy stream, made current after what its compute
        stream has queued so far (None on a CPU rank)."""
        compute, copy = self.streams(rank)
        if compute is None:
            yield None
            return
        copy.wait_event(compute.record_event())
        with torch.cuda.device(self.device(rank)), torch.cuda.stream(copy):
            yield copy

    def _send_local(self, x, src, dst) -> Transfer:
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

    def share(self, x: Optional[torch.Tensor], rank: int,
              like) -> torch.Tensor:
        """Rank `rank`'s tensor in every process of the mesh: `x` itself in
        the rank's process (which posts it to the others), elsewhere a
        copy received into a tensor shaped as `like` on the device and
        current stream where `like` lives. On the rank's process the
        result is `x`, so gradients reach it; elsewhere it is a constant.
        Every process of the mesh must call it, in the same order."""
        procs = sorted(set(self.processes.reshape(-1).tolist()))
        if self.is_local(rank):
            others = [p for p in procs if p != self._me]
            if others and x.numel() > 0:
                with torch.cuda.device(x.device) if x.is_cuda \
                        else contextlib.nullcontext():
                    stream = (torch.cuda.current_stream(x.device)
                              if x.is_cuda else None)
                    data = _stage(x, stream)  # once for every peer
                    for p in others:
                        _post(data, p)
            _settle()
            return x
        if self._me not in procs:
            raise ValueError(f"process {self._me} holds no rank of {self}")
        out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        stream = torch.cuda.current_stream(out.device) if out.is_cuda \
            else None
        with torch.cuda.device(out.device) if out.is_cuda \
                else contextlib.nullcontext():
            _post_recv(out, self.process(rank), stream)()
        return out


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """Build a Mesh over the given devices, or over `global_devices()`.

    `devices=None` takes the global device list in a multi-process group,
    else the visible cards, and raises when there are fewer than the mesh
    needs, or none. A given list may repeat a device
    (`[torch.device("cuda", 0)] * 4`, `["cpu"] * 8`): the ranks then share
    it, each with its own streams; its entries may be `Place`s of the
    global list. Axis order convention: put the fastest-communicating axis
    last."""
    devs = list(global_devices() if devices is None else devices)
    n = int(math.prod(axis_sizes))
    if n > len(devs):
        raise ValueError(f"mesh {tuple(axis_sizes)} needs {n} devices, "
                         f"have {len(devs)}")
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = devs[i] if isinstance(devs[i], Place) else \
            torch.device(devs[i])
    return Mesh(arr.reshape(tuple(axis_sizes)), tuple(axis_names))


def sequence_mesh(n_devices: Optional[int] = None, axis_name: str = "sp",
                  devices=None) -> Mesh:
    """1-axis mesh for sequence (ring / context) parallelism over
    `n_devices` ranks (default: every device given, or of the global
    list)."""
    devs = list(global_devices() if devices is None else devices)
    n = n_devices or len(devs)
    return make_mesh((n,), (axis_name,), devs)


def shard_on_axis(mesh: Mesh, x: torch.Tensor, axis: int,
                  mesh_axis: str) -> List[Optional[torch.Tensor]]:
    """Shard x along `axis` over `mesh_axis`: the list of the ranks'
    contiguous shards, each on its rank's device (the other mesh axes at
    index 0); None for a rank of another process. `x.shape[axis]` must
    divide evenly."""
    n = mesh.shape[mesh_axis]
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not divide "
                         f"over the {n} ranks of {mesh_axis!r}")
    return [piece.contiguous().to(mesh.device(rank))
            if mesh.is_local(rank) else None
            for piece, rank in zip(x.chunk(n, dim=axis),
                                   mesh.axis_ranks(mesh_axis))]
