"""Device-initiated ring: o = (Σ_shards x) @ W, every rank's shard pushed
around the ring by the kernel itself.

Counterpart of examples/07_device_ring.py (`device_ring_matmul`, kernel
`_ring_kernel`; `xla_ring_matmul` is its plain version there). Every rank
of a mesh axis holds a shard x_i [L, d] and W [d, d], both bf16 or both
fp32; the ring rotates the shards while each rank accumulates o += shard
@ W in fp32, so that after n steps every rank holds (Σ_i x_i) @ W.

`device_ring_matmul` on CUDA tensors launches the hand-written Hopper
kernel of csrc/device_ring.cu (K9): the kernel copies the tiles it holds
into its right neighbour's double buffer and orders the steps with
device-side flags. It reaches its neighbours through a table of per-rank
pointers: ranks that share a card (a mesh whose entries repeat) run in one
launch and their buffers are other allocations of that card; ranks on
different cards run in one launch per card and the buffers are peer-mapped
(peer access is checked and enabled once, else the call raises). On CPU
tensors it runs `ring_matmul_plain`: the same ring with a host-driven copy
per hop (`Mesh.send`) and one `torch.matmul` per step.

The kernel's protocol, stated here in plain Python and used by the wrapper
(tests/test_torch_ring_plan.py simulates it on the CPU):
  - `common_grid`: one count of CTAs per rank for the whole ring, the least
    that every card holds at once for its ranks; `span_partition` cuts a
    rank's 64-row tiles into one span per CTA, the same on every rank, so
    CTA c talks only to CTA c of its neighbours; a span is walked in rounds
    of `KERNEL_GROUP_TILES[d]` tiles, each round the whole n-step ring.
    At d = 256 in fp32 each span is two CTAs, one per column half of W
    and o (`column_parts`), two rings that share nothing: each has its
    own half of the double buffers and its own flag words.
  - `flag_value`: the 64-bit flag words hold (epoch << 32) | count, count =
    round · n + step. A call's epoch is its number on the workspace (from
    1), so the words are zeroed once, when the workspace is made, and a
    later call's targets exceed every value of an earlier one.
  - The workspace (`_workspace`) is kept per (the ring's devices, rows, d,
    every card's current stream): the double buffers, the flag words, the
    pointer tables, the common grid and the scope, and the knowledge that
    peer access is on. Calls on one stream run in order; calls on two
    streams use two workspaces, so two calls in flight never share one.
    A call holds its workspace's lock from drawing its epoch to its last
    launch, so that host threads sharing a stream enqueue their calls in
    the order of their epochs.
  - Scope: the `.gpu` build when every rank is on one card, `.sys` when
    some neighbour is on another card or in another process.

Across processes (a mesh that spans them) each process launches its own
ranks, all on its one card, and the ring's workspace is shared: each
process allocates its ranks' double buffers and flag words in one
allocation of its own (`cfa_ipc_alloc`, outside the caching allocator),
publishes its IPC handle and its card's share of CTAs in the group's
store, and opens the others' handles (`_XpWorkspace`; `xp_sources`,
`xp_layout` and `xp_grid` are its plan). A process cannot open its own
handle: its own ranks take its own pointers. The processes agree on one
grid (the least that every card holds for all the ranks on it, of every
process) and draw the same epoch per call: before each launch a process
waits for its stream and for the ring's other processes (`store_barrier`,
named by the epoch), so that no kernel spins while a neighbour's is still
queued behind other work or its host is late, and a process whose calls
do not pair with the others' waits there and raises at the group's
timeout instead of reading another call's data. Such a workspace is freed
together, at `shutdown_distributed` (every importer closes its mapping
before the owner frees). Processes that share a card do not run their
kernels at once without MPS: the card switches between their contexts,
and the ring moves forward as it does; its times are the card's
time-slicing, not the kernel's. The output's rows of the other
processes' ranks come from their processes (`Mesh.share`), so every
process returns the whole o.
"""

from __future__ import annotations

import collections
import ctypes
import json
import threading
import time
import weakref
from typing import Dict, List, Sequence, Tuple

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import RING_HEAD_DIMS, run_dim
from cuda_flashattention_torch.parallel import mesh as mesh_mod
from cuda_flashattention_torch.parallel.mesh import Mesh

KERNEL_TILE_ROWS = 64   # rows of a tile (csrc/device_ring.cu BM)
KERNEL_MAX_RANKS = 32   # entries of the kernel's pointer table
# tiles whose o a CTA keeps in registers per round (csrc Geo<D, F32>::G):
# the fp32 build holds W and each tile as bf16 hi and lo images, twice the
# shared memory, so at d = 128 a round is one tile; at d = 256 a tile's o
# alone is 128 registers a thread
KERNEL_GROUP_TILES = {64: 4, 128: 2, 256: 1}
KERNEL_GROUP_TILES_F32 = {64: 4, 128: 1, 256: 1}
FLAG_WORDS = 4          # per (rank, CTA): recv, credit, start, unused
EPOCH_LIMIT = 1 << 32   # epochs are 1 .. EPOCH_LIMIT - 1 on one workspace
MAX_WORKSPACES = 16     # kept at once, least recently used dropped first
XP_ALIGN = 1024         # bytes: each block of a cross-process allocation
IPC_HANDLE_BYTES = 64   # cudaIpcMemHandle_t


def span_partition(tiles: int, grid: int) -> List[Tuple[int, int]]:
    """(first tile, tile count) of each of a rank's `grid` CTAs, as the
    kernel cuts them: consecutive spans, the first `tiles % grid` one tile
    longer. Every rank of the ring takes the same partition."""
    if not 1 <= grid <= tiles:
        raise ValueError(f"grid {grid} for {tiles} tiles")
    per, extra = divmod(tiles, grid)
    return [(c * per + min(c, extra), per + (1 if c < extra else 0))
            for c in range(grid)]


def column_parts(d: int, f32: bool = False) -> int:
    """CTAs of one span (csrc Geo<D, F32>::NH): 2 at d = 256 in fp32, where
    a CTA holds half of W's columns (the whole of W split takes 256 KB),
    else 1."""
    return 2 if f32 and d == 256 else 1


def rounds_of(count: int, d: int, f32: bool = False) -> int:
    """Rounds in which a CTA walks a span of `count` tiles (`f32`: in the
    fp32 build)."""
    group = (KERNEL_GROUP_TILES_F32 if f32 else KERNEL_GROUP_TILES)[d]
    return -(-count // group)


def common_grid(resident: Dict[object, int], ranks_on: Dict[object, int],
                tiles: int) -> int:
    """CTAs per rank for the whole ring: the least, over its cards, of the
    CTAs a card holds at once (`resident`) over the ranks it runs
    (`ranks_on`), at most one per tile. Every launch of the ring takes it,
    so that every rank cuts its tiles the same way."""
    grid = min(min(resident[c] // ranks_on[c] for c in ranks_on), tiles)
    if grid < 1:
        raise RuntimeError(
            f"the device ring needs every rank's CTAs resident at once: "
            f"{dict(ranks_on)} ranks per card against {dict(resident)} "
            f"resident CTAs")
    return grid


def flag_value(epoch: int, count: int) -> int:
    """A flag word's value for the `count`-th signal (round · n + step) of
    call `epoch` on a workspace."""
    if not (1 <= epoch < EPOCH_LIMIT and 0 <= count < 1 << 31):
        raise ValueError(f"epoch {epoch}, count {count}")
    return (epoch << 32) | count


def xp_sources(procs: Sequence[int], me: int) -> List[tuple]:
    """Where each rank of a ring whose ranks run in processes `procs` (in
    ring order) finds its double buffers and flags, seen from process
    `me`: ("local", j) for this process's j-th rank of the ring (its own
    allocation), ("mapped", p, j) for process p's j-th (p's allocation,
    opened by its IPC handle)."""
    seen: Dict[int, int] = {}
    out = []
    for p in procs:
        j = seen.get(p, 0)
        seen[p] = j + 1
        out.append(("local", j) if p == me else ("mapped", p, j))
    return out


def xp_layout(rows: int, d: int, f32: bool, grid: int,
              n_local: int) -> Tuple[List[Tuple[int, int]], int]:
    """A process's allocation for its `n_local` ranks of a cross-process
    ring: per rank (byte offset of its double buffers, of its flag words),
    each block aligned to `XP_ALIGN`, and the allocation's bytes. The
    offsets of a process's j-th rank depend on j alone, so every process
    finds them in another's allocation."""
    def up(nbytes: int) -> int:
        return -(-nbytes // XP_ALIGN) * XP_ALIGN

    parts = column_parts(d, f32)
    buf = up(parts * 2 * (1 + int(f32)) * rows * d * 2)  # bf16 images
    flags = up(parts * grid * FLAG_WORDS * 8)
    return ([(j * (buf + flags), j * (buf + flags) + buf)
             for j in range(n_local)], n_local * (buf + flags))


def xp_grid(infos: Dict[int, dict], tiles: int) -> int:
    """The grid every process of a cross-process ring launches: from each
    process's {"card": its card's identity, "resident": the spans that
    card holds at once, "ranks": its ranks of the ring}, the least share
    of a card over ALL the ranks on it (processes on one card count
    together, so their kernels fit at once where the card runs them
    together), at most one span per tile (`common_grid`)."""
    resident, ranks_on = {}, collections.Counter()
    for info in infos.values():
        resident[info["card"]] = info["resident"]
        ranks_on[info["card"]] += info["ranks"]
    return common_grid(resident, ranks_on, tiles)


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
    rank's rows holding (Σ_i x_i) @ W. Across processes each process runs
    its own ranks and gathers the others' rows (`Mesh.share`)."""
    ranks = mesh.axis_ranks(axis_name)
    n = len(ranks)
    rows, d = _check(x, w, n)
    with mesh.region(ranks, x.device) as reg:
        cur, ws, acc = [None] * n, [None] * n, [None] * n
        for i, (piece, r) in enumerate(zip(x.chunk(n, dim=0), ranks)):
            if mesh.is_local(r):
                with mesh.on(r):
                    cur[i] = piece.to(mesh.device(r))
                    ws[i] = w.to(mesh.device(r)).float()
        like = x[:rows]  # a shard's shape and dtype
        for step in range(n):
            pending = None
            if step < n - 1:
                pending = [mesh.send(cur[i], ranks[i], ranks[(i + 1) % n],
                                     like=like)
                           for i in range(n)]
            for i, r in enumerate(ranks):
                if mesh.is_local(r):
                    with mesh.on(r):
                        part = torch.matmul(cur[i].float(), ws[i])
                        acc[i] = part if acc[i] is None else acc[i] + part
            if pending is not None:
                reg.keep(*cur)
                cur = [None if pending[(i - 1) % n] is None
                       else pending[(i - 1) % n].wait() for i in range(n)]
        reg.keep(*cur, *acc)
    return _gather_rows(mesh, ranks, acc, x.device, rows, d)


def _gather_rows(mesh: Mesh, ranks, acc, device, rows: int,
                 d: int) -> torch.Tensor:
    """Every rank's o rows [L, d] (this process's in `acc`, None for the
    others') as one [n·L, d] fp32 tensor on `device`."""
    like = torch.empty((rows, d), dtype=torch.float32, device=device)
    return torch.cat([mesh.share(None if a is None else a.to(device), r,
                                 like) for a, r in zip(acc, ranks)], dim=0)


class _Workspace:
    """What a ring keeps between calls on one (devices, rows, d, type,
    streams): per card the ranks it runs, their double buffers (tile
    images: bf16, or under `f32` each tile's hi and lo images, 4 bytes an
    element as fp32 is; one pair per column part, `column_parts`) and
    their flag words (one set per CTA); the ctypes pointer tables;
    the common grid and the scope. Made once: peer access is checked and
    enabled, the flags zeroed, and with several cards every card
    synchronised, so that no card's kernel stores into flags that are not
    zero yet. `lock` is held from `next_epoch` to a call's last launch."""

    def __init__(self, lib, devs: Sequence[torch.device], rows: int, d: int,
                 f32: bool = False, unit: str = ""):
        n = len(devs)
        self.n, self.rows, self.d, self.f32 = n, rows, d, int(f32)
        self.unit = unit  # the entry points' suffix: "_f16" for fp16
        self.cards: Dict[torch.device, List[int]] = {}
        for i, dev in enumerate(devs):
            self.cards.setdefault(dev, []).append(i)
        # a kernel stores into both neighbours' allocations
        for i, dev in enumerate(devs):
            for other in (devs[(i + 1) % n], devs[(i - 1) % n]):
                if other == dev:
                    continue
                if not torch.cuda.can_device_access_peer(dev.index,
                                                         other.index):
                    raise RuntimeError(
                        f"{dev} cannot access {other} as a peer: the "
                        f"device ring needs peer access between "
                        f"neighbouring cards")
                _build.check(
                    lib.cfa_enable_peer_access(dev.index, other.index),
                    f"peer access {dev} -> {other}")
        self.sys = int(len(self.cards) > 1)
        resident = {}
        for dev in self.cards:
            count = ctypes.c_int(0)
            _build.check(getattr(lib, "cfa_device_ring_resident" + unit)(
                d, self.sys, self.f32, dev.index, ctypes.byref(count)),
                "device ring occupancy")
            resident[dev] = count.value
        tiles = rows // KERNEL_TILE_ROWS
        # spans per rank (the kernel's CTAs are column_parts times as many)
        self.grid = common_grid(
            resident, {c: len(r) for c, r in self.cards.items()}, tiles)
        parts = column_parts(d, f32)
        bufs, flags = [0] * n, [0] * n
        self._bufs, self._flags = [], []
        for dev, idxs in self.cards.items():
            b = torch.empty((len(idxs), parts, 2, (1 + self.f32) * rows, d),
                            dtype=torch.bfloat16, device=dev)
            f = torch.zeros((len(idxs), parts * self.grid, FLAG_WORDS),
                            dtype=torch.int64, device=dev)
            self._bufs.append(b)
            self._flags.append(f)
            for j, i in enumerate(idxs):
                bufs[i] = b[j].data_ptr()
                flags[i] = f[j].data_ptr()
        self.bufs = (ctypes.c_void_p * n)(*bufs)
        self.flags = (ctypes.c_void_p * n)(*flags)
        self.local = {dev: (ctypes.c_int * len(idxs))(*idxs)
                      for dev, idxs in self.cards.items()}
        self.epoch = 0
        self.lock = threading.Lock()
        if len(self.cards) > 1:
            for dev in self.cards:
                torch.cuda.synchronize(dev)

    def next_epoch(self) -> int:
        self.epoch += 1
        if self.epoch >= EPOCH_LIMIT:  # 2^32 calls: zero the words again
            for dev in self.cards:
                torch.cuda.synchronize(dev)
            for f in self._flags:
                f.zero_()
            for dev in self.cards:
                torch.cuda.synchronize(dev)
            self.epoch = 1
        return self.epoch


_workspaces: "collections.OrderedDict[tuple, _Workspace]" = (
    collections.OrderedDict())
_workspaces_lock = threading.Lock()
# per mesh and axis: the ring's devices in ring order (a mesh does not
# change; reading them costs tens of µs per call)
_ring_devices: "weakref.WeakKeyDictionary[Mesh, Dict]" = (
    weakref.WeakKeyDictionary())


def _workspace(lib, devs: Tuple[torch.device, ...], rows: int, d: int,
               f32: bool, streams: Tuple[int, ...],
               unit: str = "") -> _Workspace:
    """The workspace of `devs` (in ring order) at (rows, d) of the bf16,
    fp16 (`unit` "_f16") or (`f32`) fp32 build, whose cards' current
    streams are `streams` (in the order the cards first appear)."""
    key = (devs, rows, d, streams, f32, unit)
    with _workspaces_lock:
        ws = _workspaces.get(key)
        if ws is None:
            ws = _Workspace(lib, devs, rows, d, f32, unit)
            _workspaces[key] = ws
            # dropping one is safe: its buffers go back to the allocator in
            # the order of the streams its kernels ran on, and each kernel
            # ends only after every store into its buffers and flags landed
            while len(_workspaces) > MAX_WORKSPACES:
                _workspaces.popitem(last=False)
        else:
            _workspaces.move_to_end(key)
        return ws


class _XpWorkspace:
    """A ring's workspace across processes (module docstring), made by
    every process of the ring at its first call of one (ranks, rows, d,
    type): this process's allocation (`xp_layout`) and the others',
    mapped; the pointer tables; the agreed grid; the epochs. Its store
    keys are named by the ring's processes and a count of the workspaces
    they made before, the same in each of them."""

    _made: "collections.Counter" = collections.Counter()

    def __init__(self, lib, mesh: Mesh, ranks: Sequence[int], rows: int,
                 d: int, f32: bool, unit: str = ""):
        me = mesh_mod.process_index()
        procs = [mesh.process(r) for r in ranks]
        self.procs = sorted(set(procs))
        self.n, self.rows, self.d, self.f32 = len(ranks), rows, d, int(f32)
        self.unit = unit
        self.sys = 1  # a neighbour writes from another context
        self.mine = [i for i, q in enumerate(procs) if q == me]
        cards = {mesh.device(ranks[i]) for i in self.mine}
        if len(cards) != 1:
            raise ValueError(f"process {me} runs its ranks of the device "
                             f"ring on {sorted(map(str, cards))}: across "
                             f"processes each process's ranks share its "
                             f"one card")
        self.dev = cards.pop()
        tag = "-".join(map(str, self.procs))
        _XpWorkspace._made[tag] += 1
        self.name = f"k9/{tag}/{_XpWorkspace._made[tag]}"
        st = mesh_mod.store()
        count = ctypes.c_int(0)
        _build.check(getattr(lib, "cfa_device_ring_resident" + unit)(
            d, self.sys, self.f32, self.dev.index, ctypes.byref(count)),
            "device ring occupancy")
        st.set(f"cfa/{self.name}/info/{me}", json.dumps(dict(
            card=mesh_mod.identity(self.dev), resident=count.value,
            ranks=len(self.mine))))
        infos = {q: json.loads(st.get(f"cfa/{self.name}/info/{q}"))
                 for q in self.procs}
        self.grid = xp_grid(infos, rows // KERNEL_TILE_ROWS)
        held = [info["card"] for info in infos.values()]
        # processes that share a card: the card time-slices their kernels
        self.shared_card = len(set(held)) < len(held)
        layout, total = xp_layout(rows, d, f32, self.grid, len(self.mine))
        own, handle = ctypes.c_void_p(), ctypes.create_string_buffer(
            IPC_HANDLE_BYTES)
        _build.check(lib.cfa_ipc_alloc(self.dev.index, total,
                                       ctypes.byref(own), handle),
                     "device ring workspace across processes")
        self.own = own.value
        st.set(f"cfa/{self.name}/handle/{me}", handle.raw.hex())
        self.mapped: Dict[int, int] = {}
        for q in self.procs:
            if q == me:
                continue  # a process cannot open its own handle
            raw = bytes.fromhex(st.get(f"cfa/{self.name}/handle/{q}")
                                .decode())
            ptr = ctypes.c_void_p()
            _build.check(lib.cfa_ipc_open(
                self.dev.index, ctypes.create_string_buffer(raw, len(raw)),
                ctypes.byref(ptr)), f"opening process {q}'s ring workspace")
            self.mapped[q] = ptr.value
        bufs, flags = [], []
        for src in xp_sources(procs, me):
            base = self.own if src[0] == "local" else self.mapped[src[1]]
            b, f = layout[src[-1]]
            bufs.append(base + b)
            flags.append(base + f)
        self.bufs = (ctypes.c_void_p * self.n)(*bufs)
        self.flags = (ctypes.c_void_p * self.n)(*flags)
        self.local = (ctypes.c_int * len(self.mine))(*self.mine)
        self.epoch = 0
        self.lock = threading.Lock()
        self._lib = lib
        # every process's flags are zero and mapped before any launch
        mesh_mod.store_barrier(f"{self.name}/made", self.procs)
        self._prev = f"{self.name}/made"
        mesh_mod.at_shutdown(_release_xp_workspaces)

    def start(self, stream) -> int:
        """This call's epoch, once this process's stream has drained and
        every process of the ring has reached the same epoch (held under
        `lock`)."""
        self.epoch += 1
        if self.epoch >= EPOCH_LIMIT:
            raise RuntimeError(f"the cross-process device ring's workspace "
                               f"has run {EPOCH_LIMIT - 1} calls: its flags "
                               f"cannot be zeroed again while mapped")
        t0 = time.perf_counter()
        stream.synchronize()
        name = f"{self.name}/e{self.epoch}"
        mesh_mod.store_barrier(name, self.procs, prev=self._prev)
        self._prev = name
        device_ring_matmul.last_start_s = time.perf_counter() - t0
        return self.epoch

    def release(self) -> None:
        """Unmap the others' allocations, wait for every process of the
        ring to have done so, and free this process's."""
        torch.cuda.synchronize(self.dev)
        for q, ptr in self.mapped.items():
            _build.check(self._lib.cfa_ipc_close(self.dev.index, ptr),
                         f"closing process {q}'s ring workspace")
        mesh_mod.store_barrier(f"{self.name}/closed", self.procs)
        _build.check(self._lib.cfa_ipc_free(self.dev.index, self.own),
                     "freeing the ring workspace")


# cross-process workspaces, kept until `shutdown_distributed` (their
# release is collective, so no least-recently-used rule drops them)
_xp_workspaces: Dict[tuple, _XpWorkspace] = {}


def _release_xp_workspaces() -> None:
    while _xp_workspaces:
        _xp_workspaces.popitem()[1].release()


def _device_ring_xp(lib, x, w, mesh: Mesh, axis_name: str, rows: int,
                    d: int) -> torch.Tensor:
    """K9 over a ring whose ranks run in several processes: this
    process's ranks in one launch on its card, the others' rows of o from
    their processes."""
    ranks = mesh.axis_ranks(axis_name)
    f32, unit = x.dtype == torch.float32, _unit(x)
    key = (tuple(mesh.place(r) for r in ranks), rows, d, f32, unit)
    with _workspaces_lock:
        ws = _xp_workspaces.get(key)
        if ws is None:
            ws = _xp_workspaces[key] = _XpWorkspace(lib, mesh, ranks, rows,
                                                     d, f32, unit)
    dev = ws.dev
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        x_dev = torch.cat([x[i * rows:(i + 1) * rows]
                           for i in ws.mine]).to(dev).contiguous()
        w_dev = w.to(dev).contiguous()
        out_dev = torch.empty((len(ws.mine) * rows, d), dtype=torch.float32,
                              device=dev)
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        with ws.lock:
            epoch = ws.start(stream)
            events[0].record(stream)
            err = getattr(lib, "cfa_device_ring" + ws.unit)(
                x_dev.data_ptr(), w_dev.data_ptr(), out_dev.data_ptr(),
                ws.bufs, ws.flags, ws.n, ws.local, len(ws.mine), rows, d,
                ws.grid, epoch, ws.sys, ws.f32, dev.index,
                stream.cuda_stream)
            _build.check(err, "device_ring_matmul kernel launch")
            events[1].record(stream)
        device_ring_matmul.last_events = events
        device_ring_matmul.launches += 1
        device_ring_matmul.last_grid = (ws.grid, len(ws.mine))
        device_ring_matmul.last_scope = "sys"
        if ws.shared_card:
            try:
                stream.synchronize()
            except RuntimeError as e:
                raise RuntimeError(
                    f"the device ring across processes that share a card "
                    f"({dev}) did not finish: the card runs their kernels "
                    f"in turns, and a spin on a neighbour's flag gave up "
                    f"(its trap): {e}") from e
    acc = [None] * ws.n
    for j, i in enumerate(ws.mine):
        acc[i] = out_dev[j * rows:(j + 1) * rows]
    return _gather_rows(mesh, ranks, acc, x.device, rows, d)


def _unit(x: torch.Tensor) -> str:
    """The entry points' suffix of x's build: "_f16" for fp16 x and W,
    "" for bf16 and fp32."""
    return "_f16" if x.dtype == torch.float16 else ""


def _launch(lib, ws: _Workspace, dev: torch.device, x_dev, w_dev, out_dev,
            epoch: int, stream) -> None:
    idxs = ws.cards[dev]
    err = getattr(lib, "cfa_device_ring" + _unit(x_dev))(
        x_dev.data_ptr(), w_dev.data_ptr(), out_dev.data_ptr(), ws.bufs,
        ws.flags, ws.n, ws.local[dev], len(idxs), ws.rows, ws.d, ws.grid,
        epoch, ws.sys, ws.f32, dev.index, stream.cuda_stream)
    _build.check(err, "device_ring_matmul kernel launch")
    device_ring_matmul.launches += 1
    device_ring_matmul.last_grid = (ws.grid, len(idxs))
    device_ring_matmul.last_scope = "sys" if ws.sys else "gpu"


def _devices_of(mesh: Mesh, axis_name: str) -> Tuple[torch.device, ...]:
    per_axis = _ring_devices.setdefault(mesh, {})
    if axis_name not in per_axis:
        per_axis[axis_name] = tuple(mesh.device(r)
                                    for r in mesh.axis_ranks(axis_name))
    return per_axis[axis_name]


def _device_ring_cuda(x, w, mesh: Mesh, axis_name: str) -> torch.Tensor:
    devs = _devices_of(mesh, axis_name)
    n = len(devs)
    rows, d = _check(x, w, n)
    floats = (torch.bfloat16, torch.float16, torch.float32)
    if x.dtype not in floats or w.dtype not in floats:
        raise NotImplementedError(
            f"the CUDA ring takes bf16, fp16 or fp32 x and w, got "
            f"{x.dtype} / {w.dtype}")
    if x.dtype != w.dtype:
        # JAX's promotion: the product of two float types on exactly
        # upcast operands, which the fp32 build holds (each split exactly)
        x, w = x.float(), w.float()
    d_run = run_dim(d, RING_HEAD_DIMS)
    if d_run is None:
        raise ValueError(f"the CUDA ring takes d from 1 to "
                         f"{max(RING_HEAD_DIMS)} (builds at "
                         f"{RING_HEAD_DIMS}; a narrower d runs at the next "
                         f"of them with zero columns), got {d}")
    if d_run != d:
        # zero columns of x and zero rows and columns of W add nothing to
        # o's first d columns
        xp = x.new_zeros((x.shape[0], d_run))
        xp[:, :d] = x
        wp = w.new_zeros((d_run, d_run))
        wp[:d, :d] = w
        return _device_ring_cuda(xp, wp, mesh, axis_name)[:, :d]
    if rows % KERNEL_TILE_ROWS:
        raise ValueError(f"the CUDA ring takes shards of a multiple of "
                         f"{KERNEL_TILE_ROWS} rows, got {rows}")
    if n > KERNEL_MAX_RANKS:
        raise ValueError(f"the CUDA ring takes at most {KERNEL_MAX_RANKS} "
                         f"ranks, got {n}")
    for dev in devs:
        if dev.type != "cuda":
            raise ValueError(f"x is on {x.device} but the mesh holds {dev}: "
                             f"the CUDA ring needs every rank on a card")
    lib = _build.library()
    if mesh.spans_processes:
        return _device_ring_xp(lib, x.contiguous(), w.contiguous(), mesh,
                               axis_name, rows, d)
    main = torch.cuda.current_stream(x.device)
    cards = list(dict.fromkeys(devs))
    one_card = cards == [x.device]
    streams = ((main.cuda_stream,) if one_card else tuple(
        torch.cuda.current_stream(c).cuda_stream for c in cards))
    ws = _workspace(lib, devs, rows, d, x.dtype == torch.float32, streams,
                    _unit(x))
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((n * rows, d), dtype=torch.float32, device=x.device)
    if one_card:
        # every rank on x's card, in ring order: x and o as they are
        with ws.lock:
            _launch(lib, ws, x.device, x, w, out, ws.next_epoch(), main)
        return out
    ready = main.record_event()
    placed = []
    # every card's inputs first: a copy between cards waits for the source
    # card's stream, and after a launch that stream holds a kernel spinning
    # on the other cards' kernels
    for dev, idxs in ws.cards.items():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ready)
            x_dev = torch.cat([x[i * rows:(i + 1) * rows]
                               for i in idxs]).to(dev)
            out_dev = torch.empty((len(idxs) * rows, d),
                                  dtype=torch.float32, device=dev)
            placed.append((dev, stream, idxs, x_dev, w.to(dev), out_dev))
    with ws.lock:
        epoch = ws.next_epoch()
        for dev, stream, _, x_dev, w_dev, out_dev in placed:
            _launch(lib, ws, dev, x_dev, w_dev, out_dev, epoch, stream)
    for _, stream, _, _, _, _ in placed:
        main.wait_event(stream.record_event())
    for _, _, idxs, _, _, out_dev in placed:
        for j, i in enumerate(idxs):
            out[i * rows:(i + 1) * rows].copy_(
                out_dev[j * rows:(j + 1) * rows])
        # the copy reads out_dev on x's stream: its block must not go back
        # to its own stream's allocator before the copy has run
        out_dev.record_stream(main)
    return out


def device_ring_matmul(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                       axis_name: str = "sp") -> torch.Tensor:
    """o = (Σ_shards x) @ w through the in-kernel ring: x [n·L, d] sharded
    on rows over `axis_name`, w [d, d] → o [n·L, d] fp32 on x's device,
    every rank's L rows holding the same (Σ_i x_i) @ W.

    On the card the kernel takes bf16 or fp16 x and w (its bf16 and fp16
    builds), or fp32 ones (its fp32
    build: every value split into bf16 hi and lo halves, three bf16
    products per step, the split images pushed), and x and w of two float
    types upcast to the fp32 build (JAX's promotion), d in {64, 128, 256} (any
    other d up to 256 on x and w zero-padded to the next of them, o
    sliced back; d past 256 raises ValueError), L a multiple of 64 and at
    most 32 ranks, every one on a card; ranks on
    different cards need peer access. It raises otherwise: a CUDA tensor
    never takes the plain version. `device_ring_matmul.launches` counts
    the kernel's launches (one per card), `.last_grid` is the last
    launch's (spans per rank, ranks: a span is one CTA, two at d = 256
    in fp32), `.last_scope` its flags' scope
    ("gpu": one card, "sys": across cards).

    A mesh that spans processes runs each process's ranks in one launch
    on its card, over a workspace shared by CUDA IPC handles (module
    docstring); `.last_start_s` is the host seconds its last call waited
    for its stream and the other processes before the launch, and
    `.last_events` the CUDA events recorded just before and after that
    launch (the kernel's time, once they have completed). On CPU tensors
    the plain ring runs across processes too."""
    if x.device != w.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ring_matmul_plain(x, w, mesh, axis_name)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _device_ring_cuda(x, w, mesh, axis_name)


device_ring_matmul.launches = 0
device_ring_matmul.last_grid = (0, 0)
device_ring_matmul.last_scope = None
device_ring_matmul.last_start_s = 0.0
device_ring_matmul.last_events = None
