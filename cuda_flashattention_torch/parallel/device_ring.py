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
    some neighbour is on another.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import weakref
from typing import Dict, List, Sequence, Tuple

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import RING_HEAD_DIMS, run_dim
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
                 f32: bool = False):
        n = len(devs)
        self.n, self.rows, self.d, self.f32 = n, rows, d, int(f32)
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
            _build.check(lib.cfa_device_ring_resident(
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
               f32: bool, streams: Tuple[int, ...]) -> _Workspace:
    """The workspace of `devs` (in ring order) at (rows, d) of the bf16 or
    (`f32`) fp32 build, whose cards' current streams are `streams` (in the
    order the cards first appear)."""
    key = (devs, rows, d, streams, f32)
    with _workspaces_lock:
        ws = _workspaces.get(key)
        if ws is None:
            ws = _Workspace(lib, devs, rows, d, f32)
            _workspaces[key] = ws
            # dropping one is safe: its buffers go back to the allocator in
            # the order of the streams its kernels ran on, and each kernel
            # ends only after every store into its buffers and flags landed
            while len(_workspaces) > MAX_WORKSPACES:
                _workspaces.popitem(last=False)
        else:
            _workspaces.move_to_end(key)
        return ws


def _launch(lib, ws: _Workspace, dev: torch.device, x_dev, w_dev, out_dev,
            epoch: int, stream) -> None:
    idxs = ws.cards[dev]
    err = lib.cfa_device_ring(
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
    if x.dtype != w.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"the CUDA ring takes bf16 or fp32 x and w of one dtype, got "
            f"{x.dtype} / {w.dtype}")
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
    main = torch.cuda.current_stream(x.device)
    cards = list(dict.fromkeys(devs))
    one_card = cards == [x.device]
    streams = ((main.cuda_stream,) if one_card else tuple(
        torch.cuda.current_stream(c).cuda_stream for c in cards))
    ws = _workspace(lib, devs, rows, d, x.dtype == torch.float32, streams)
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

    On the card the kernel takes bf16 x and w, or fp32 ones (its fp32
    build: every value split into bf16 hi and lo halves, three bf16
    products per step, the split images pushed), d in {64, 128, 256} (any
    other d up to 256 on x and w zero-padded to the next of them, o
    sliced back; d past 256 raises ValueError), L a multiple of 64 and at
    most 32 ranks, every one on a card; ranks on
    different cards need peer access. It raises otherwise: a CUDA tensor
    never takes the plain version. `device_ring_matmul.launches` counts
    the kernel's launches (one per card), `.last_grid` is the last
    launch's (spans per rank, ranks: a span is one CTA, two at d = 256
    in fp32), `.last_scope` its flags' scope
    ("gpu": one card, "sys": across cards).

    The ring is one process's: the kernel reaches its neighbours by
    device pointers, which do not cross processes (that needs CUDA IPC
    handles), so a mesh that spans processes raises ValueError, on the
    CPU too."""
    if mesh.spans_processes:
        raise ValueError(
            "device_ring_matmul runs a ring of one process (its kernel "
            "reaches the neighbours' buffers by device pointers): a mesh "
            "that spans processes is not supported: build the mesh over "
            "this process's devices")
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
