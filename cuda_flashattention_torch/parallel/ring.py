"""Ring (sequence-parallel) attention and sharded-cache decode over a mesh.

Counterpart of cuda_flashattention_tpu/parallel/ring.py, single-controller
as the JAX package is: global tensors in, global tensors out, a `Mesh`
(parallel/mesh.py) and axis names. What `shard_map` + `ppermute` do there
is written out here: `ring_attention` cuts the global q/k/v into the
ranks' shards (views where a rank shares the input's device, copies to
its card otherwise) and gathers O back; `ring_attention_local` takes the
shards where they already are (the model's sequence-parallel path) and
returns O there. Each rank's step runs on that rank's compute stream, and K/V
travel to the next rank through `Mesh.send` on the copy stream — queued
before the step's kernels and awaited after them, so the copy is in flight
under the kernels (the dual-stream design of the CUDA reference).

Per step a rank attends the K/V block it holds with the package's forward
(`flash_attention_forward`: kernel K1, or K1b where `softmax="auto"`
routes a non-causal step to the bound softmax) and merges the normalised
partial (O, LSE) in log space (`combine_partials`). Under a causal mask
global causality reduces to three cases by ring position: a block strictly
behind the queries is attended in full (under a sliding window: causal +
window with kv_offset = step·L), the rank's own block causally, a block
ahead not at all. The ring position is a host value here, so a skipped
step launches nothing and is left out of the merge, which equals merging
a (0, NEG_INF) partial. The backward is the standard ring gradient, one
`torch.autograd.Function`: every (Q shard, K/V block) pair gives
`flash_attention_backward` partials (kernel K4) against the GLOBAL LSE,
dQ accumulates in fp32 where it is, and the fp32 dK/dV accumulators travel
with their K/V block and go home in one last hop.

`ring_decode` needs no rotation: each rank runs the decode kernel (K6) on
its resident slice of the cache and the partials are reduced once.

Across processes (a mesh of `Place`s) every process holds the global
inputs, as a global `jax.Array` is addressable everywhere: each runs the
cells of its own ranks, posts every hop in the same order as the others
(`Mesh.send` pairs them up; which steps are skipped is decided on the
host, identically everywhere, so a hop is never sent on one side and
skipped on the other), and the global result is gathered into every
process (`Mesh.share`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from cuda_flashattention_torch.ops.common import (
    BlockSizes,
    cdiv,
    resolve_scale,
)
from cuda_flashattention_torch.ops.decode import decode_attention
from cuda_flashattention_torch.ops.flash_bwd import flash_attention_backward
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_torch.parallel.mesh import Mesh

# per-rank shards: {rank: tensor}, or a list in `Mesh.axis_ranks` order
ShardsIn = Union[Dict[int, torch.Tensor], List[torch.Tensor]]


def combine_partials(o1: torch.Tensor, lse1: torch.Tensor,
                     o2: torch.Tensor, lse2: torch.Tensor):
    """Merge two normalised partials over disjoint key sets:
    O = Σᵢ Oᵢ·exp(LSEᵢ − LSE), LSE = logaddexp(LSEᵢ)."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    return o1 * w1 + o2 * w2, lse


# ---------------------------------------------------------------------------
# One ring step
# ---------------------------------------------------------------------------

def _step_opts(kv_idx: int, my_idx: int, *, causal: bool, window: int,
               step: int, shard_len: int, qseg=None, kseg=None):
    """Mask options of one ring step, or None when the step is skipped.

    Non-causal: every block in full; a ragged global sequence masks its
    pad tail through segment ids that rotate with their K/V shard.
    Causal: block behind → full (with a window: causal + window with
    kv_offset = step·L, since at ring distance `step` every local column
    sits step·L before the local row); same block → causal (windowed);
    block ahead → skipped."""
    if not causal:
        return dict(causal=False, q_segment_ids=qseg, kv_segment_ids=kseg)
    if kv_idx > my_idx:
        return None
    if kv_idx == my_idx:
        return dict(causal=True, window=window)
    if window:
        return dict(causal=True, window=window, kv_offset=step * shard_len)
    return dict(causal=False)


def _step_fwd(q, k, v, kv_idx, my_idx, *, scale, causal, window, step,
              shard_len, qseg=None, kseg=None, block_sizes=None):
    """One ring step's local attention: (O fp32, LSE), or None (skipped)."""
    opts = _step_opts(kv_idx, my_idx, causal=causal, window=window,
                      step=step, shard_len=shard_len, qseg=qseg, kseg=kseg)
    if opts is None:
        return None
    return flash_attention_forward(q, k, v, scale=scale,
                                   out_dtype=torch.float32,
                                   block_sizes=block_sizes, **opts)


def _step_bwd(q, k, v, o, lse, do, kv_idx, my_idx, *, scale, causal, window,
              step, shard_len, qseg=None, kseg=None, block_sizes=None):
    """One ring step's gradient partials against the global LSE, or None
    (skipped)."""
    opts = _step_opts(kv_idx, my_idx, causal=causal, window=window,
                      step=step, shard_len=shard_len, qseg=qseg, kseg=kseg)
    if opts is None:
        return None
    return flash_attention_backward(q, k, v, o, lse, do, scale=scale,
                                    block_sizes=block_sizes, **opts)


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _RingPlan:
    """What one `ring_attention` call resolved to."""
    mesh: Mesh
    axis_name: str
    batch_axis: Optional[str]
    head_axis: Optional[str]
    n_shards: int
    shard_len: int
    scale: float
    causal: bool
    window: int
    ragged: bool
    block_sizes: Optional[BlockSizes] = None  # every step's tiles

    @property
    def max_steps(self) -> int:
        # A window of W tokens reaches back at most ceil(W/L) shards, so
        # the ring ends after that many hops: traffic and compute scale
        # with the window, not the context.
        if self.causal and self.window:
            return min(self.n_shards, cdiv(self.window, self.shard_len) + 1)
        return self.n_shards


class _Cell:
    """One rank's part of the ring: its index on the ring axis, the
    slices of the global tensors it owns, and what it holds now."""

    def __init__(self, rank, idx, group, b_sl, hq_sl, hkv_sl, n_sl):
        self.rank, self.idx, self.group = rank, idx, group
        self.b_sl, self.hq_sl, self.hkv_sl, self.n_sl = (b_sl, hq_sl, hkv_sl,
                                                         n_sl)


def _chunks(total: int, parts: int, what: str) -> List[slice]:
    if total % parts:
        raise ValueError(f"{what} {total} does not divide over {parts} "
                         f"mesh ranks")
    step = total // parts
    return [slice(i * step, (i + 1) * step) for i in range(parts)]


def _cells(plan: _RingPlan, b: int, h: int, h_kv: int) -> List[_Cell]:
    """The ring's cells: one ring of `n_shards` ranks per (batch shard,
    head shard). Mesh axes that are not named replicate in the JAX
    function; here their index-0 ranks do the work once."""
    mesh = plan.mesh
    nb = mesh.shape[plan.batch_axis] if plan.batch_axis else 1
    nh = mesh.shape[plan.head_axis] if plan.head_axis else 1
    b_sls = _chunks(b, nb, "batch")
    hq_sls = _chunks(h, nh, "q heads")
    hkv_sls = _chunks(h_kv, nh, "kv heads")
    n_sls = [slice(i * plan.shard_len, (i + 1) * plan.shard_len)
             for i in range(plan.n_shards)]
    cells = []
    for bi in range(nb):
        for hi in range(nh):
            coords = {}
            if plan.batch_axis:
                coords[plan.batch_axis] = bi
            if plan.head_axis:
                coords[plan.head_axis] = hi
            ranks = mesh.axis_ranks(plan.axis_name, **coords)
            for idx, rank in enumerate(ranks):
                cells.append(_Cell(rank, idx, bi * nh + hi, b_sls[bi],
                                   hq_sls[hi], hkv_sls[hi], n_sls[idx]))
    return cells


def _place(mesh: Mesh, cell: _Cell, x: Optional[torch.Tensor], heads: str):
    """The cell's shard of a global tensor ([B,H,N,d], [B,H,N] or [B,N]),
    on the cell's device: a view where the devices agree, else a copy
    queued on the cell's compute stream; None for a cell of another
    process (every process holds the global tensor: nothing moves between
    processes here)."""
    if x is None or not mesh.is_local(cell.rank):
        return None
    if x.ndim == 2:
        sl = x[cell.b_sl, cell.n_sl]
    else:
        h_sl = cell.hq_sl if heads == "q" else cell.hkv_sl
        sl = x[cell.b_sl, h_sl, cell.n_sl]
    dev = mesh.device(cell.rank)
    if sl.device != dev:
        with mesh.on(cell.rank):
            sl = sl.to(dev, non_blocking=True)
    return sl


def _right(cells: List[_Cell], plan: _RingPlan, i: int, hops: int = 1) -> int:
    """Index of the cell `hops` places to the right of cell i in its ring
    (cells of one ring are consecutive)."""
    base = i - cells[i].idx
    return base + (cells[i].idx + hops) % plan.n_shards


def _gather(mesh: Mesh, out: torch.Tensor, cell: _Cell,
            part: Optional[torch.Tensor], heads: str) -> None:
    """Write a cell's part into the global result (after the join), in
    every process: the cell's process shares it with the others
    (`Mesh.share`), so every process must gather every cell, in order."""
    if out.ndim == 3:
        dst = out[cell.b_sl, cell.hq_sl, cell.n_sl]
    else:
        h_sl = cell.hq_sl if heads == "q" else cell.hkv_sl
        dst = out[cell.b_sl, h_sl, cell.n_sl]
    if part is not None:
        part = part.to(device=out.device, dtype=out.dtype)
    dst.copy_(mesh.share(part, cell.rank, like=dst))


def _forward_cells(plan: _RingPlan, cells: List[_Cell], reg, dtype) -> None:
    """The ring forward over cells that hold their q, k, v, qseg and kseg
    shards: sets each cell's O (in `dtype`) and LSE (fp32)."""
    mesh = plan.mesh
    steps = plan.max_steps
    mine = [c for c in cells if mesh.is_local(c.rank)]
    for c in cells:
        c.o = c.lse = None
    for step in range(steps):
        last = step == steps - 1
        pending = {}
        if not last:
            # the next step's K/V start travelling before this step's
            # kernels are queued, and are awaited after them
            pending = _pass_blocks(plan, cells)
        for c in mine:
            kv_idx = (c.idx - step) % plan.n_shards
            with mesh.on(c.rank):
                part = _step_fwd(
                    c.q, c.k, c.v, kv_idx, c.idx, scale=plan.scale,
                    causal=plan.causal, window=plan.window, step=step,
                    shard_len=plan.shard_len, qseg=c.qseg, kseg=c.kseg,
                    block_sizes=plan.block_sizes)
                if part is None:
                    continue
                if c.o is None:
                    c.o, c.lse = part
                else:
                    c.o, c.lse = combine_partials(c.o, c.lse, *part)
        _take_blocks(cells, pending, reg)
    for c in mine:
        with mesh.on(c.rank):
            c.o = c.o.to(dtype)
        reg.keep(c.o, c.lse, c.k, c.v, c.kseg)
    # no rank reuses the memory of a block before its right neighbour
    # has copied it
    mesh.barrier([c.rank for c in cells])


def _pass_blocks(plan: _RingPlan, cells: List[_Cell]) -> dict:
    """Post every cell's K/V block (and its key segment ids when ragged)
    to its right neighbour: {receiving cell index: [k, v, kseg transfers]}
    for the cells of this process. Every process posts the hops of every
    cell in the same order."""
    mesh, pending = plan.mesh, {}
    for i, c in enumerate(cells):
        j = _right(cells, plan, i)
        to = cells[j]
        moving = [mesh.send(c.k, c.rank, to.rank, like=to.k),
                  mesh.send(c.v, c.rank, to.rank, like=to.v),
                  mesh.send(c.kseg, c.rank, to.rank, like=to.kseg)
                  if plan.ragged else None]
        if mesh.is_local(to.rank):
            pending[j] = moving
    return pending


def _take_blocks(cells: List[_Cell], pending: dict, reg) -> None:
    """Each receiving cell takes the block `_pass_blocks` sent it."""
    for j, (tk, tv, ts) in pending.items():
        c = cells[j]
        reg.keep(c.k, c.v, c.kseg)
        c.k, c.v = tk.wait(), tv.wait()
        if ts is not None:
            c.kseg = ts.wait()


def _ring_forward(plan: _RingPlan, q, k, v, qseg, kseg):
    """The ring forward on padded global tensors → (O in q's dtype,
    LSE fp32), global, on q's device."""
    mesh = plan.mesh
    b, h, n_pad, d = q.shape
    cells = _cells(plan, b, h, k.shape[1])
    with mesh.region([c.rank for c in cells], q.device) as reg:
        for c in cells:
            c.q = _place(mesh, c, q, "q")
            c.k, c.v = _place(mesh, c, k, "kv"), _place(mesh, c, v, "kv")
            c.qseg, c.kseg = (_place(mesh, c, qseg, ""),
                              _place(mesh, c, kseg, ""))
        _forward_cells(plan, cells, reg, q.dtype)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, n_pad), dtype=torch.float32, device=q.device)
    for c in cells:
        _gather(mesh, out, c, c.o, "q")
        _gather(mesh, lse, c, c.lse, "q")
    return out, lse


def _backward_cells(plan: _RingPlan, cells: List[_Cell], reg) -> None:
    """The ring backward over cells that hold their q, k, v, O, LSE, dO,
    qseg and kseg shards: sets each cell's dq and its K/V block's
    dk_home, dv_home (fp32)."""
    mesh = plan.mesh
    steps = plan.max_steps
    for c in cells:
        c.dq = c.dk = c.dv = c.dk_home = c.dv_home = None
        if not mesh.is_local(c.rank):
            continue
        with mesh.on(c.rank):
            c.dq = torch.zeros(c.q.shape, dtype=torch.float32,
                               device=c.q.device)
            c.dk = torch.zeros(c.k.shape, dtype=torch.float32,
                               device=c.k.device)
            c.dv = torch.zeros_like(c.dk)
    arriving = {}  # cell → the accumulators sent to it after a step
    for step in range(steps):
        last = step == steps - 1
        pending = {}
        if not last:
            pending = _pass_blocks(plan, cells)
        for i, c in enumerate(cells):
            if not mesh.is_local(c.rank):
                continue
            kv_idx = (c.idx - step) % plan.n_shards
            with mesh.on(c.rank):
                part = _step_bwd(
                    c.q, c.k, c.v, c.o, c.lse, c.do, kv_idx, c.idx,
                    scale=plan.scale, causal=plan.causal,
                    window=plan.window, step=step,
                    shard_len=plan.shard_len, qseg=c.qseg, kseg=c.kseg,
                    block_sizes=plan.block_sizes)
                if i in arriving:
                    # the accumulators of the block this cell now
                    # holds, sent after the last step
                    reg.keep(c.dk, c.dv)
                    c.dk, c.dv = (t.wait() for t in arriving.pop(i))
                if part is not None:
                    c.dq += part[0].float()
                    c.dk += part[1].float()
                    c.dv += part[2].float()
        if not last:
            _take_blocks(cells, pending, reg)
            # dK/dV accumulators travel WITH their K/V block, after
            # the step that updated them
            for i, c in enumerate(cells):
                to = cells[_right(cells, plan, i)]
                moving = (mesh.send(c.dk, c.rank, to.rank, like=to.dk),
                          mesh.send(c.dv, c.rank, to.rank, like=to.dv))
                if mesh.is_local(to.rank):
                    arriving[_right(cells, plan, i)] = moving
    # After max_steps − 1 hops the cell at ring index i holds the
    # accumulators of K/V shard i − (max_steps − 1): one hop sends
    # each home (none when the ring never moved).
    for i, c in enumerate(cells):
        home = cells[_right(cells, plan, i, hops=-(steps - 1))]
        if home is c:
            c.dk_home, c.dv_home = c.dk, c.dv
            continue
        moving = [mesh.send(t, c.rank, home.rank, like=home.dk)
                  for t in (c.dk, c.dv)]
        if mesh.is_local(home.rank):
            home.dk_home, home.dv_home = (t.wait() for t in moving)
    for c in cells:
        reg.keep(c.dq, c.dk, c.dv, c.dk_home, c.dv_home, c.k, c.v,
                 c.kseg)
    mesh.barrier([c.rank for c in cells])


def _ring_backward(plan: _RingPlan, q, k, v, o, lse, qseg, kseg, do):
    """The ring backward on padded global tensors → (dQ, dK, dV) in the
    inputs' dtypes, global, on q's device."""
    mesh = plan.mesh
    b, h, n_pad, d = q.shape
    cells = _cells(plan, b, h, k.shape[1])
    with mesh.region([c.rank for c in cells], q.device) as reg:
        for c in cells:
            c.q, c.o = _place(mesh, c, q, "q"), _place(mesh, c, o, "q")
            c.do, c.lse = _place(mesh, c, do, "q"), _place(mesh, c, lse, "q")
            c.k, c.v = _place(mesh, c, k, "kv"), _place(mesh, c, v, "kv")
            c.qseg, c.kseg = (_place(mesh, c, qseg, ""),
                              _place(mesh, c, kseg, ""))
        _backward_cells(plan, cells, reg)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    for c in cells:
        _gather(mesh, dq, c, c.dq, "q")
        _gather(mesh, dk, c, c.dk_home, "kv")
        _gather(mesh, dv, c, c.dv_home, "kv")
    return dq, dk, dv


class RingAttention(torch.autograd.Function):
    """O = ring attention of the padded global q, k, v over the plan's
    mesh axis; saves (q, k, v, O, LSE) for the ring backward."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, plan: _RingPlan):
        o, lse = _ring_forward(plan, q, k, v, qseg, kseg)
        ctx.save_for_backward(q, k, v, o, lse, qseg, kseg)
        ctx.plan = plan
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, qseg, kseg = ctx.saved_tensors
        dq, dk, dv = _ring_backward(ctx.plan, q, k, v, o, lse, qseg, kseg,
                                    do)
        return dq, dk, dv, None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis_name: str = "sp",
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    block_sizes=None,
    batch_axis: Optional[str] = None,
    head_axis: Optional[str] = None,
) -> torch.Tensor:
    """Sequence-parallel attention: q [B,H,N,d], k/v [B,Hkv,N,d] sharded
    on N over `axis_name` → O [B,H,N,d] on q's device. Differentiable
    (the ring backward).

    Composes with data and tensor parallelism: `batch_axis` shards B and
    `head_axis` shards H and Hkv (heads are independent, so each (batch
    shard, head shard) runs its own ring). Under a causal `window` the
    ring ends after min(n, ceil(W/L) + 1) steps.

    A sequence length that does not divide the axis is padded up to the
    shard grid: causal needs no mask (pad rows sit past every real row),
    non-causal marks the pad tail with segment ids (−1 on the query side,
    −2 on the key side) that travel around the ring with their shard.
    `block_sizes` reaches every step's forward and backward kernels."""
    n_shards = mesh.shape[axis_name]
    b, h, n, d = q.shape
    if h % k.shape[1] != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads "
                         f"{k.shape[1]}")
    window = int(window or 0)
    if window and not causal:
        raise ValueError("window requires causal=True")

    n_pad = cdiv(n, n_shards) * n_shards
    ragged = n_pad != n and not causal
    if n_pad != n:
        pad = (0, 0, 0, n_pad - n)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    qseg = kseg = None
    if ragged:
        # pad q rows get id -1, pad kv rows -2: they match nothing
        ids = torch.arange(n_pad, device=q.device)[None, :]
        zero = torch.zeros((), dtype=torch.int32, device=q.device)
        qseg = torch.where(ids < n, zero, zero - 1).expand(b, n_pad)
        kseg = torch.where(ids < n, zero, zero - 2).expand(b, n_pad)
        qseg, kseg = qseg.contiguous(), kseg.contiguous()
    plan = _RingPlan(mesh=mesh, axis_name=axis_name, batch_axis=batch_axis,
                     head_axis=head_axis, n_shards=n_shards,
                     shard_len=n_pad // n_shards,
                     scale=resolve_scale(scale, d), causal=bool(causal),
                     window=window, ragged=ragged, block_sizes=block_sizes)
    out = RingAttention.apply(q, k, v, qseg, kseg, plan)
    return out[:, :, :n]


def _local_cells(mesh: Mesh, axis_name: str, ranks) -> List[_Cell]:
    """One ring per group of `axis_name` over `ranks` (and the other
    processes' ranks of those groups), its cells consecutive in ring order
    (the shards' slices are not needed)."""
    cells = []
    for group, ring in enumerate(mesh.fibers(axis_name, ranks)):
        cells += [_Cell(rank, idx, group, None, None, None, None)
                  for idx, rank in enumerate(ring)]
    return cells


class RingAttentionLocal(torch.autograd.Function):
    """Per-rank O of ring attention over resident shards:
    forward(ctx, plan, ranks, *q, *k, *v), one shard of each per rank in
    `ranks` order; saves the shards, O and LSE for the ring backward."""

    @staticmethod
    def forward(ctx, plan: _RingPlan, ranks, *qkv):
        n = len(ranks)
        mesh = plan.mesh
        cells = _local_cells(mesh, plan.axis_name, ranks)
        at = {r: i for i, r in enumerate(ranks)}
        with mesh.region(ranks, mesh.device(ranks[0])) as reg:
            for c in cells:
                i = at.get(c.rank)
                c.q, c.k, c.v = ((qkv[i], qkv[n + i], qkv[2 * n + i])
                                 if i is not None else (None,) * 3)
                c.qseg = c.kseg = None
            _forward_cells(plan, cells, reg, qkv[0].dtype)
        by_rank = {c.rank: c for c in cells}
        o = [by_rank[r].o for r in ranks]
        ctx.save_for_backward(*qkv, *o, *(by_rank[r].lse for r in ranks))
        ctx.plan, ctx.ranks = plan, ranks
        return tuple(o)

    @staticmethod
    def backward(ctx, *do):
        plan, ranks = ctx.plan, ctx.ranks
        n, mesh = len(ranks), plan.mesh
        saved = ctx.saved_tensors
        cells = _local_cells(mesh, plan.axis_name, ranks)
        at = {r: i for i, r in enumerate(ranks)}
        with mesh.region(ranks, mesh.device(ranks[0])) as reg:
            for c in cells:
                c.qseg = c.kseg = None
                i = at.get(c.rank)
                if i is None:
                    c.q = c.k = c.v = c.o = c.lse = c.do = None
                    continue
                c.q, c.k, c.v = saved[i], saved[n + i], saved[2 * n + i]
                c.o, c.lse, c.do = saved[3 * n + i], saved[4 * n + i], do[i]
            _backward_cells(plan, cells, reg)
            grads = [None] * (3 * n)
            for c in cells:
                i = at.get(c.rank)
                if i is None:
                    continue
                with mesh.on(c.rank):
                    grads[i] = c.dq.to(saved[i].dtype)
                    grads[n + i] = c.dk_home.to(saved[n + i].dtype)
                    grads[2 * n + i] = c.dv_home.to(saved[2 * n + i].dtype)
                reg.keep(c.dq, c.dk_home, c.dv_home)
        return (None, None, *grads)


def ring_attention_local(
    q: ShardsIn,
    k: ShardsIn,
    v: ShardsIn,
    mesh: Mesh,
    axis_name: str = "sp",
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    block_sizes: Optional[BlockSizes] = None,
) -> ShardsIn:
    """Ring attention over shards that already sit on their ranks: q, k, v
    are `{rank: shard}` (q [B,H,L,d], k/v [B,Hkv,L,d] on the rank's
    device) over whole groups of `axis_name`, or lists in
    `mesh.axis_ranks(axis_name)` order for one ring. On a mesh that spans
    processes each process passes its own ranks' shards (a list holds None
    for the others') and gets theirs back. Returns each rank's
    O shard the same way, in q's dtype. Differentiable (the ring
    backward); the kernels of each step are those of `ring_attention`.

    The shards of a ring are the blocks of one sequence of L·n tokens in
    ring order; each group of the axis (every choice of the other mesh
    coordinates: batch or head shards) runs its own ring. Nothing is
    placed or gathered: this is the form a caller that keeps its
    activations on the ranks uses. A sequence that does not divide the
    axis is padded by the caller up to L·n (`ring_attention`'s rule); under
    a causal mask the pad rows sit past every real row and need no mask.
    `block_sizes` reaches every step's kernels."""
    listed = not isinstance(q, dict)
    if listed:
        ranks = mesh.local(mesh.axis_ranks(axis_name))
        q, k, v = ({r: x[i] for i, r in enumerate(mesh.axis_ranks(
            axis_name)) if r in ranks} for x in (q, k, v))
    ranks = tuple(q)
    q0, k0 = q[ranks[0]], k[ranks[0]]
    if q0.shape[1] % k0.shape[1] != 0:
        raise ValueError(f"q heads {q0.shape[1]} not a multiple of kv "
                         f"heads {k0.shape[1]}")
    window = int(window or 0)
    if window and not causal:
        raise ValueError("window requires causal=True")
    for r in ranks:
        if q[r].shape != q0.shape or k[r].shape != k0.shape \
                or v[r].shape != k0.shape:
            raise ValueError(f"rank {r}'s shards {tuple(q[r].shape)}, "
                             f"{tuple(k[r].shape)}, {tuple(v[r].shape)} "
                             f"differ from rank {ranks[0]}'s")
    plan = _RingPlan(mesh=mesh, axis_name=axis_name, batch_axis=None,
                     head_axis=None, n_shards=mesh.shape[axis_name],
                     shard_len=q0.shape[2],
                     scale=resolve_scale(scale, q0.shape[-1]),
                     causal=bool(causal), window=window, ragged=False,
                     block_sizes=block_sizes)
    out = dict(zip(ranks, RingAttentionLocal.apply(
        plan, ranks, *(q[r] for r in ranks), *(k[r] for r in ranks),
        *(v[r] for r in ranks))))
    if listed:
        return [out.get(r) for r in mesh.axis_ranks(axis_name)]
    return out


# ---------------------------------------------------------------------------
# Sharded-cache decode
# ---------------------------------------------------------------------------

Shards = Union[torch.Tensor, Sequence[torch.Tensor]]


def ring_decode_local(
    q: torch.Tensor,
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    lengths: Sequence[torch.Tensor],
    mesh: Mesh,
    axis_name: str = "sp",
    k_scale: Optional[Sequence[torch.Tensor]] = None,
    v_scale: Optional[Sequence[torch.Tensor]] = None,
    scale: Optional[float] = None,
    block_k: Optional[int] = None,
    window: int = 0,
    windows: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded-KV decode on the ranks' resident slices: `k`, `v`,
    `lengths` (LOCAL live lengths [B]), the scales and `windows` are one
    entry per rank of `axis_name`. Each rank attends its (possibly
    quantized) slice with the decode kernel; the partials are merged by
    one max / sum reduction over the ranks (the `pmax` / `psum` of the JAX
    function). No rotation: for decode the queries are tiny and the cache
    stays put. Returns (o [B,H,d] in q's dtype, lse [B,H]) on q's
    device.

    On a mesh that spans processes each process runs its own ranks'
    shards (the others' entries are not read: None will do) and the
    ranks' partials are shared with every process (`Mesh.share`), which
    merges them in rank order: every process returns the same bits."""
    ranks = mesh.axis_ranks(axis_name)
    if not (len(k) == len(v) == len(lengths) == len(ranks)):
        raise ValueError(f"{len(k)} K / {len(v)} V / {len(lengths)} length "
                         f"shards for {len(ranks)} ranks of {axis_name!r}")
    parts = {}
    with mesh.region(ranks, q.device):
        for i, rank in enumerate(ranks):
            if not mesh.is_local(rank):
                continue
            dev = mesh.device(rank)
            with mesh.on(rank):
                parts[rank] = decode_attention(
                    q.to(dev), k[i], v[i], lengths[i].to(dev),
                    k_scale=None if k_scale is None else k_scale[i],
                    v_scale=None if v_scale is None else v_scale[i],
                    scale=scale, block_k=block_k, window=window,
                    windows=None if windows is None else windows[i].to(dev))
    like_o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    like_lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    shared = []
    for rank in ranks:
        o_r, lse_r = parts.get(rank, (None, None))
        shared.append((
            mesh.share(None if o_r is None else o_r.to(q.device), rank,
                       like_o),
            mesh.share(None if lse_r is None else lse_r.to(q.device), rank,
                       like_lse)))
    o, lse = _merge_ranks(shared, q.device)
    return o.to(q.dtype), lse


def _merge_ranks(parts, device):
    """The ranks' normalised decode partials [(O, LSE), ...] merged on
    `device` by one max / sum reduction: (O fp32, before any cast; LSE)."""
    o_i = torch.stack([o.to(device).float() for o, _ in parts])
    lse_i = torch.stack([l.to(device) for _, l in parts])
    lse_max = lse_i.amax(dim=0)
    w = torch.exp(lse_i - lse_max)
    w_sum = w.sum(dim=0).clamp_min(1e-30)
    o = (o_i * w[..., None]).sum(dim=0) / w_sum[..., None]
    return o, lse_max + torch.log(w_sum)


def _shards(mesh: Mesh, axis_name: str, x: Optional[Shards], dim: int,
            local_n: int, pad_value: float) -> Optional[List[torch.Tensor]]:
    """The ranks' contiguous slices of a cache tensor along `dim`: a list
    is taken as already sharded; a global tensor is padded to the shard
    grid and cut (a copy of every shard that is not already contiguous;
    None for a rank of another process)."""
    if x is None:
        return None
    ranks = mesh.axis_ranks(axis_name)
    if not isinstance(x, torch.Tensor):
        return list(x)
    total = local_n * len(ranks)
    if x.shape[dim] != total:
        pad = [0, 0] * (x.ndim - 1 - dim) + [0, total - x.shape[dim]]
        if x.dtype == torch.float8_e4m3fn:
            x = F.pad(x.view(torch.uint8), pad).view(torch.float8_e4m3fn)
        else:
            x = F.pad(x, pad, value=pad_value)
    return [p.contiguous().to(mesh.device(r)) if mesh.is_local(r) else None
            for p, r in zip(x.chunk(len(ranks), dim=dim), ranks)]


def ring_decode(
    q: torch.Tensor,
    k: Shards,
    v: Shards,
    lengths,
    mesh: Mesh,
    axis_name: str = "sp",
    k_scale: Optional[Shards] = None,
    v_scale: Optional[Shards] = None,
    scale: Optional[float] = None,
    block_k: Optional[int] = None,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global-view sharded decode: q [B,H,d] replicated, the cache k/v
    [B,Hkv,N,d] sharded on N over `axis_name`; `lengths` is the GLOBAL
    live context, a scalar or per-sequence [B]. Each rank derives its
    local live lengths from its ring position.

    `window` > 0 attends only the last `window` GLOBAL tokens: rank i
    passes the decode kernel the per-sequence window
    W_i = my_len − (length − W) + i·L, which puts the global cut
    g ≥ length − W at its local coordinates (ranks wholly inside the
    window get W_i ≥ my_len, ranks wholly before it W_i ≤ 0 and give
    empty partials).

    The cache (and its scales) may be given as a list of the ranks'
    resident shards (`shard_on_axis`), which is what a server holds, or
    as one global tensor, which is cut here: every call then copies each
    shard that is not contiguous, and a length that does not divide the
    axis is padded first (scales with 1.0; pad rows lie past every live
    token). Divisibility and resident shards are a one-time allocation
    choice; the global form is the escape hatch."""
    ranks = mesh.axis_ranks(axis_name)
    n_shards = len(ranks)
    b = q.shape[0]
    if isinstance(k, torch.Tensor):
        local_n = cdiv(k.shape[2], n_shards)
    else:
        local_n = next(x for x in k if x is not None).shape[2]
    ks = _shards(mesh, axis_name, k, 2, local_n, 0.0)
    vs = _shards(mesh, axis_name, v, 2, local_n, 0.0)
    kss = _shards(mesh, axis_name, k_scale, 2, local_n, 1.0)
    vss = _shards(mesh, axis_name, v_scale, 2, local_n, 1.0)
    lengths = torch.as_tensor(lengths, device=q.device).to(
        torch.int32).broadcast_to((b,))
    window = int(window or 0)
    my_lens, wins = [], []
    for idx in range(n_shards):
        my_len = (lengths - idx * local_n).clamp(0, local_n)
        my_lens.append(my_len)
        if window:
            wins.append(my_len - lengths + window + idx * local_n)
    return ring_decode_local(
        q, ks, vs, my_lens, mesh, axis_name=axis_name, k_scale=kss,
        v_scale=vss, scale=scale, block_k=block_k, window=window,
        windows=wins if window else None)
