"""Ulysses-style sequence parallelism: an all-to-all over heads.

Counterpart of cuda_flashattention_tpu/parallel/ulysses.py (DeepSpeed-
Ulysses, arXiv 2309.14509), the alternative to the ring:

  ring:    K/V shards rotate; n steps of compute + copy, overlappable.
  ulysses: ONE all-to-all re-shards activations from sequence-sharded
           [B, H, N/s, d] to head-sharded [B, H/s, N, d], each rank runs
           plain local attention over the FULL sequence for its heads,
           and one all-to-all converts back. Needs H % s == 0.

The all-to-all is written out as the re-shuffle it is: every rank cuts
its shard into s pieces along one dim and rank j concatenates the j-th
piece of every rank along the other, on its own device and stream (read
in place on a shared card, a peer copy across cards, a `Mesh.send` pair
across processes). It is one `torch.autograd.Function` whose backward is
the all-to-all back, and the local attention is the package's
differentiable `flash_attention` (forward K1 / K1b / K5 as
`softmax="auto"` routes it, backward K4), so autograd gives the backward
(across processes too: each process's graph walks the same nodes in the
same order). GQA: when Hkv does not divide the axis, KV heads are repeated
by the smallest factor that does; segment ids are gathered over the axis,
so every rank masks against the full sequence.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from cuda_flashattention_torch.ops.attention import flash_attention
from cuda_flashattention_torch.ops.common import cdiv, resolve_scale
from cuda_flashattention_torch.parallel.collectives import _collective, _fetch
from cuda_flashattention_torch.parallel.mesh import Mesh


def _exchange(mesh: Mesh, ranks: List[int], xs: Dict[int, torch.Tensor],
              split_dim: int, concat_dim: int) -> Dict[int, torch.Tensor]:
    """Tiled all-to-all over `ranks`: rank j receives the j-th of the
    len(ranks) pieces of every rank's shard along `split_dim` and
    concatenates them, in rank order, along `concat_dim`. `xs` holds this
    process's ranks' shards, all of one shape; so does the result."""
    n = len(ranks)
    pieces = {r: x.chunk(n, dim=split_dim) for r, x in xs.items()}
    likes = next(iter(xs.values())).chunk(n, dim=split_dim)

    def body(reg, group):
        out = {}
        for j, dst in enumerate(group):
            parts = [_fetch(mesh, reg, pieces[src][j] if src in pieces
                            else None, src, dst, likes[j]) for src in group]
            if mesh.is_local(dst):
                with mesh.on(dst):
                    out[dst] = torch.cat(parts, dim=concat_dim)
        return out

    return _collective(mesh, None, xs, body, groups=[list(ranks)])


class _AllToAll(torch.autograd.Function):
    """forward(ctx, mesh, ranks, split_dim, concat_dim, *xs), one shard
    per rank of this process in `mesh.local(ranks)` order; the backward
    is the all-to-all back (the two dims swapped)."""

    @staticmethod
    def forward(ctx, mesh, ranks, split_dim, concat_dim, *xs):
        ctx.args = (mesh, ranks, split_dim, concat_dim)
        mine = mesh.local(ranks)
        out = _exchange(mesh, ranks, dict(zip(mine, xs)), split_dim,
                        concat_dim)
        return tuple(out[r] for r in mine)

    @staticmethod
    def backward(ctx, *gs):
        mesh, ranks, split_dim, concat_dim = ctx.args
        mine = mesh.local(ranks)
        gs = {r: g for r, g in zip(mine, gs)}
        out = _exchange(mesh, ranks, gs, concat_dim, split_dim)
        return (None,) * 4 + tuple(out[r] for r in mine)


class _OwnedGrad(torch.autograd.Function):
    """Identity forward on a global tensor whose pieces along `dim` go to
    `ranks`, one each; backward: each piece's gradient from the process
    of the rank that used it (`Mesh.share`), so that every process
    returns the whole gradient, as it holds the whole input."""

    @staticmethod
    def forward(ctx, mesh, ranks, dim, x):
        ctx.args = (mesh, ranks, dim)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, ranks, dim = ctx.args
        pieces = g.chunk(len(ranks), dim)
        return (None,) * 3 + (torch.cat([
            mesh.share(p if mesh.is_local(r) else None, r, p)
            for p, r in zip(pieces, ranks)], dim),)


def _all_to_all(mesh: Mesh, ranks: List[int],
                shards: List[Optional[torch.Tensor]], split_dim: int,
                concat_dim: int) -> List[Optional[torch.Tensor]]:
    """`_exchange` over the shards of `ranks` (None for the ranks of other
    processes), differentiable; the result in the same form."""
    mine = mesh.local(ranks)
    out = dict(zip(mine, _AllToAll.apply(
        mesh, tuple(ranks), split_dim, concat_dim,
        *(s for s, r in zip(shards, ranks) if r in mine))))
    return [out.get(r) for r in ranks]


def ulysses_attention(
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
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequence-parallel attention through a head all-to-all: q [B,H,N,d],
    k/v [B,Hkv,N,d] sharded on N over `axis_name` → O [B,H,N,d] on q's
    device. Differentiable end to end.

    The q-head count must divide the axis. GQA: when Hkv does not, KV
    heads are repeated by the smallest factor that does (Hkv=2 on 8 ranks
    → 4×); the repetition must divide the GQA group so that query heads
    still land with their KV head. A sequence length that does not divide
    the axis is padded: causal needs no mask, non-causal marks the pad
    rows with segment id −1. `segment_ids` [B, N] (integer) masks packed
    sequences."""
    n_shards = mesh.shape[axis_name]
    b, h, n, d = q.shape
    h_kv = k.shape[1]
    if h % n_shards:
        raise ValueError(
            f"ulysses needs q heads {h} divisible by the "
            f"'{axis_name}' axis ({n_shards}); use the ring otherwise")
    n_orig = n
    if n % n_shards:
        n = cdiv(n, n_shards) * n_shards
        pad = (0, 0, 0, n - n_orig)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
        if segment_ids is None and not causal:
            segment_ids = torch.zeros((b, n_orig), dtype=torch.int32,
                                      device=q.device)
        if segment_ids is not None:
            segment_ids = F.pad(segment_ids.to(torch.int32),
                                (0, n - n_orig), value=-1)
    if h_kv % n_shards:
        # head-replication fallback: repeat each KV head `rep` times so
        # that the total shards evenly; the query-head grouping survives
        # iff rep divides the GQA group
        rep = n_shards // math.gcd(h_kv, n_shards)
        if (h // h_kv) % rep:
            raise ValueError(
                f"kv heads {h_kv} don't divide the axis ({n_shards}) and "
                f"the needed replication {rep} doesn't divide the GQA "
                f"group {h // h_kv}; use the ring")
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = resolve_scale(scale, d)
    nb = mesh.shape[batch_axis] if batch_axis else 1
    if b % nb:
        raise ValueError(f"batch {b} does not divide over the {nb} ranks "
                         f"of {batch_axis!r}")
    groups = [mesh.axis_ranks(axis_name, **({batch_axis: bi}
                                            if batch_axis else {}))
              for bi in range(nb)]
    outs = []
    with mesh.region([r for g in groups for r in g], q.device):
        for bi, ranks in enumerate(groups):
            b_sl = slice(bi * (b // nb), (bi + 1) * (b // nb))
            mine = mesh.local(ranks)

            def scatter(x, seq_dim):
                """The ranks' sequence shards of this batch shard (None
                for another process's rank)."""
                placed, x = [], x[b_sl]
                if mesh.spans_processes:
                    x = _OwnedGrad.apply(mesh, tuple(ranks), seq_dim, x)
                for p, r in zip(x.chunk(n_shards, dim=seq_dim), ranks):
                    placed.append(None)
                    if r in mine:
                        with mesh.on(r):
                            placed[-1] = p.to(mesh.device(r))
                return placed

            # [B, H, N/s, d] per rank → heads split, sequence gathered:
            # [B, H/s, N, d]
            qh = _all_to_all(mesh, ranks, scatter(q, 2), 1, 2)
            kh = _all_to_all(mesh, ranks, scatter(k, 2), 1, 2)
            vh = _all_to_all(mesh, ranks, scatter(v, 2), 1, 2)
            ids = [None] * n_shards
            if segment_ids is not None:
                # ids have no head axis to trade: every rank takes the
                # whole sequence of ids (N ints against N·d activations),
                # which every process holds
                seg = segment_ids[b_sl].to(torch.int32)
                for j, r in enumerate(ranks):
                    if r in mine:
                        with mesh.on(r):
                            ids[j] = seg.to(mesh.device(r))
            oh = [None] * n_shards
            for j, r in enumerate(ranks):
                if r in mine:
                    with mesh.on(r):
                        oh[j] = flash_attention(
                            qh[j], kh[j], vh[j], scale=scale, causal=causal,
                            window=window, block_sizes=block_sizes,
                            q_segment_ids=ids[j], kv_segment_ids=ids[j])
            # back to sequence-sharded: split sequence, gather heads
            outs.append((ranks, _all_to_all(mesh, ranks, oh, 2, 1)))
    # every process gathers every rank's O (`Mesh.share`: its own stay in
    # the graph, so gradients reach them)
    like = torch.empty((b // nb, h, n // n_shards, d), dtype=q.dtype,
                       device=q.device)
    out = torch.cat([torch.cat([
        mesh.share(None if o is None else o.to(q.device), r, like)
        for r, o in zip(ranks, group)], dim=2) for ranks, group in outs],
        dim=0)
    return out[:, :, :n_orig]
