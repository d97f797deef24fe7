"""Collectives over the ranks of a mesh axis: the cross-rank sums and
concatenations that GSPMD inserts around sharded arrays in the JAX
package, written out.

Each function takes one tensor per rank, `{rank: tensor}`, over whole
groups of the axis (`Mesh.fibers`: every choice of the other coordinates
is one group, in `Mesh.axis_ranks` order) and returns the same. All
groups of one call run in one fork/join of the rank streams
(`Mesh.region`). A rank gets another rank's tensor through `Mesh.send`
(a copy on its copy stream) when the two sit on different devices; ranks
that share a device read each other's tensors in place, with only their
streams ordered, and never copy to themselves. Each call ends in a
barrier of every group's compute streams, so that no rank reuses the
memory of a tensor before the other ranks have read it.

- `all_reduce`: the sum over the group, on every rank. Partials are
  summed in fp32, in rank order, and cast back: each rank owns 1/n of the
  flattened tensor, sums it once (a reduce-scatter), and the sums are
  gathered, so every rank holds the same bits. It also takes explicit
  groups of ranks in place of an axis's groups (one rank per card, where
  ranks that share a card share one copy of what is summed).
- `all_gather`: the group's tensors concatenated on `dim`, on every rank.
- `reduce_scatter`: the sum over the group, cut on `dim`
  (`tensor_split`): rank i of the group keeps piece i.

`calls` counts the calls of each, as the kernel wrappers count their
launches.

The autograd pairs of Megatron-LM's sequence parallelism, each other's
adjoints:
- `gather_from_axis`: all-gather forward, reduce-scatter backward; before
  a column-parallel product, where the rows that the axis holds in pieces
  are needed whole.
- `reduce_scatter_to_axis`: reduce-scatter forward, all-gather backward;
  after a row-parallel product, the partials summed and left in pieces.
Together they are the all-reduce that follows a row-parallel product, in
its two halves.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import torch

from cuda_flashattention_torch.parallel.mesh import Mesh, _Region

Axes = Union[str, Sequence[str]]
Shards = Dict[int, torch.Tensor]

calls = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}


def _fetch(mesh: Mesh, reg: _Region, x: torch.Tensor, src: int,
           dst: int) -> torch.Tensor:
    """`x`, which rank `src` holds, readable on rank `dst`'s stream."""
    if mesh.device(src) != mesh.device(dst):
        reg.keep(x)
        return mesh.send(x, src, dst).wait()
    if src != dst and x.is_cuda:
        # ranks sharing a card: order the reader after the producer
        mesh.streams(dst)[0].wait_event(mesh.streams(src)[0].record_event())
        reg.keep(x)
    return x


def _collective(mesh: Mesh, axes: Axes, xs: Shards, body,
                groups=None) -> Shards:
    """Run body(reg, group) for each group of `axes` over the ranks of
    `xs` (or for each of `groups`), in one region, then a barrier per
    group; the union of the groups' {rank: result}."""
    if groups is None:
        groups = mesh.fibers(axes, list(xs))
    ranks = [r for g in groups for r in g]
    out: Shards = {}
    with mesh.region(ranks, mesh.device(ranks[0])) as reg:
        for group in groups:
            out.update(body(reg, group))
        for group in groups:
            mesh.barrier(group)
    return out


def _sum_pieces(mesh, reg, xs, group, dim):
    """Piece j of the group's sum on `dim`, on the group's j-th rank."""
    n = len(group)
    pieces = {r: xs[r].tensor_split(n, dim) for r in group}
    out = {}
    for j, dst in enumerate(group):
        with mesh.on(dst):
            acc = None
            for src in group:
                p = _fetch(mesh, reg, pieces[src][j], src, dst)
                if acc is None:
                    acc = p.to(torch.float32, copy=True)
                else:
                    acc.add_(p)
            out[dst] = acc.to(xs[dst].dtype)
    return out


def _concat(mesh, reg, xs, group, dim):
    out = {}
    for dst in group:
        with mesh.on(dst):
            out[dst] = torch.cat(
                [_fetch(mesh, reg, xs[src], src, dst) for src in group], dim)
    return out


def reduce_scatter(mesh: Mesh, axes: Axes, xs: Shards, dim: int) -> Shards:
    """Sum over each group of `axes`, cut on `dim` by `tensor_split`:
    rank i of a group gets piece i, in its inputs' dtype."""
    calls["reduce_scatter"] += 1
    return _collective(mesh, axes, xs, lambda reg, g: _sum_pieces(
        mesh, reg, xs, g, dim))


def all_gather(mesh: Mesh, axes: Axes, xs: Shards, dim: int) -> Shards:
    """Each group's tensors concatenated on `dim`, on each of its ranks."""
    calls["all_gather"] += 1
    return _collective(mesh, axes, xs, lambda reg, g: _concat(
        mesh, reg, xs, g, dim))


def all_reduce(mesh: Mesh, axes: Axes, xs: Shards, groups=None) -> Shards:
    """Sum over each group of `axes` (one axis or several), or over each of
    `groups` (lists of ranks of `xs`; `axes` is then unused), on each of
    its ranks, in the inputs' dtype; the same bits on every rank."""
    calls["all_reduce"] += 1

    def body(reg, group):
        flat = {r: xs[r].reshape(-1) for r in group}
        part = _sum_pieces(mesh, reg, flat, group, 0)
        whole = _concat(mesh, reg, part, group, 0)
        return {r: whole[r].view(xs[r].shape) for r in group}

    return _collective(mesh, axes, xs, body, groups)


# ---------------------------------------------------------------------------
# Autograd pairs
# ---------------------------------------------------------------------------

class _Pair(torch.autograd.Function):
    """forward(ctx, fwd, bwd, mesh, axes, ranks, dim, *xs): `fwd` and
    `bwd` each "all_gather" or "reduce_scatter"."""

    @staticmethod
    def forward(ctx, fwd, bwd, mesh, axes, ranks, dim, *xs):
        ctx.args = (bwd, mesh, axes, ranks, dim)
        out = _apply(fwd, mesh, axes, dict(zip(ranks, xs)), dim)
        return tuple(out[r] for r in ranks)

    @staticmethod
    def backward(ctx, *gs):
        bwd, mesh, axes, ranks, dim = ctx.args
        out = _apply(bwd, mesh, axes, dict(zip(ranks, gs)), dim)
        return (None,) * 6 + tuple(out[r] for r in ranks)


def _apply(kind: str, mesh: Mesh, axes: Axes, xs: Shards, dim) -> Shards:
    if kind == "all_gather":
        return all_gather(mesh, axes, xs, dim)
    return reduce_scatter(mesh, axes, xs, dim)


def _pair(fwd, bwd, mesh, axes, xs: Shards, dim) -> Shards:
    ranks = tuple(xs)
    out = _Pair.apply(fwd, bwd, mesh, axes, ranks, dim, *xs.values())
    return dict(zip(ranks, out))


def gather_from_axis(mesh: Mesh, axes: Axes, xs: Shards,
                     dim: int) -> Shards:
    """All-gather forward on `dim`, reduce-scatter backward."""
    return _pair("all_gather", "reduce_scatter", mesh, axes, xs, dim)


def reduce_scatter_to_axis(mesh: Mesh, axes: Axes, xs: Shards,
                           dim: int) -> Shards:
    """Reduce-scatter forward on `dim`, all-gather backward."""
    return _pair("reduce_scatter", "all_gather", mesh, axes, xs, dim)

