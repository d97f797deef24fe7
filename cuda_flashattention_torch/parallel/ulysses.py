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
piece of every rank along the other, on its own device and stream (a peer
copy where the ranks sit on different cards). Cutting, copying and
concatenating are differentiable, and the local attention is the
package's differentiable `flash_attention` (forward K1 / K1b / K5 as
`softmax="auto"` routes it, backward K4), so plain autograd gives the
backward. GQA: when Hkv does not divide the axis, KV heads are repeated
by the smallest factor that does; segment ids are gathered over the axis,
so every rank masks against the full sequence.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from cuda_flashattention_torch.ops.attention import flash_attention
from cuda_flashattention_torch.ops.common import cdiv, resolve_scale
from cuda_flashattention_torch.parallel.mesh import Mesh


def _all_to_all(mesh: Mesh, ranks: List[int], shards: List[torch.Tensor],
                split_dim: int, concat_dim: int) -> List[torch.Tensor]:
    """Tiled all-to-all over `ranks`: rank j receives the j-th of the
    len(ranks) pieces of every rank's shard along `split_dim` and
    concatenates them, in rank order, along `concat_dim`."""
    n = len(ranks)
    pieces = [s.chunk(n, dim=split_dim) for s in shards]
    mesh.barrier(ranks)  # every piece is produced before any is read
    out = []
    for j, rank in enumerate(ranks):
        dev = mesh.device(rank)
        with mesh.on(rank):
            out.append(torch.cat([pieces[i][j].to(dev) for i in range(n)],
                                 dim=concat_dim))
    return out


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

            def scatter(x, seq_dim):
                """The ranks' sequence shards of this batch shard."""
                placed = []
                for p, r in zip(x[b_sl].chunk(n_shards, dim=seq_dim), ranks):
                    with mesh.on(r):
                        placed.append(p.to(mesh.device(r)))
                return placed

            # [B, H, N/s, d] per rank → heads split, sequence gathered:
            # [B, H/s, N, d]
            qh = _all_to_all(mesh, ranks, scatter(q, 2), 1, 2)
            kh = _all_to_all(mesh, ranks, scatter(k, 2), 1, 2)
            vh = _all_to_all(mesh, ranks, scatter(v, 2), 1, 2)
            ids = [None] * n_shards
            if segment_ids is not None:
                # ids have no head axis to trade: every rank gathers the
                # whole sequence of ids (N ints against N·d activations)
                seg = scatter(segment_ids.to(torch.int32), 1)
                mesh.barrier(ranks)
                for j, r in enumerate(ranks):
                    with mesh.on(r):
                        ids[j] = torch.cat(
                            [s.to(mesh.device(r)) for s in seg], dim=1)
            oh = []
            for j, r in enumerate(ranks):
                with mesh.on(r):
                    oh.append(flash_attention(
                        qh[j], kh[j], vh[j], scale=scale, causal=causal,
                        window=window, block_sizes=block_sizes,
                        q_segment_ids=ids[j], kv_segment_ids=ids[j]))
            # back to sequence-sharded: split sequence, gather heads
            outs.append(_all_to_all(mesh, ranks, oh, 2, 1))
    out = torch.cat([torch.cat([o.to(q.device) for o in group], dim=2)
                     for group in outs], dim=0)
    return out[:, :, :n_orig]
