"""Decoder-only transformer: training (forward, loss, train step) and
serving (prefill and decode over the KV cache), attention through the
package's kernels.

Counterpart of cuda_flashattention_tpu/models/transformer.py: RMSNorm +
RoPE (split halves) + GQA attention + SwiGLU MLP, tied
embedding/unembedding. The projections, MLP and unembedding are plain
`F.linear` products. Attention is `flash_attention` (training: forward
kernel K1, backward kernel K4 or K2 + K3), `flash_attention_forward`
(prefill: K1 on the chunk itself, the bound kernels K1b or K5 on the
cached prefix) and `decode_step` (decode), over a cache that may be
quantized (`init_caches(qtype=...)`) and with a sliding window
(`TransformerConfig.window`) in all of them.

With a `mesh`, `forward`, `loss_fn` and `make_train_step` compute every
layer on the mesh's ranks, as GSPMD computes the JAX package's sharded
forward. `batch_axis` cuts the batch and `seq_axis` the sequence (into
blocks of L = ceil(T / sp) tokens, the last padded as `ring_attention`
pads); `head_axis` is Megatron tensor parallelism over the weight slices
that `param_shardings` names (wq, wk, wv, w_gate, w_up cut on their
output dim, wo and w_down on their input dim; norms and the embedding
replicated). A rank (b, t, s) holds its 1/tp of the rows of token block
(b, s) between layers: its norms, residual adds, embedding lookup and
unembedding run on those rows. Before a column-parallel product the tp
ranks gather the block's rows (all-gather; its backward a
reduce-scatter), each multiplies them by its slice, attends its heads
(`flash_attention`, or with a `seq_axis` the ring over the resident
blocks, `ring_attention_local`, RoPE at the block's global positions),
and the row-parallel partials are summed and cut back to the rank's rows
(reduce-scatter; its backward an all-gather): the all-reduce that XLA
inserts after a row-parallel product, in its two halves
(parallel/collectives.py).

On a mesh the model is the one `shard_model` placed, once, as
`jax.device_put(params, param_shardings(...))` places the JAX package's:
per device one copy of each replicated leaf and of each slice its ranks
use, shared by the ranks on that device, so that autograd sums their
gradients there and `ShardedTransformer.sync_grads` adds the devices'
copies. `gather_model` reads a placed model back whole. `pipeline_forward` runs the layer stack
as a GPipe pipeline (parallel/pipeline.py). On a mesh that spans
processes (`parallel/mesh.initialize_distributed`) each process places
and runs its own ranks, the loss adds every rank's NLL in every process,
`sync_grads` sums across processes and `gather_model` gives every
process the whole model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cuda_flashattention_torch.ops.attention import flash_attention
from cuda_flashattention_torch.ops.common import BlockSizes, cdiv
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_torch.ops.kv_cache import (
    KVCache,
    append as cache_append,
    decode_step,
    init_cache,
)
from cuda_flashattention_torch.parallel.collectives import (
    all_reduce,
    gather_from_axis,
    reduce_scatter_to_axis,
)
from cuda_flashattention_torch.parallel.mesh import Mesh
from cuda_flashattention_torch.parallel.ring import (
    combine_partials,
    ring_attention_local,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 64
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10000.0
    window: int = 0  # sliding-window size; 0 = full causal
    dtype: torch.dtype = torch.bfloat16

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """Normalise in fp32, cast to x's dtype, then scale by w in x's dtype."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding on split halves, in fp32: x [B, T, H, d],
    positions [T]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions.float()[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class Block(nn.Module):
    """One decoder block's parameters. nn.Linear keeps [out, in] weights:
    the transpose of the JAX package's [in, out] matrices."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=cfg.dtype, device=device)
        self.attn_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=cfg.dtype, device=device))
        self.wq = nn.Linear(cfg.d_model, cfg.d_q, **kw)
        self.wk = nn.Linear(cfg.d_model, cfg.d_kv, **kw)
        self.wv = nn.Linear(cfg.d_model, cfg.d_kv, **kw)
        self.wo = nn.Linear(cfg.d_q, cfg.d_model, **kw)
        self.mlp_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=cfg.dtype, device=device))
        self.w_gate = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.w_up = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.w_down = nn.Linear(cfg.d_ff, cfg.d_model, **kw)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """SwiGLU residual branch (`_mlp_block` on this block's weights)."""
        return _mlp_block(layer_weights(self), x)


class Transformer(nn.Module):
    """The model's parameters, initialised from `generator` (normal
    divided by sqrt(fan_in), as the JAX package does; norms at 1). The
    parameters live on the generator's device and are trainable; the
    serving functions run under `torch.no_grad()`."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator):
        super().__init__()
        device = generator.device
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=cfg.dtype, device=device))
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=cfg.dtype, device=device))
        self.layers = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.n_layers))
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        def dense(p: torch.Tensor, fan_in: int) -> None:
            w = torch.randn(p.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            p.copy_(w / math.sqrt(fan_in))

        dense(self.embed, self.cfg.d_model)
        for blk in self.layers:
            for lin in (blk.wq, blk.wk, blk.wv, blk.wo, blk.w_gate,
                        blk.w_up, blk.w_down):
                dense(lin.weight, lin.in_features)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and tied unembedding → fp32 logits."""
        x = rms_norm(x, self.final_norm)
        return F.linear(x, self.embed).float()


# ---------------------------------------------------------------------------
# Training: forward, loss, train step
# ---------------------------------------------------------------------------

# The per-layer weights by the JAX package's names; matrices are [out, in].
_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# Megatron split of each matrix, as the dim of the [out, in] weight that
# the tensor-parallel axis cuts: the output dim of wq/wk/wv/w_gate/w_up
# (column parallel: a rank computes its heads, its slice of the hidden
# dim), the input dim of wo/w_down (row parallel: partial outputs, summed)
_TP_DIM = dict(wq=0, wk=0, wv=0, w_gate=0, w_up=0, wo=1, w_down=1)
# every leaf of the weight tree, by name (a layer weight names one leaf
# per layer)
_LEAVES = ("embed", "final_norm") + _MATRICES + ("attn_norm", "mlp_norm")


def layer_weights(blk: Block) -> Dict[str, torch.Tensor]:
    """A block's parameters as a dict of tensors (a pytree leaf per
    weight), which the pipelined and tensor-parallel forms cut."""
    w = {name: getattr(blk, name).weight for name in _MATRICES}
    w["attn_norm"], w["mlp_norm"] = blk.attn_norm, blk.mlp_norm
    return w


def _qkv(w: Dict[str, torch.Tensor], x: torch.Tensor,
         cfg: TransformerConfig, positions: torch.Tensor):
    """Normed input → rotated q [B,H,T,d] and k/v [B,Hkv,T,d] (views)."""
    return _project_qkv(w, rms_norm(x, w["attn_norm"]), cfg, positions)


def _project_qkv(w: Dict[str, torch.Tensor], h: torch.Tensor,
                 cfg: TransformerConfig, positions: torch.Tensor):
    """h [B,T,D] → rotated q [B,H,T,d] and k/v [B,Hkv,T,d] (views); the
    head counts are the weights' (a tensor-parallel rank's slices hold
    H/tp and Hkv/tp heads)."""
    b, t, _ = h.shape
    q = F.linear(h, w["wq"]).view(b, t, -1, cfg.d_head)
    k = F.linear(h, w["wk"]).view(b, t, -1, cfg.d_head)
    v = F.linear(h, w["wv"]).view(b, t, -1, cfg.d_head)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _attention_block(w: Dict[str, torch.Tensor], x: torch.Tensor,
                     cfg: TransformerConfig, positions: torch.Tensor,
                     block_sizes: Optional[BlockSizes] = None
                     ) -> torch.Tensor:
    """x + attention(norm(x)) for one layer's weights `w`."""
    b, t, _ = x.shape
    qt, kt, vt = _qkv(w, x, cfg, positions)
    o = flash_attention(qt, kt, vt, causal=True, window=cfg.window,
                        block_sizes=block_sizes)
    o = o.transpose(1, 2).reshape(b, t, cfg.d_q)
    return x + F.linear(o, w["wo"]).to(x.dtype)


def _swiglu(w: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """SwiGLU of the normed input, in h's dtype (a tensor-parallel rank's
    partial: its slice of the hidden dim)."""
    gated = F.silu(F.linear(h, w["w_gate"]).float())
    up = F.linear(h, w["w_up"]).float()
    return F.linear((gated * up).to(h.dtype), w["w_down"])


def _mlp_block(w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x + SwiGLU(norm(x)) for one layer's weights `w` (as `Block.mlp`)."""
    return x + _swiglu(w, rms_norm(x, w["mlp_norm"])).to(x.dtype)


def forward(model, tokens: torch.Tensor, mesh: Optional[Mesh] = None,
            seq_axis: Optional[str] = None,
            batch_axis: Optional[str] = None,
            head_axis: Optional[str] = None,
            block_sizes: Optional[BlockSizes] = None) -> torch.Tensor:
    """Causal LM forward: tokens [B, T] → fp32 logits [B, T, V] on the
    tokens' device, with attention through the differentiable
    `flash_attention(causal=True)`.

    With a `mesh` and any of `seq_axis`, `batch_axis`, `head_axis`, every
    layer runs on the mesh's ranks (module docstring): `batch_axis` cuts
    B, `seq_axis` cuts T (attention by the ring over the resident blocks)
    and `head_axis` is Megatron tensor parallelism. Mesh axes that are
    not named are not used (their index-0 ranks do the work). On a mesh
    `model` is the `ShardedTransformer` that `shard_model` placed, which
    carries its mesh and axes (the keywords may repeat them); a plain
    `Transformer` with a mesh raises TypeError. Only the logits are
    gathered onto the tokens' device. `block_sizes` reaches every
    attention call, forward and backward."""
    plan = _plan_for(model, tokens, mesh, seq_axis, batch_axis, head_axis)
    if plan is None:
        return _forward_plain(model, tokens, block_sizes)
    per_rank = _forward_ranks(model, tokens, plan, lambda r, logits: logits,
                              block_sizes)
    return _assemble(plan, per_rank, tokens)


def _forward_plain(model: Transformer, tokens: torch.Tensor,
                   block_sizes: Optional[BlockSizes] = None) -> torch.Tensor:
    cfg = model.cfg
    x = model.embed[tokens].to(cfg.dtype)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for blk in model.layers:
        w = layer_weights(blk)
        x = _attention_block(w, x, cfg, positions, block_sizes)
        x = _mlp_block(w, x)
    return model.unembed(x)


def loss_fn(model, tokens: torch.Tensor, **fwd_kw) -> torch.Tensor:
    """Next-token cross entropy: targets are the tokens rolled by −1, and
    the mean NLL is taken over positions [:, :-1] (the wrapped-around last
    position is dropped), as the JAX package's `loss_fn`. `fwd_kw`
    (`mesh`, `seq_axis`, `batch_axis`, `head_axis`, `block_sizes`) go to
    `forward`.

    On a mesh the targets are made from the global tokens before they are
    cut, so the last row of a sequence block keeps its target in the next
    block; each rank sums the NLL of its rows (the global last position
    and the padding have none) and the ranks' sums are added on the
    tokens' device and divided by B · (T − 1) (across processes, every
    process adds every rank's sum, in rank order: the same loss
    everywhere, with gradients reaching its own ranks)."""
    block_sizes = fwd_kw.pop("block_sizes", None)
    plan = _plan_for(model, tokens, **fwd_kw)
    if plan is None:
        logits = _forward_plain(model, tokens, block_sizes)
        targets = torch.roll(tokens, -1, dims=1).long()
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               targets[:, :-1].reshape(-1))

    def nll_sum(rank, logits):
        targets = _rank_rows(plan, rank, tokens, shift=1)
        return F.cross_entropy(logits, targets, ignore_index=-1,
                               reduction="sum")

    per_rank = _forward_ranks(model, tokens, plan, nll_sum, block_sizes)
    b, t = tokens.shape
    like = torch.empty((), dtype=torch.float32, device=tokens.device)
    total = sum(plan.mesh.share(
        per_rank[r].to(tokens.device) if r in per_rank else None, r, like)
        for r in plan.ranks)
    return total / (b * (t - 1))


def make_train_step(model, optimizer: torch.optim.Optimizer, **fwd_kw):
    """A train step for `model`: step(tokens) zeroes the gradients, runs
    `loss_fn` and its backward, applies `optimizer` (built over
    `model.parameters()`) and returns the loss. The parameters and the
    optimizer state are updated in place, which is what the JAX version's
    buffer donation buys, so there is no `donate` option.

    For the sequence-, data- and tensor-parallel forms, `model` is the
    `ShardedTransformer` that `shard_model` placed, once, before the step
    is built, and `optimizer` is built over its parameters; `fwd_kw` may
    repeat its mesh and axes. The step sums the gradients of replicated
    leaves over their devices' copies (`sync_grads`) before the optimizer
    runs, so every copy stays equal. A plain `Transformer` with a mesh
    raises TypeError, as `forward` does."""
    sharded = isinstance(model, ShardedTransformer)
    if not sharded:
        _needs_placed(**{k: v for k, v in fwd_kw.items()
                         if k != "block_sizes"})

    def step(tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens, **fwd_kw)
        loss.backward()
        if sharded:
            model.sync_grads()
        optimizer.step()
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# The model on a mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _MeshPlan:
    """The mesh axes a model runs over; an axis left None has size 1."""
    mesh: Mesh
    batch_axis: Optional[str]
    seq_axis: Optional[str]
    head_axis: Optional[str]

    def size(self, axis: Optional[str]) -> int:
        return self.mesh.shape[axis] if axis else 1

    def index(self, rank: int, axis: Optional[str]) -> int:
        return self.mesh.coords(rank)[axis] if axis else 0

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The ranks that work: index 0 on every axis not named."""
        named = {self.batch_axis, self.seq_axis, self.head_axis}
        return tuple(r for r in range(self.mesh.size) if all(
            c == 0 for a, c in self.mesh.coords(r).items()
            if a not in named))

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The working ranks of this process."""
        return tuple(self.mesh.local(self.ranks))

    def replica_axes(self, name: str) -> Tuple[str, ...]:
        """The mesh axes over which a leaf (by its `layer_weights` name,
        or `embed` / `final_norm`) has copies: the data and sequence axes,
        and the tensor axis too for a leaf it does not cut."""
        axes = [self.batch_axis, self.seq_axis]
        if name not in _TP_DIM:
            axes.append(self.head_axis)
        return tuple(a for a in axes if a)

    def owners(self, axes: Tuple[str, ...]) -> Dict[int, int]:
        """{rank: the rank whose copy of a leaf it uses}, for a leaf with
        copies over `axes`: the first rank on its device (of its process)
        among the ranks that differ from it only on `axes`."""
        out = {}
        for fiber in self.mesh.fibers(axes, self.ranks):
            first: Dict[Any, int] = {}
            for r in fiber:
                out[r] = first.setdefault(self.mesh.place(r), r)
        return out


def _make_plan(cfg: TransformerConfig, mesh: Mesh, batch_axis, seq_axis,
               head_axis) -> _MeshPlan:
    axes = [a for a in (batch_axis, seq_axis, head_axis) if a]
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} repeat")
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"mesh has no axis {a!r} "
                             f"(axes {mesh.axis_names})")
    plan = _MeshPlan(mesh, batch_axis, seq_axis, head_axis)
    tp = plan.size(head_axis)
    for what, n in (("q heads", cfg.n_heads), ("kv heads", cfg.n_kv_heads),
                    ("d_ff", cfg.d_ff)):
        if n % tp:
            raise ValueError(f"{what} {n} does not divide over the {tp} "
                             f"ranks of {head_axis!r}")
    return plan


def _needs_placed(mesh: Optional[Mesh] = None, seq_axis=None,
                  batch_axis=None, head_axis=None) -> None:
    """Raise when a plain `Transformer` is given a mesh to run on."""
    if mesh is not None and (seq_axis or batch_axis or head_axis):
        raise TypeError("on a mesh the model is the one shard_model placed "
                        "(and a train step's optimizer is over its "
                        "parameters)")


def _plan_for(model, tokens: torch.Tensor, mesh: Optional[Mesh] = None,
              seq_axis: Optional[str] = None,
              batch_axis: Optional[str] = None,
              head_axis: Optional[str] = None) -> Optional[_MeshPlan]:
    """The plan a call runs under: the placed model's; None for the model
    without a mesh."""
    if not isinstance(model, ShardedTransformer):
        _needs_placed(mesh, seq_axis, batch_axis, head_axis)
        return None
    plan = model.plan
    given = dict(mesh=mesh, seq_axis=seq_axis, batch_axis=batch_axis,
                 head_axis=head_axis)
    for name, value in given.items():
        if value is not None and value != getattr(plan, name):
            raise ValueError(f"{name}={value!r}: the model was placed "
                             f"with {getattr(plan, name)!r}")
    dp = plan.size(plan.batch_axis)
    if tokens.shape[0] % dp:
        raise ValueError(f"batch {tokens.shape[0]} does not divide over the "
                         f"{dp} ranks of {plan.batch_axis!r}")
    return plan


def _block_len(plan: _MeshPlan, t: int) -> int:
    """L: the tokens of one sequence block (the ring's padding rule)."""
    return cdiv(t, plan.size(plan.seq_axis))


def _rank_rows(plan: _MeshPlan, rank: int, tokens: torch.Tensor,
               shift: int = 0) -> torch.Tensor:
    """The rank's rows of `tokens` (shifted left by `shift`: targets, −1
    where there is none), flat, on the rank's device: its 1/tp piece of
    the [B/dp, L] block (b, s), padding past T included."""
    b, t = tokens.shape
    n_b, ell = b // plan.size(plan.batch_axis), _block_len(plan, t)
    bi, si = (plan.index(rank, plan.batch_axis),
              plan.index(rank, plan.seq_axis))
    dev = plan.mesh.device(rank)
    pos = si * ell + shift + torch.arange(ell, device=dev)
    block = tokens[bi * n_b:(bi + 1) * n_b].to(dev)[:, pos.clamp(max=t - 1)]
    block = torch.where(pos < t, block, -1 if shift else 0).long()
    return block.reshape(-1).tensor_split(
        plan.size(plan.head_axis))[plan.index(rank, plan.head_axis)]


def _gather_rows(plan: _MeshPlan, xs):
    """Each rank's rows → the whole block on each tp rank."""
    if plan.size(plan.head_axis) == 1:
        return xs
    return gather_from_axis(plan.mesh, plan.head_axis, xs, 0)


def _scatter_rows(plan: _MeshPlan, xs):
    """The tp ranks' partials of a block → the sum of each rank's rows."""
    if plan.size(plan.head_axis) == 1:
        return xs
    return reduce_scatter_to_axis(plan.mesh, plan.head_axis, xs, 0)


def _forward_ranks(model, tokens: torch.Tensor, plan: _MeshPlan, head,
                   block_sizes: Optional[BlockSizes] = None
                   ) -> Dict[int, torch.Tensor]:
    """Every layer on this process's ranks: {rank: head(rank, fp32 logits
    of the rank's rows)}, computed on the rank's stream."""
    cfg, mesh = model.cfg, plan.mesh
    ranks = plan.local_ranks
    b, t = tokens.shape
    n_b, ell = b // plan.size(plan.batch_axis), _block_len(plan, t)
    out = {}
    w = model.weights()
    with mesh.region(ranks, tokens.device):
        x, pos = {}, {}
        for r in ranks:
            with mesh.on(r):
                x[r] = w[r]["embed"][_rank_rows(plan, r, tokens)].to(
                    cfg.dtype)
                pos[r] = plan.index(r, plan.seq_axis) * ell + torch.arange(
                    ell, device=mesh.device(r))
        for i in range(cfg.n_layers):
            lw = {r: w[r]["layers"][i] for r in ranks}
            h = {}
            for r in ranks:
                with mesh.on(r):
                    h[r] = rms_norm(x[r], lw[r]["attn_norm"])
            h = _gather_rows(plan, h)
            q, k, v = {}, {}, {}
            for r in ranks:
                with mesh.on(r):
                    q[r], k[r], v[r] = _project_qkv(
                        lw[r], h[r].view(n_b, ell, -1), cfg, pos[r])
            if plan.seq_axis:
                o = ring_attention_local(q, k, v, mesh, plan.seq_axis,
                                         causal=True, window=cfg.window,
                                         block_sizes=block_sizes)
            else:
                o = {}
                for r in ranks:
                    with mesh.on(r):
                        o[r] = flash_attention(q[r], k[r], v[r], causal=True,
                                               window=cfg.window,
                                               block_sizes=block_sizes)
            part = {}
            for r in ranks:
                with mesh.on(r):
                    part[r] = F.linear(o[r].transpose(1, 2).reshape(
                        n_b * ell, -1), lw[r]["wo"])
            y = _scatter_rows(plan, part)
            for r in ranks:
                with mesh.on(r):
                    x[r] = x[r] + y[r].to(x[r].dtype)
                    h[r] = rms_norm(x[r], lw[r]["mlp_norm"])
            h = _gather_rows(plan, h)
            for r in ranks:
                with mesh.on(r):
                    part[r] = _swiglu(lw[r], h[r])
            y = _scatter_rows(plan, part)
            for r in ranks:
                with mesh.on(r):
                    x[r] = x[r] + y[r].to(x[r].dtype)
        for r in ranks:
            with mesh.on(r):
                hf = rms_norm(x[r], w[r]["final_norm"])
                out[r] = head(r, F.linear(hf, w[r]["embed"]).float())
    return out


def _assemble(plan: _MeshPlan, per_rank: Dict[int, torch.Tensor],
              tokens: torch.Tensor) -> torch.Tensor:
    """The ranks' logits rows → [B, T, V] on the tokens' device (every
    process gathers every rank's, `Mesh.share`)."""
    b, t = tokens.shape
    n_b, ell = b // plan.size(plan.batch_axis), _block_len(plan, t)
    dev = tokens.device
    vocab = next(iter(per_rank.values())).shape[-1]
    blocks = {}
    for r in plan.ranks:
        key = (plan.index(r, plan.batch_axis), plan.index(r, plan.seq_axis))
        # the rank's piece of the block's n_b · L rows (`_rank_rows`)
        rows = torch.empty(n_b * ell, device="meta").tensor_split(
            plan.size(plan.head_axis))[plan.index(r, plan.head_axis)]
        like = torch.empty((rows.numel(), vocab), dtype=torch.float32,
                           device=dev)
        blocks.setdefault(key, []).append(plan.mesh.share(
            per_rank[r].to(dev) if r in per_rank else None, r, like))
    rows = [torch.cat([torch.cat(blocks[(bi, si)]).view(n_b, ell, -1)
                       for si in range(plan.size(plan.seq_axis))], dim=1)
            for bi in range(plan.size(plan.batch_axis))]
    return torch.cat(rows)[:, :t]


def _weight_tree(model: Transformer) -> Dict[str, Any]:
    return dict(embed=model.embed, final_norm=model.final_norm,
                layers=[layer_weights(blk) for blk in model.layers])


class _RankParams(nn.Module):
    """One rank's parameters: its copies of the replicated leaves and its
    slices of the tensor-parallel matrices (shared with the ranks on its
    device that use the same)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.embed = tree["embed"]
        self.final_norm = tree["final_norm"]
        self.layers = nn.ModuleList(nn.ParameterDict(lw)
                                    for lw in tree["layers"])


class ShardedTransformer(nn.Module):
    """A `Transformer` placed on a mesh (`shard_model`): per rank of this
    process, its slices and copies as `nn.Parameter`s on the rank's
    device, kept there between steps; ranks on one device share them
    (`parameters()` yields each once). On a card the ranks' streams then
    add into one gradient: autograd orders each add after the stream that
    produced it, and PyTorch warns once that the streams differ. `forward`, `loss_fn` and
    `make_train_step` run it on its ranks; `gather_model` reads it back
    whole."""

    def __init__(self, cfg: TransformerConfig, plan: _MeshPlan,
                 trees: Dict[int, Any]):
        super().__init__()
        self.cfg, self.plan = cfg, plan
        self.ranks = nn.ModuleDict({str(r): _RankParams(tree)
                                    for r, tree in trees.items()})

    def weights(self) -> Dict[int, Any]:
        """{rank: weight tree} (`embed`, `final_norm`, `layers`)."""
        return {int(r): dict(embed=m.embed, final_norm=m.final_norm,
                             layers=[dict(lw) for lw in m.layers])
                for r, m in self.ranks.items()}

    @torch.no_grad()
    def sync_grads(self) -> None:
        """Sum the gradients of every replicated leaf over its devices'
        copies (autograd has summed those of the ranks that share a copy):
        over the data and sequence axes for all leaves, over the tensor
        axis too for the norms and the embedding. One `all_reduce` per
        group of leaves that share their replica axes, on their flattened
        gradients, over one rank per device (and process); none where each
        group of replicas sits on one device. A missing gradient counts as
        zeros."""
        plan, w = self.plan, self.weights()
        buckets: Dict[Tuple[str, ...], list] = {}
        for name in _LEAVES:
            axes = plan.replica_axes(name)
            if axes:
                buckets.setdefault(axes, []).append(name)
        for axes, members in buckets.items():
            owners = plan.owners(axes)
            groups = [g for g in (sorted({owners[r] for r in fiber})
                                  for fiber in plan.mesh.fibers(
                                      axes, plan.ranks)) if len(g) > 1]
            if not groups:
                continue
            params = {r: [p for name in members for p in _leaves(w[r], name)]
                      for g in groups for r in plan.mesh.local(g)}
            flat = {}
            for r, ps in params.items():
                with plan.mesh.on(r):
                    flat[r] = torch.cat([
                        (p.grad if p.grad is not None
                         else torch.zeros_like(p)).reshape(-1) for p in ps])
            summed = all_reduce(plan.mesh, axes, flat, groups=groups)
            for r, ps in params.items():
                off = 0
                for p in ps:
                    p.grad = summed[r][off:off + p.numel()].view_as(p)
                    off += p.numel()


def _leaves(tree: Dict[str, Any], name: str):
    """The leaves of a weight tree under `name`: one per layer for a
    layer weight."""
    if name in ("embed", "final_norm"):
        return [tree[name]]
    return [lw[name] for lw in tree["layers"]]


def shard_model(model: Transformer, mesh: Mesh,
                batch_axis: Optional[str] = None,
                seq_axis: Optional[str] = None,
                head_axis: Optional[str] = None) -> ShardedTransformer:
    """Place `model` on `mesh`, once: the counterpart of
    `jax.device_put(params, param_shardings(...))`. Each working rank
    (index 0 on the axes not named) of this process gets `shard_param`'s
    slice of every matrix under `head_axis` and a copy of every replicated
    leaf, as new `nn.Parameter`s on its device (every process holds the
    whole `model`, made from the same seed, and places its own ranks).
    Ranks that share a device use one parameter for one slice or copy
    (`_MeshPlan.owners`), as a device holds one copy of a replicated JAX
    array. `model` is left as it was.
    Build the optimizer over the result's parameters."""
    plan = _make_plan(model.cfg, mesh, batch_axis, seq_axis, head_axis)
    specs = param_shardings(model, mesh, head_axis=head_axis)

    def place(w, spec, name):
        slices = shard_param(w.detach(), spec, mesh)
        owners = plan.owners(plan.replica_axes(name))
        made = {o: nn.Parameter(slices[o].clone(
            memory_format=torch.contiguous_format))
            for o in {owners[r] for r in plan.local_ranks}}
        return {r: made[owners[r]] for r in plan.local_ranks}

    tree = _weight_tree(model)
    embed = place(tree["embed"], specs["embed"], "embed")
    final = place(tree["final_norm"], specs["final_norm"], "final_norm")
    layers = [{n: place(w, spec[n], n) for n, w in lw.items()}
              for lw, spec in zip(tree["layers"], specs["layers"])]
    trees = {r: dict(embed=embed[r], final_norm=final[r],
                     layers=[{n: c[r] for n, c in lw.items()}
                             for lw in layers])
             for r in plan.local_ranks}
    return ShardedTransformer(model.cfg, plan, trees)


@torch.no_grad()
def gather_model(model: ShardedTransformer, device=None) -> Transformer:
    """The placed model read back whole, as a `Transformer` on `device`
    (default: the first rank's): each tensor-parallel matrix concatenated
    from its slices, each replicated leaf from the first rank's copy, and
    likewise their gradients where every piece has one (after
    `sync_grads`, which sums those of the replicated leaves over their
    devices). Across processes every process gets the whole model: each
    piece comes from the process of its rank (`Mesh.share`)."""
    plan = model.plan
    mesh, first = plan.mesh, plan.ranks[0]
    dev = torch.device(device) if device is not None else mesh.home
    tp_ranks = (mesh.axis_ranks(plan.head_axis, **mesh.coords(first))
                if plan.head_axis else [first])
    w = model.weights()
    out = Transformer(model.cfg, torch.Generator(device=dev))
    for name in _LEAVES:
        dst = _leaves(_weight_tree(out), name)
        ranks = tp_ranks if name in _TP_DIM else tp_ranks[:1]
        dim = _TP_DIM.get(name, 0)
        pieces = {r: _leaves(w[r], name) for r in mesh.local(ranks)}
        for i, p in enumerate(dst):
            parts, grads = [], []
            for r, like in zip(ranks, p.chunk(len(ranks), dim)):
                x = pieces[r][i] if r in pieces else None
                parts.append(mesh.share(
                    None if x is None else x.detach().to(dev), r, like))
                has = mesh.share(None if x is None else torch.tensor(
                    [x.grad is not None], device=dev), r,
                    torch.empty(1, dtype=torch.bool, device=dev))
                grads.append(mesh.share(
                    None if x is None else x.grad.to(dev), r, like)
                    if has.item() else None)
            p.copy_(torch.cat(parts, dim))
            if all(g is not None for g in grads):
                p.grad = torch.cat(grads, dim)
    return out


def pipeline_forward(model: Transformer, tokens: torch.Tensor, mesh: Mesh,
                     n_micro: int, pp_axis: str = "pp",
                     batch_axis: Optional[str] = None,
                     stacked: Any = None) -> torch.Tensor:
    """Causal LM forward with the layer stack run as a GPipe pipeline over
    `pp_axis` (parallel/pipeline.py): stage s holds layers
    [s·L/S, (s+1)·L/S); embedding and unembedding stay on the model's
    device. Equals `forward`; composes with a data-parallel `batch_axis`.

    `stacked` is the layers' stacked pytree (`stack_stage_params` over
    `layer_weights`), or the per-stage list `stage_param_sharding` makes
    of it: a training loop stacks once and passes it through; without it
    the layers are stacked on every call."""
    from cuda_flashattention_torch.parallel.pipeline import (
        gpipe_spmd, stack_stage_params, tree_leaves, tree_map)

    cfg = model.cfg
    x = model.embed[tokens].to(cfg.dtype)
    t = tokens.shape[1]
    if stacked is None:
        stacked = stack_stage_params(
            [layer_weights(blk) for blk in model.layers])

    def stage_fn(stage_layers, x):
        positions = torch.arange(t, device=x.device)
        for i in range(tree_leaves(stage_layers)[0].shape[0]):
            w = tree_map(lambda a: a[i], stage_layers)
            x = _attention_block(w, x, cfg, positions)
            x = _mlp_block(w, x)
        return x

    x = gpipe_spmd(stage_fn, stacked, x, mesh, n_micro=n_micro,
                   axis_name=pp_axis, batch_axis=batch_axis)
    return model.unembed(x)


def param_shardings(model: Transformer, mesh: Mesh, batch_axis: str = "dp",
                    head_axis: Optional[str] = None) -> Dict[str, Any]:
    """Parameter shardings, as a pytree shaped like the JAX package's
    parameters (`embed`, `final_norm`, `layers`: one dict per layer), each
    leaf a tuple with one entry per dim of the torch tensor: a mesh axis
    name where that dim is cut over the axis, else None.

    Without `head_axis` everything is replicated (the data-parallel
    baseline). With it: Megatron tensor parallelism. The matrices here are
    nn.Linear's [out, in], the transpose of the JAX package's [in, out]:
    wq, wk, wv, w_gate, w_up are cut on their output dim (dim 0), wo and
    w_down on their input dim (dim 1), so each tensor-parallel rank holds
    1/tp of every layer's matrices. `shard_param` cuts a tensor by its
    leaf; `shard_model` places every leaf's slices on their ranks, and
    `forward` computes each rank's products from them."""
    def spec(name: str, ndim: int):
        dims = [None] * ndim
        if head_axis is not None and name in _TP_DIM:
            dims[_TP_DIM[name]] = head_axis
        return tuple(dims)

    return dict(
        embed=(None, None), final_norm=(None,),
        layers=[{name: spec(name, w.ndim)
                 for name, w in layer_weights(blk).items()}
                for blk in model.layers])


def shard_param(w: torch.Tensor, spec: Tuple[Optional[str], ...],
                mesh: Mesh) -> Dict[int, torch.Tensor]:
    """The slice of `w` that each rank of the mesh in this process holds
    under `spec` (a leaf of `param_shardings`): {rank: slice, on the
    rank's device}. The slices are views of `w` where a rank shares its
    device, copies otherwise (`shard_model` copies them into the placed
    parameters)."""
    out = {}
    for rank in mesh.local(range(mesh.size)):
        coords = mesh.coords(rank)
        piece = w
        for dim, axis in enumerate(spec):
            if axis is not None:
                piece = piece.chunk(mesh.shape[axis], dim=dim)[coords[axis]]
        out[rank] = piece.to(mesh.device(rank))
    return out


# ---------------------------------------------------------------------------
# Inference: prefill + decode over the KV cache
# ---------------------------------------------------------------------------

def init_caches(cfg: TransformerConfig, batch: int, max_len: int,
                qtype: Optional[str] = None,
                device=None) -> Tuple[KVCache, ...]:
    """One empty cache per layer; `qtype` None, "int8", "fp8" or "mixed"
    selects the storage. `device=None` means the card and raises without
    one; the caches must live where the model does."""
    return tuple(
        init_cache(batch, cfg.n_kv_heads, max_len, cfg.d_head, qtype=qtype,
                   dtype=cfg.dtype, device=device)
        for _ in range(cfg.n_layers))


def prefill(model: Transformer, tokens: torch.Tensor,
            caches: Tuple[KVCache, ...],
            block_sizes: Optional[BlockSizes] = None):
    """Run the prompt through the model, filling the caches (in place).
    Returns (logits_last [B, V] fp32, caches)."""
    return prefill_chunk(model, tokens, 0, caches, block_sizes=block_sizes)


@torch.no_grad()
def prefill_chunk(model: Transformer, tokens: torch.Tensor, start: int,
                  caches: Tuple[KVCache, ...],
                  block_sizes: Optional[BlockSizes] = None):
    """Prefill one chunk of C tokens starting at position `start`: the
    chunk attends itself causally (with the model's window, if any) and,
    when start > 0, the cached prefix, read in its storage type with the
    dequantisation folded into the kernel when the cache is quantized; the
    two partials merge in log space (combine_partials). Returns
    (logits_last [B, V], caches).

    Without a window the whole prefix [0, start) is visible
    (causal=False). With one, only keys in (g − W, start) matter to global
    row g: the cache is sliced to [lo, start), lo = max(0, start − W), and
    the band is causal + window with kv_offset = start − lo (every prefix
    column is causally visible; the window cut is the kernel's mask). Rows
    whose window misses the prefix come back with LSE = NEG_INF and drop
    out of the combine. `block_sizes` reaches both forward calls."""
    cfg = model.cfg
    b, c = tokens.shape
    x = model.embed[tokens].to(cfg.dtype)
    positions = torch.arange(start, start + c, device=x.device)
    for blk, cache in zip(model.layers, caches):
        qt, kt, vt = _qkv(layer_weights(blk), x, cfg, positions)
        cache_append(cache, kt, vt)
        o_new, lse_new = flash_attention_forward(
            qt, kt, vt, causal=True, window=cfg.window,
            block_sizes=block_sizes, out_dtype=torch.float32)
        if start > 0:
            lo = max(0, start - cfg.window) if cfg.window else 0
            ks = cache.k_scale[:, :, lo:start] if cache.quantized else None
            vs = cache.v_scale[:, :, lo:start] if cache.quantized else None
            o_old, lse_old = flash_attention_forward(
                qt, cache.k[:, :, lo:start], cache.v[:, :, lo:start],
                k_scale=ks, v_scale=vs, causal=bool(cfg.window),
                window=cfg.window, kv_offset=start - lo,
                block_sizes=block_sizes, out_dtype=torch.float32)
            o_c, _ = combine_partials(o_old, lse_old, o_new, lse_new)
        else:
            o_c = o_new
        o = o_c.to(cfg.dtype).transpose(1, 2).reshape(b, c, cfg.d_q)
        x = x + blk.wo(o).to(x.dtype)
        x = blk.mlp(x)
    return model.unembed(x[:, -1]), caches


def prefill_chunked(model: Transformer, tokens: torch.Tensor,
                    caches: Tuple[KVCache, ...], chunk: int,
                    block_sizes: Optional[BlockSizes] = None):
    """Prefill a long prompt in chunks of `chunk` tokens (the last may be
    shorter). Equivalent to `prefill`, with memory bounded by the chunk."""
    logits = None
    for s in range(0, tokens.shape[1], chunk):
        logits, caches = prefill_chunk(model, tokens[:, s:s + chunk], s,
                                       caches, block_sizes=block_sizes)
    return logits, caches


@torch.no_grad()
def decode_one(model: Transformer, token: torch.Tensor, position: int,
               caches: Tuple[KVCache, ...], quantize_q: bool = False,
               block_k: Optional[int] = None):
    """One autoregressive step: token [B] → (logits [B, V], caches). The
    token's K/V are appended before attention, so it attends to itself.
    Attention reads the (possibly quantized) caches through the decode
    kernel; `quantize_q` runs its Q·Kᵀ as an integer dot on int8-K
    caches; `block_k` is the decode kernel's split size (`decode_step`;
    the JAX function has none)."""
    cfg = model.cfg
    b = token.shape[0]
    x = model.embed[token].to(cfg.dtype)[:, None, :]  # [B, 1, D]
    positions = torch.full((1,), position, device=x.device)
    for blk, cache in zip(model.layers, caches):
        qt, kt, vt = _qkv(layer_weights(blk), x, cfg, positions)
        cache_append(cache, kt, vt)
        o, _ = decode_step(qt[:, :, 0], cache, block_k=block_k,
                           window=cfg.window, quantize_q=quantize_q)
        x = x + blk.wo(o.reshape(b, 1, cfg.d_q)).to(x.dtype)
        x = blk.mlp(x)
    return model.unembed(x[:, 0]), caches

