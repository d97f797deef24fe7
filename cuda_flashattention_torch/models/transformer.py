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

With a `mesh` and a `seq_axis`, `forward`, `loss_fn` and `make_train_step`
run attention sequence-parallel (`ring_attention`, parallel/ring.py);
`batch_axis` and `head_axis` shard its batch and heads over further mesh
axes. The token-local layers (norms, projections, MLP) run where the
model's parameters live, as plain `F.linear` products: `head_axis` shards
the ring's heads and nothing else. `param_shardings` states the Megatron
tensor-parallel layout of the matrices (wq, wk, wv, w_gate and w_up split
on their output dimension, wo and w_down on their input dimension) and
`shard_param` cuts a tensor by it; the projections do not compute from
those slices yet. `pipeline_forward` runs the layer stack as a GPipe
pipeline (parallel/pipeline.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cuda_flashattention_torch.ops.attention import flash_attention
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_torch.ops.kv_cache import (
    KVCache,
    append as cache_append,
    decode_step,
    init_cache,
)
from cuda_flashattention_torch.parallel.mesh import Mesh
from cuda_flashattention_torch.parallel.ring import (
    combine_partials,
    ring_attention,
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


def layer_weights(blk: Block) -> Dict[str, torch.Tensor]:
    """A block's parameters as a dict of tensors (a pytree leaf per
    weight), which the pipelined and tensor-parallel forms cut."""
    w = {name: getattr(blk, name).weight for name in _MATRICES}
    w["attn_norm"], w["mlp_norm"] = blk.attn_norm, blk.mlp_norm
    return w


def _qkv(w: Dict[str, torch.Tensor], x: torch.Tensor,
         cfg: TransformerConfig, positions: torch.Tensor):
    """Normed input → rotated q [B,H,T,d] and k/v [B,Hkv,T,d] (views)."""
    b, t, _ = x.shape
    h = rms_norm(x, w["attn_norm"])
    q = F.linear(h, w["wq"]).view(b, t, cfg.n_heads, cfg.d_head)
    k = F.linear(h, w["wk"]).view(b, t, cfg.n_kv_heads, cfg.d_head)
    v = F.linear(h, w["wv"]).view(b, t, cfg.n_kv_heads, cfg.d_head)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _attention_block(w: Dict[str, torch.Tensor], x: torch.Tensor,
                     cfg: TransformerConfig, positions: torch.Tensor,
                     mesh: Optional[Mesh] = None,
                     seq_axis: Optional[str] = None,
                     batch_axis: Optional[str] = None,
                     head_axis: Optional[str] = None) -> torch.Tensor:
    """x + attention(norm(x)) for one layer's weights `w`."""
    b, t, _ = x.shape
    qt, kt, vt = _qkv(w, x, cfg, positions)
    if mesh is not None and seq_axis is not None:
        # sequence-parallel path: ring attention over the mesh (GQA is
        # the kernels' own; a sliding window ends the ring early)
        o = ring_attention(qt, kt, vt, mesh, axis_name=seq_axis, causal=True,
                           window=cfg.window, batch_axis=batch_axis,
                           head_axis=head_axis)
    else:
        o = flash_attention(qt, kt, vt, causal=True, window=cfg.window)
    o = o.transpose(1, 2).reshape(b, t, cfg.d_q)
    return x + F.linear(o, w["wo"]).to(x.dtype)


def _mlp_block(w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x + SwiGLU(norm(x)) for one layer's weights `w` (as `Block.mlp`)."""
    h = rms_norm(x, w["mlp_norm"])
    gated = F.silu(F.linear(h, w["w_gate"]).float())
    up = F.linear(h, w["w_up"]).float()
    return x + F.linear((gated * up).to(x.dtype), w["w_down"]).to(x.dtype)


def forward(model: Transformer, tokens: torch.Tensor,
            mesh: Optional[Mesh] = None, seq_axis: Optional[str] = None,
            batch_axis: Optional[str] = None,
            head_axis: Optional[str] = None) -> torch.Tensor:
    """Causal LM forward: tokens [B, T] → fp32 logits [B, T, V], with
    attention through the differentiable `flash_attention(causal=True)`.

    With `mesh` and `seq_axis`, attention runs sequence-parallel
    (`ring_attention`) while the token-local layers (norms, projections,
    MLP) run on the model's device. `batch_axis` shards the ring's batch
    over a mesh axis and `head_axis` its heads; the projections are not
    computed from `param_shardings`' per-rank slices."""
    cfg = model.cfg
    b, t = tokens.shape
    x = model.embed[tokens].to(cfg.dtype)
    positions = torch.arange(t, device=x.device)
    for blk in model.layers:
        w = layer_weights(blk)
        x = _attention_block(w, x, cfg, positions, mesh, seq_axis,
                             batch_axis, head_axis)
        x = _mlp_block(w, x)
    return model.unembed(x)


def loss_fn(model: Transformer, tokens: torch.Tensor,
            **fwd_kw) -> torch.Tensor:
    """Next-token cross entropy: targets are the tokens rolled by −1, and
    the mean NLL is taken over positions [:, :-1] (the wrapped-around last
    position is dropped), as the JAX package's `loss_fn`. `fwd_kw`
    (`mesh`, `seq_axis`, `batch_axis`, `head_axis`) go to `forward`."""
    logits = forward(model, tokens, **fwd_kw)
    targets = torch.roll(tokens, -1, dims=1).long()
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           targets[:, :-1].reshape(-1))


def make_train_step(model: Transformer, optimizer: torch.optim.Optimizer,
                    **fwd_kw):
    """A train step for `model`: step(tokens) zeroes the gradients, runs
    `loss_fn` and its backward, applies `optimizer` (built over
    `model.parameters()`) and returns the loss. The parameters and the
    optimizer state are updated in place, which is what the JAX version's
    buffer donation buys, so there is no `donate` option. `fwd_kw`
    (`mesh`, `seq_axis`, `batch_axis`, `head_axis`) select the
    sequence-, data- and tensor-parallel forms of `forward`."""

    def step(tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens, **fwd_kw)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


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
    leaf; `forward` does not compute from the slices (its `head_axis`
    shards the ring's heads only)."""
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
    """The slice of `w` that each rank of the mesh holds under `spec` (a
    leaf of `param_shardings`): {rank: slice, on the rank's device}."""
    out = {}
    for rank in range(mesh.size):
        coords = dict(zip(mesh.axis_names, map(
            int, np.unravel_index(rank, mesh.devices.shape))))
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
            caches: Tuple[KVCache, ...]):
    """Run the prompt through the model, filling the caches (in place).
    Returns (logits_last [B, V] fp32, caches)."""
    return prefill_chunk(model, tokens, 0, caches)


@torch.no_grad()
def prefill_chunk(model: Transformer, tokens: torch.Tensor, start: int,
                  caches: Tuple[KVCache, ...]):
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
    out of the combine."""
    cfg = model.cfg
    b, c = tokens.shape
    x = model.embed[tokens].to(cfg.dtype)
    positions = torch.arange(start, start + c, device=x.device)
    for blk, cache in zip(model.layers, caches):
        qt, kt, vt = _qkv(layer_weights(blk), x, cfg, positions)
        cache_append(cache, kt, vt)
        o_new, lse_new = flash_attention_forward(
            qt, kt, vt, causal=True, window=cfg.window,
            out_dtype=torch.float32)
        if start > 0:
            lo = max(0, start - cfg.window) if cfg.window else 0
            ks = cache.k_scale[:, :, lo:start] if cache.quantized else None
            vs = cache.v_scale[:, :, lo:start] if cache.quantized else None
            o_old, lse_old = flash_attention_forward(
                qt, cache.k[:, :, lo:start], cache.v[:, :, lo:start],
                k_scale=ks, v_scale=vs, causal=bool(cfg.window),
                window=cfg.window, kv_offset=start - lo,
                out_dtype=torch.float32)
            o_c, _ = combine_partials(o_old, lse_old, o_new, lse_new)
        else:
            o_c = o_new
        o = o_c.to(cfg.dtype).transpose(1, 2).reshape(b, c, cfg.d_q)
        x = x + blk.wo(o).to(x.dtype)
        x = blk.mlp(x)
    return model.unembed(x[:, -1]), caches


def prefill_chunked(model: Transformer, tokens: torch.Tensor,
                    caches: Tuple[KVCache, ...], chunk: int):
    """Prefill a long prompt in chunks of `chunk` tokens (the last may be
    shorter). Equivalent to `prefill`, with memory bounded by the chunk."""
    logits = None
    for s in range(0, tokens.shape[1], chunk):
        logits, caches = prefill_chunk(model, tokens[:, s:s + chunk], s,
                                       caches)
    return logits, caches


@torch.no_grad()
def decode_one(model: Transformer, token: torch.Tensor, position: int,
               caches: Tuple[KVCache, ...], quantize_q: bool = False):
    """One autoregressive step: token [B] → (logits [B, V], caches). The
    token's K/V are appended before attention, so it attends to itself.
    Attention reads the (possibly quantized) caches through the decode
    kernel; `quantize_q` runs its Q·Kᵀ as an integer dot on int8-K
    caches."""
    cfg = model.cfg
    b = token.shape[0]
    x = model.embed[token].to(cfg.dtype)[:, None, :]  # [B, 1, D]
    positions = torch.full((1,), position, device=x.device)
    for blk, cache in zip(model.layers, caches):
        qt, kt, vt = _qkv(layer_weights(blk), x, cfg, positions)
        cache_append(cache, kt, vt)
        o, _ = decode_step(qt[:, :, 0], cache, window=cfg.window,
                           quantize_q=quantize_q)
        x = x + blk.wo(o.reshape(b, 1, cfg.d_q)).to(x.dtype)
        x = blk.mlp(x)
    return model.unembed(x[:, 0]), caches

