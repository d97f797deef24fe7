"""Decoder-only transformer: training (forward, loss, train step) and
serving (prefill and decode over the KV cache), attention through the
package's kernels.

Counterpart of cuda_flashattention_tpu/models/transformer.py: RMSNorm +
RoPE (split halves) + GQA attention + SwiGLU MLP, tied
embedding/unembedding. The projections, MLP and unembedding are plain
`F.linear` products. Attention is `flash_attention` (training: forward
kernel K1, backward kernel K4 or K2 + K3), `flash_attention_forward`
(prefill) and `decode_step` (decode), over a cache that may be quantized
(`init_caches(qtype=...)`). The sequence-parallel, pipelined
and sharded forms of the JAX model (`mesh`, `pipeline_forward`,
`param_shardings`) wait for the distributed layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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
from cuda_flashattention_torch.parallel.ring import combine_partials


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
    # 0 = full causal. Decode honours a window; prefill and training raise
    # for one until the forward and backward kernels take it
    window: int = 0
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
        """SwiGLU residual branch: SiLU(gate)·up in fp32, cast to x's dtype
        before the down projection."""
        h = rms_norm(x, self.mlp_norm)
        gated = F.silu(self.w_gate(h).float())
        up = self.w_up(h).float()
        return x + self.w_down((gated * up).to(x.dtype)).to(x.dtype)


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

def _qkv(blk: Block, x: torch.Tensor, cfg: TransformerConfig,
         positions: torch.Tensor):
    """Normed input → rotated q [B,H,T,d] and k/v [B,Hkv,T,d] (views)."""
    b, t, _ = x.shape
    h = rms_norm(x, blk.attn_norm)
    q = blk.wq(h).view(b, t, cfg.n_heads, cfg.d_head)
    k = blk.wk(h).view(b, t, cfg.n_kv_heads, cfg.d_head)
    v = blk.wv(h).view(b, t, cfg.n_kv_heads, cfg.d_head)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Causal LM forward: tokens [B, T] → fp32 logits [B, T, V], with
    attention through the differentiable `flash_attention(causal=True)`."""
    cfg = model.cfg
    b, t = tokens.shape
    x = model.embed[tokens].to(cfg.dtype)
    positions = torch.arange(t, device=x.device)
    for blk in model.layers:
        qt, kt, vt = _qkv(blk, x, cfg, positions)
        o = flash_attention(qt, kt, vt, causal=True, window=cfg.window)
        o = o.transpose(1, 2).reshape(b, t, cfg.d_q)
        x = x + blk.wo(o).to(x.dtype)
        x = blk.mlp(x)
    return model.unembed(x)


def loss_fn(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy: targets are the tokens rolled by −1, and
    the mean NLL is taken over positions [:, :-1] (the wrapped-around last
    position is dropped), as the JAX package's `loss_fn`."""
    logits = forward(model, tokens)
    targets = torch.roll(tokens, -1, dims=1).long()
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           targets[:, :-1].reshape(-1))


def make_train_step(model: Transformer, optimizer: torch.optim.Optimizer):
    """A train step for `model`: step(tokens) zeroes the gradients, runs
    `loss_fn` and its backward, applies `optimizer` (built over
    `model.parameters()`) and returns the loss. The parameters and the
    optimizer state are updated in place, which is what the JAX version's
    buffer donation buys, so there is no `donate` option."""

    def step(tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


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
    chunk attends itself causally and, when start > 0, the cached prefix
    [0, start) in full; the two partials merge in log space
    (combine_partials). Returns (logits_last [B, V], caches).

    Over a quantized cache only start = 0 is ported: a later chunk reads
    the quantized prefix through the forward kernel's quantized form,
    which does not exist yet."""
    cfg = model.cfg
    b, c = tokens.shape
    if start > 0 and any(cache.quantized for cache in caches):
        raise NotImplementedError(
            "prefill_chunk at start > 0 over a quantized cache needs the "
            "quantized form of the forward kernel (k_scale/v_scale in "
            "flash_attention_forward), which is not ported yet")
    x = model.embed[tokens].to(cfg.dtype)
    positions = torch.arange(start, start + c, device=x.device)
    for blk, cache in zip(model.layers, caches):
        qt, kt, vt = _qkv(blk, x, cfg, positions)
        cache_append(cache, kt, vt)
        o_new, lse_new = flash_attention_forward(
            qt, kt, vt, causal=True, window=cfg.window,
            out_dtype=torch.float32)
        if start > 0:
            o_old, lse_old = flash_attention_forward(
                qt, cache.k[:, :, :start], cache.v[:, :, :start],
                causal=False, window=cfg.window, out_dtype=torch.float32)
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
        qt, kt, vt = _qkv(blk, x, cfg, positions)
        cache_append(cache, kt, vt)
        o, _ = decode_step(qt[:, :, 0], cache, window=cfg.window,
                           quantize_q=quantize_q)
        x = x + blk.wo(o.reshape(b, 1, cfg.d_q)).to(x.dtype)
        x = blk.mlp(x)
    return model.unembed(x[:, 0]), caches

