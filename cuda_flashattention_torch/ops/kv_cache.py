"""KV-cache manager: preallocated, optionally quantized, append + decode.

Counterpart of cuda_flashattention_tpu/ops/kv_cache.py. Storage is
preallocated to max_len; `append` writes IN PLACE into it (slice
assignment) and advances `length`, which is a host int, so an append past
max_len raises before anything is written. A quantized cache
(`qtype="int8"`, `"fp8"`, or `"mixed"` = int8 K with fp8 V) quantizes new
tokens at append time, each array onto its own grid with one fp32 scale
per token, and `decode_step` reads codes and scales through the decode
kernel, which folds the dequantisation into its products.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cuda_flashattention_torch.ops.common import resolve_device
from cuda_flashattention_torch.ops.decode import decode_attention
from cuda_flashattention_torch.ops.quant import (
    pair_qtypes,
    qtype_of,
    storage_dtype,
    quantize_tensor,
)


@dataclasses.dataclass
class KVCache:
    """Quantized-or-not KV cache of one attention layer.

    k/v: [B, Hkv, max_len, d] in the storage dtype (bf16, fp32, int8,
    fp8). k_scale/v_scale: [B, Hkv, max_len] fp32, or None when
    unquantized. length: tokens currently live (uniform across the
    batch)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    length: int = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(batch: int, heads_kv: int, max_len: int, d: int,
               qtype: Optional[str] = None,
               dtype: torch.dtype = torch.bfloat16,
               device=None) -> KVCache:
    """Allocate an empty cache: zeroed values, scales of 1. qtype in
    {None, "int8", "fp8", "mixed"}. `device=None` means the card and
    raises without one (`resolve_device`)."""
    device = resolve_device(device)
    shape = (batch, heads_kv, max_len, d)
    if qtype:
        kt, vt = pair_qtypes(qtype)
        return KVCache(
            torch.zeros(shape, dtype=storage_dtype(kt), device=device),
            torch.zeros(shape, dtype=storage_dtype(vt), device=device),
            torch.ones(shape[:3], dtype=torch.float32, device=device),
            torch.ones(shape[:3], dtype=torch.float32, device=device), 0)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def append(cache: KVCache, k_new: torch.Tensor,
           v_new: torch.Tensor) -> KVCache:
    """Append T new tokens (k/v [B,Hkv,T,d]) at the write head, in place:
    `cache` itself is updated and returned. A quantized cache quantizes
    them here, K and V each in its own storage type. Raises on
    overflow."""
    t = k_new.shape[2]
    if cache.length + t > cache.max_len:
        raise ValueError(
            f"KV cache overflow: append of {t} tokens at length "
            f"{cache.length} exceeds max_len {cache.max_len}")
    end = cache.length + t
    if cache.quantized:
        k_new, k_s = quantize_tensor(k_new, qtype_of(cache.k))
        v_new, v_s = quantize_tensor(v_new, qtype_of(cache.v))
        cache.k_scale[:, :, cache.length:end] = k_s
        cache.v_scale[:, :, cache.length:end] = v_s
    cache.k[:, :, cache.length:end] = k_new
    cache.v[:, :, cache.length:end] = v_new
    cache.length = end
    return cache


def decode_step(q: torch.Tensor, cache: KVCache,
                scale: Optional[float] = None,
                block_k: Optional[int] = None,
                window: int = 0,
                quantize_q: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attend one new query token q [B,H,d] against the live cache.
    Returns (o [B,H,d], lse [B,H]). The caller appends the token's K/V
    first, so that the token attends to itself. `block_k` (the split
    size), `window` and `quantize_q` are `decode_attention`'s."""
    lengths = torch.full((q.shape[0],), cache.length, dtype=torch.int32,
                         device=q.device)
    return decode_attention(q, cache.k, cache.v, lengths,
                            k_scale=cache.k_scale, v_scale=cache.v_scale,
                            scale=scale, block_k=block_k, window=window,
                            quantize_q=quantize_q)
