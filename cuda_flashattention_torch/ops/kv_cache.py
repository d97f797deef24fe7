"""KV-cache manager: preallocated bf16/fp32 storage, append, decode.

Counterpart of cuda_flashattention_tpu/ops/kv_cache.py for unquantized
caches. Storage is preallocated to max_len; `append` writes IN PLACE into
it (slice assignment) and advances `length`, which is a host int, so an
append past max_len raises before anything is written. Quantized caches
(`qtype`) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cuda_flashattention_torch.ops.decode import decode_attention


@dataclasses.dataclass
class KVCache:
    """KV cache of one attention layer.

    k/v: [B, Hkv, max_len, d]. length: tokens currently live (uniform
    across the batch)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(batch: int, heads_kv: int, max_len: int, d: int,
               qtype: Optional[str] = None,
               dtype: torch.dtype = torch.bfloat16,
               device=None) -> KVCache:
    """Allocate an empty (zeroed) cache on `device`."""
    if qtype is not None:
        raise NotImplementedError(f"qtype={qtype!r}: quantized caches are "
                                  f"not ported yet")
    shape = (batch, heads_kv, max_len, d)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def append(cache: KVCache, k_new: torch.Tensor,
           v_new: torch.Tensor) -> KVCache:
    """Append T new tokens (k/v [B,Hkv,T,d]) at the write head, in place:
    `cache` itself is updated and returned. Raises on overflow."""
    t = k_new.shape[2]
    if cache.length + t > cache.max_len:
        raise ValueError(
            f"KV cache overflow: append of {t} tokens at length "
            f"{cache.length} exceeds max_len {cache.max_len}")
    end = cache.length + t
    cache.k[:, :, cache.length:end] = k_new
    cache.v[:, :, cache.length:end] = v_new
    cache.length = end
    return cache


def decode_step(q: torch.Tensor, cache: KVCache,
                scale: Optional[float] = None,
                window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attend one new query token q [B,H,d] against the live cache.
    Returns (o [B,H,d], lse [B,H]). The caller appends the token's K/V
    first, so that the token attends to itself."""
    lengths = torch.full((q.shape[0],), cache.length, dtype=torch.int32,
                         device=q.device)
    return decode_attention(q, cache.k, cache.v, lengths, scale=scale,
                            window=window)
