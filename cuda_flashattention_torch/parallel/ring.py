"""Log-space merge of partial attention results (counterpart of
cuda_flashattention_tpu/parallel/ring.py `combine_partials`; the ring
itself is not ported yet). Chunked prefill merges a chunk's causal
self-attention with its attention over the cached prefix through it."""

from __future__ import annotations

import torch


def combine_partials(o1: torch.Tensor, lse1: torch.Tensor,
                     o2: torch.Tensor, lse2: torch.Tensor):
    """Merge two normalised partials over disjoint key sets:
    O = Σᵢ Oᵢ·exp(LSEᵢ − LSE), LSE = logaddexp(LSEᵢ)."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    return o1 * w1 + o2 * w2, lse
