"""Public attention API: differentiable FlashAttention-2.

Counterpart of cuda_flashattention_tpu/ops/attention.py. The JAX package
joins forward and backward with `jax.custom_vjp`; here `FlashAttention` is
a `torch.autograd.Function` whose forward runs `flash_attention_forward`
(kernel K1, or K1b / K5 where its `softmax="auto"` routes to the bound
softmax) and whose backward runs `flash_attention_backward` (K4, or
K2 + K3), so `loss.backward()` goes through the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from cuda_flashattention_torch.ops.flash_bwd import flash_attention_backward
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward


class FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v); saves (q, k, v, O, LSE) for the backward.
    The non-tensor arguments and segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, kv_offset, block_sizes,
                q_segment_ids, kv_segment_ids):
        opts = dict(scale=scale, causal=causal, window=window,
                    kv_offset=kv_offset, block_sizes=block_sizes,
                    q_segment_ids=q_segment_ids,
                    kv_segment_ids=kv_segment_ids)
        o, lse = flash_attention_forward(q, k, v, out_dtype=q.dtype, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # dO arrives as a strided view (the model's transpose + reshape);
        # the kernels take row strides, so it is not copied here
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    block_sizes=None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable FlashAttention-2: q [B,H,Nq,d], k/v [B,Hkv,Nk,d] → O
    [B,H,Nq,d] in q's dtype.

    GQA when Hkv divides H; `causal` masks key j for query i when
    j > i + kv_offset and, with `window` (requires causal), when
    j <= i + kv_offset − window; `q_segment_ids` [B,Nq] /
    `kv_segment_ids` [B,Nk] (integer, no gradient) mask pairs of different
    segments, forward and backward; ragged lengths. `block_sizes`
    (`ops.common.BlockSizes`) picks the forward's and the backward's tiles
    among those the kernels are built for, and raises ValueError on any
    other."""
    return FlashAttention.apply(q, k, v, scale, causal, window, kv_offset,
                                block_sizes, q_segment_ids, kv_segment_ids)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """`flash_attention` in the [B, N, H, d] (sequence-major) layout that
    models carry activations in."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), scale=scale, causal=causal)
    return o.transpose(1, 2)
