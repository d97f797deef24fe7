"""Golden oracle: exact softmax attention forward (+ LSE), backward and
decode.

Counterpart of cuda_flashattention_tpu/ops/naive.py. Dense O(N^2) math in
fp32 (or fp64); TF32 is switched off for both matmuls and convolutions
during each call, so that the oracle does not drift with the backend, and
the flags are put back as they were when the call returns or raises.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from cuda_flashattention_torch.ops.common import resolve_scale


@contextlib.contextmanager
def _no_tf32():
    """Switch TF32 off for the body and restore the caller's flags."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _scores(q, k, scale, causal, window, kv_offset, q_segment_ids,
            kv_segment_ids):
    """Scaled scores with masked pairs at -inf: causal (key index >
    query index + kv_offset), outside the window, or across segments."""
    s = torch.einsum("...qd,...kd->...qk", q, k) * scale
    if causal:
        nq, nk = q.shape[-2], k.shape[-2]
        qi = torch.arange(nq, device=q.device)[:, None] + kv_offset
        kj = torch.arange(nk, device=q.device)[None, :]
        ok = kj <= qi
        if window:
            ok = ok & (kj > qi - window)
        s = s.masked_fill(~ok, float("-inf"))
    if q_segment_ids is not None:
        # packed sequences: [B, Nq] / [B, Nk] ids over q [B, H, Nq, d]
        qs = torch.as_tensor(q_segment_ids, device=q.device)[:, None, :, None]
        ks = torch.as_tensor(kv_segment_ids, device=q.device)[:, None, None, :]
        s = s.masked_fill(qs != ks, float("-inf"))
    return s


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    dtype: torch.dtype = torch.float32,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention forward; returns (O, LSE) in `dtype`.

    q [..., Nq, d], k/v [..., Nk, d] with matching leading dims. `causal`
    masks pairs with key index > query index + kv_offset; `window` keeps
    only the last `window` keys of each causal row; segment ids ([B, Nq]
    and [B, Nk] over q [B, H, Nq, d]) mask pairs across segments. A row
    with no visible key gets O = 0 and LSE = log(1e-30), as the JAX oracle
    does."""
    with _no_tf32():
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        scale = resolve_scale(scale, q.shape[-1])
        s = _scores(q, k, scale, causal, window, kv_offset, q_segment_ids,
                    kv_segment_ids)
        m = s.amax(dim=-1, keepdim=True)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m_safe)
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("...qk,...kd->...qd", p, v) / l
        lse = (m_safe + torch.log(l))[..., 0]
    return o, lse


def naive_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact attention backward through the explicit softmax Jacobian;
    returns (dQ, dK, dV) in fp32.

    Shapes and masks as `naive_attention`. dV = Pᵀ·dO, dP = dO·Vᵀ,
    dS = P ⊙ (dP − rowsum(P ⊙ dP))·scale, dQ = dS·K, dK = dSᵀ·Q; masked
    pairs and rows with no visible key have P = 0."""
    with _no_tf32():
        q, k, v, do = (x.to(torch.float32) for x in (q, k, v, do))
        scale = resolve_scale(scale, q.shape[-1])
        s = _scores(q, k, scale, causal, window, kv_offset, q_segment_ids,
                    kv_segment_ids)
        p = torch.softmax(s, dim=-1)
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        dv = torch.einsum("...qk,...qd->...kd", p, do)
        dp = torch.einsum("...qd,...kd->...qk", do, v)
        # rowsum(P ⊙ dP) equals the flash backward's D = rowsum(dO ⊙ O)
        delta = (p * dp).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta) * scale
        dq = torch.einsum("...qk,...kd->...qd", ds, k)
        dk = torch.einsum("...qk,...qd->...kd", ds, q)
    return dq, dk, dv


def naive_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: Optional[float] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Single-query exact attention (decode step oracle): q [..., d]."""
    o, _ = naive_attention(q[..., None, :], k, v, scale=scale, dtype=dtype)
    return o[..., 0, :]
