"""Golden oracle: exact softmax attention forward (+ LSE), backward and
decode.

Counterpart of cuda_flashattention_tpu/ops/naive.py. Dense O(N^2) math in
fp32 (or fp64); TF32 is switched off for both matmuls and convolutions so
that the oracle does not drift with the backend.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cuda_flashattention_torch.ops.common import resolve_scale


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention forward; returns (O, LSE) in `dtype`.

    q [..., Nq, d], k/v [..., Nk, d] with matching leading dims. `causal`
    masks pairs with key index > query index + kv_offset; `window` keeps
    only the last `window` keys of each causal row. A row with no visible
    key gets O = 0 and LSE = log(1e-30), as the JAX oracle does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    scale = resolve_scale(scale, q.shape[-1])
    s = torch.einsum("...qd,...kd->...qk", q, k) * scale
    if causal:
        nq, nk = q.shape[-2], k.shape[-2]
        qi = torch.arange(nq, device=q.device)[:, None] + kv_offset
        kj = torch.arange(nk, device=q.device)[None, :]
        ok = kj <= qi
        if window:
            ok = ok & (kj > qi - window)
        s = s.masked_fill(~ok, float("-inf"))
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact attention backward through the explicit softmax Jacobian;
    returns (dQ, dK, dV) in fp32.

    Shapes and masks as `naive_attention`. dV = Pᵀ·dO, dP = dO·Vᵀ,
    dS = P ⊙ (dP − rowsum(P ⊙ dP))·scale, dQ = dS·K, dK = dSᵀ·Q; masked
    pairs and rows with no visible key have P = 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, k, v, do = (x.to(torch.float32) for x in (q, k, v, do))
    scale = resolve_scale(scale, q.shape[-1])
    s = torch.einsum("...qd,...kd->...qk", q, k) * scale
    if causal:
        nq, nk = q.shape[-2], k.shape[-2]
        qi = torch.arange(nq, device=q.device)[:, None] + kv_offset
        kj = torch.arange(nk, device=q.device)[None, :]
        ok = kj <= qi
        if window:
            ok = ok & (kj > qi - window)
        s = s.masked_fill(~ok, float("-inf"))
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
