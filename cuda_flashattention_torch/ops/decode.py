"""Single-token decode attention over a bf16 KV cache.

Counterpart of cuda_flashattention_tpu/ops/decode.py (`decode_attention`).
On a CUDA tensor it launches the hand-written Hopper kernel of
csrc/decode.cu (one CTA per (batch, KV head) serving the G = H/Hkv query
heads of the group, natural-exp online softmax, keys past lengths[b] never
read). On a CPU tensor it runs `decode_attention_plain`, a dense PyTorch
version of the same numerics.

Not yet ported (raise NotImplementedError): quantized caches
(`k_scale`/`v_scale`), `window`/`windows`, `quantize_q`, explicit
`block_k`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import (
    KERNEL_HEAD_DIMS,
    NEG_INF,
    resolve_scale,
)

KERNEL_GROUPS = (1, 2, 4, 8)


def decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense PyTorch version of the kernel's arithmetic, on any device.

    fp32 scores times `scale`, keys at or past lengths[b] masked with
    probability 0, natural exp, P rounded to q's dtype before P·V with
    fp32 accumulation; O in q's dtype, LSE = m + ln l in fp32, and a
    sequence with no live key gets O = 0 and LSE = NEG_INF."""
    b, h, d = q.shape
    h_kv, max_n = k.shape[1], k.shape[2]
    group = h // h_kv
    scale = resolve_scale(scale, d)
    qg = q.float().view(b, h_kv, group, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * scale
    cols = torch.arange(max_n, device=q.device)
    live = cols[None, :] < lengths.to(q.device).view(b, 1).long()
    s = torch.where(live[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m),
                    torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhgk,bhkd->bhgd", p.to(q.dtype).float(), v.float())
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    o = torch.where(empty, torch.zeros((), device=q.device), pv / l_safe)
    lse = torch.where(empty, torch.full_like(l, NEG_INF),
                      m + torch.log(l_safe))
    return o.reshape(b, h, d).to(q.dtype), lse.reshape(b, h)


def _decode_cuda(q, k, v, lengths, scale):
    b, h, d = q.shape
    h_kv, max_n = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA decode takes d in {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    if h // h_kv not in KERNEL_GROUPS:
        raise ValueError(f"the CUDA decode takes H/Hkv in {KERNEL_GROUPS}, "
                         f"got {h // h_kv}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the CUDA decode takes bf16 inputs, got {name} {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA decode reads a contiguous cache")
    q = q.contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} != ({b},)")
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().cfa_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, h_kv, max_n, d,
            resolve_scale(scale, d), stream)
    _build.check(err, "decode_attention kernel launch")
    decode_attention.launches += 1
    return o, lse


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_k: Optional[int] = None,
    window: int = 0,
    windows: Optional[torch.Tensor] = None,
    quantize_q: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: q [B,H,d] attends to cache k/v [B,Hkv,max_N,d].

    `lengths` [B] int gives each sequence's live context; cache rows at or
    past it are neither read nor attended. Returns (o [B,H,d] in q's
    dtype, lse [B,H] fp32). On the card the kernel takes bf16, d in
    {64, 128} and H/Hkv in {1, 2, 4, 8}; the count of its launches is
    `decode_attention.launches`."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,d] and k/v [B,Hkv,N,d], got q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2]:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("quantized caches are not ported yet")
    if int(window or 0) or windows is not None:
        raise NotImplementedError("windowed decode is not ported yet")
    if quantize_q:
        raise NotImplementedError("quantize_q is not ported yet")
    if block_k is not None:
        raise NotImplementedError("block_k: the kernel walks keys directly")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _decode_cuda(q, k, v, lengths, scale)


decode_attention.launches = 0
