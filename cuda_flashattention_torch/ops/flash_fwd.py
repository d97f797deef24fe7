"""FlashAttention-2 forward: host function, CUDA kernel launch, plain version.

Counterpart of cuda_flashattention_tpu/ops/flash_fwd.py
(`flash_attention_forward`). On a CUDA tensor it launches the hand-written
Hopper kernel of csrc/flash_fwd.cu (online softmax, one CTA per 64-row Q
tile, causal walk bounded at the tile's last visible key, GQA through
`h // group` with no repeat materialised). On a CPU tensor it runs
`flash_attention_forward_plain`, a dense PyTorch version of the same
numerics; the CPU tests and the on-card comparisons use it.

Not yet ported (raise NotImplementedError): sliding `window`, quantized
K/V (`k_scale`/`v_scale`), segment ids, `quantize_q`, explicit
`block_sizes`, and the bound softmax; `softmax="auto"` means online here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import (
    KERNEL_HEAD_DIMS,
    NEG_INF,
    check_qkv,
    kernel_operand,
    resolve_scale,
)

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def _prescale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Q · scale · log2(e), rounded in Q's dtype: the kernel then works in
    log2 units with exp2."""
    return (q * (scale * _LOG2E)).to(q.dtype)


def flash_attention_forward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    kv_offset: int = 0,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense PyTorch version of the kernel's arithmetic, on any device.

    Scores in fp32 log2 units from the prescaled Q, masked entries at
    NEG_INF with probability 0, P rounded to the input dtype before P·V
    with fp32 accumulation, LSE = m·ln2 + ln l, empty rows O = 0 and
    LSE = NEG_INF."""
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    group = h // h_kv
    out_dtype = q.dtype if out_dtype is None else out_dtype
    qs = _prescale_q(q, resolve_scale(scale, d)).float()
    qs = qs.view(b, h_kv, group, nq, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs, kf)
    if causal:
        rows = torch.arange(nq, device=q.device)[:, None] + kv_offset
        cols = torch.arange(nk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF * 0.5, torch.exp2(s - m),
                    torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(q.dtype).float(), vf)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    o = torch.where(empty, torch.zeros((), device=q.device), pv / l_safe)
    lse = torch.where(empty, torch.full_like(l, NEG_INF),
                      m * _LN2 + torch.log(l_safe))
    return (o.reshape(b, h, nq, d).to(out_dtype),
            lse.reshape(b, h, nq))


def _fwd_cuda(q, k, v, scale, causal, kv_offset, out_dtype):
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA forward takes d in {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the CUDA forward takes bf16 inputs, got {name} {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"out_dtype {out_dtype} on the card")
    qs = kernel_operand(_prescale_q(q, resolve_scale(scale, d)))
    k, v = kernel_operand(k), kernel_operand(v)
    o = torch.empty((b, h, nq, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _build.library()
        err = lib.cfa_flash_fwd(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, h_kv, nq, nk, d,
            *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), int(kv_offset),
            int(out_dtype == torch.float32), stream)
    _build.check(err, "flash_attention_forward kernel launch")
    flash_attention_forward.launches += 1
    return o, lse


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    block_sizes=None,
    out_dtype: Optional[torch.dtype] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax: str = "auto",
    quantize_q: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FA2 forward. q [B,H,Nq,d], k/v [B,Hkv,Nk,d] → (O [B,H,Nq,d],
    LSE [B,H,Nq] fp32, natural log).

    H must be a multiple of Hkv (GQA: head h reads KV head h // (H/Hkv)).
    `causal` masks key j for query i when j > i + kv_offset. O is in
    `out_dtype` (default: q's dtype). On the card the kernel takes bf16
    inputs with d in {64, 128}; the count of its launches is
    `flash_attention_forward.launches`."""
    check_qkv(q, k, v)
    if int(window or 0):
        raise NotImplementedError("sliding window is not ported yet")
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("quantized K/V is not ported yet")
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise NotImplementedError("segment ids are not ported yet")
    if softmax not in ("auto", "online"):
        raise NotImplementedError(f"softmax={softmax!r} is not ported yet "
                                  f"(only the online softmax is)")
    if quantize_q:
        raise NotImplementedError("quantize_q is not ported yet")
    if block_sizes is not None:
        raise NotImplementedError("block_sizes: the kernel's tiles are fixed")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if q.device.type == "cpu":
        return flash_attention_forward_plain(q, k, v, scale=scale,
                                             causal=causal,
                                             kv_offset=kv_offset,
                                             out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _fwd_cuda(q, k, v, scale, causal, kv_offset, out_dtype)


flash_attention_forward.launches = 0

