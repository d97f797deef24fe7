"""FlashAttention-2 backward: host function, CUDA kernel launches, plain
version.

Counterpart of cuda_flashattention_tpu/ops/flash_bwd.py
(`flash_attention_backward`). On a CUDA tensor it launches the
hand-written Hopper kernels: the fused single pass K4 (dK/dV per 128-key
tile, dQ added into an fp32 buffer by TMA reduces) by default, or the
split pair K2 (dK/dV) + K3 (dQ) with `fused=False`. K2 and K4 are one
wgmma + TMA kernel (csrc/flash_bwd_kv.cu), K3 the wmma kernel of
csrc/flash_bwd.cu. On a CPU tensor it runs
`flash_attention_backward_plain`, a dense PyTorch version of the same
numerics; the CPU tests and the on-card comparisons use it.

D = rowsum(dO ⊙ O) is one PyTorch reduction before the kernels, as the
JAX split path computes it (the JAX fused kernel's in-kernel D is a VMEM
schedule, not a different result).

Masks are the forward's: causal with `kv_offset`, a sliding `window`,
segment ids and the ragged tail. Explicit `block_sizes` raise
NotImplementedError (the kernels' tiles are fixed).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import (
    KERNEL_HEAD_DIMS,
    NEG_INF,
    cdiv,
    check_qkv,
    kernel_operand,
    resolve_scale,
)

_LOG2E = 1.4426950408889634

# K2/K4's tiles (csrc/flash_bwd_kv.cu): a CTA owns BK keys, two warpgroups
# of 64, and streams the query rows that see them BQ at a time
_BWD_BK = 128
_BWD_BQ = 64


def _bwd_q_tiles(c0: int, nq: int, nk: int, causal: bool, window: int,
                 kv_offset: int) -> Tuple[int, int]:
    """The Q tiles [first, last] that the K2/K4 CTA of the key tile at c0
    walks (for each query head of its group), as the kernel's `q_tiles`
    computes them: causal rows see keys <= row + kv_offset, so the first
    tile holds row c0 − kv_offset; with a window the last row that reaches
    the tile's last key is that key − kv_offset + window − 1. Empty when
    first > last. Exactly the tiles with a visible pair (segment ids
    aside, which mask inside the walk)."""
    first, last = 0, cdiv(nq, _BWD_BQ) - 1
    if causal:
        first = max(0, c0 - kv_offset) // _BWD_BQ
        if window > 0:
            last_row = min(nk, c0 + _BWD_BK) - 2 + window - kv_offset
            last = -1 if last_row < 0 else min(last, last_row // _BWD_BQ)
    return first, last


def _bwd_cta_order(nk: int, h_kv: int, b: int) -> List[Tuple[int, int, int]]:
    """(key tile, KV head, batch) of each K2/K4 CTA in launch order, as the
    kernel's `cta_tile` maps its block index: key tiles slowest, so that
    under causal, where key tile 0 sees the most queries, the longest walks
    start in the first wave."""
    return [(kt, lin % h_kv, lin // h_kv)
            for kt in range(cdiv(nk, _BWD_BK)) for lin in range(h_kv * b)]


def flash_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense PyTorch version of the kernels' arithmetic, on any device.

    S from the raw q in fp32 times scale·log2e; P = exp2(S − LSE·log2e),
    0 where masked (causal, window, segment ids) or where the row's
    LSE < NEG_INF/2; dS = P ⊙ (dP − D)
    ·scale; P rounded to dO's dtype before dV = Pᵀ·dO, dS to q's before
    dK = dSᵀ·Q and to k's before dQ = dS·K, each product accumulated in
    fp32. GQA sums dK/dV over the query heads of a group in fp32."""
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    group = h // h_kv
    scale = resolve_scale(scale, d)
    qf = q.float().reshape(b, h_kv, group, nq, d)
    dof = do.float().reshape(b, h_kv, group, nq, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * (scale * _LOG2E)
    lse = lse.float().reshape(b, h_kv, group, nq, 1)
    dead = lse < NEG_INF * 0.5
    if causal:
        rows = torch.arange(nq, device=q.device)[:, None] + kv_offset
        cols = torch.arange(nk, device=q.device)[None, :]
        dead = dead | (cols > rows)
        if window:
            dead = dead | (cols <= rows - window)
    if q_segment_ids is not None:
        dead = dead | (q_segment_ids[:, :, None]
                       != kv_segment_ids[:, None, :])[:, None, None]
    p = torch.where(dead, torch.zeros((), device=q.device),
                    torch.exp2(s - lse * _LOG2E))
    delta = (dof * o.float().reshape(b, h_kv, group, nq, d)).sum(
        -1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - delta) * scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(do.dtype).float(), dof)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds.to(q.dtype).float(), qf)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds.to(k.dtype).float(), kf)
    return (dq.reshape(b, h, nq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_cuda(q, k, v, o, lse, do, scale, causal, window, kv_offset, q_seg,
              kv_seg, fused):
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA backward takes d in {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if x.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the CUDA backward takes bf16 inputs, got {name} {x.dtype}")
    for name, x in (("k", k), ("v", v), ("o", o), ("lse", lse), ("do", do),
                    ("q_segment_ids", q_seg), ("kv_segment_ids", kv_seg)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    q, k, v, do = (kernel_operand(x) for x in (q, k, v, do))
    lse = lse.float().contiguous()
    delta = (do.float() * o.float()).sum(-1)  # [B, H, Nq] fp32
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
    dk = torch.empty((b, h_kv, nk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h_kv, nk, d), dtype=v.dtype, device=q.device)
    if q_seg is not None:
        q_seg = q_seg.to(torch.int32).contiguous()
        kv_seg = kv_seg.to(torch.int32).contiguous()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if q_seg is None else q_seg.data_ptr(),
            None if kv_seg is None else kv_seg.data_ptr())
    shape = (b, h, h_kv, nq, nk, d, strides, resolve_scale(scale, d),
             int(bool(causal)), int(window), int(kv_offset))
    launches = flash_attention_backward.launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _build.library()
        if fused:
            dq_acc = torch.zeros((b, h, nq, d), dtype=torch.float32,
                                 device=q.device)
            err = lib.cfa_flash_bwd_kv(*head, dk.data_ptr(), dv.data_ptr(),
                                       dq_acc.data_ptr(), *shape, stream)
            _build.check(err, "flash_attention_backward fused kernel launch")
            launches["fused"] += 1
            return dq_acc.to(q.dtype), dk, dv
        err = lib.cfa_flash_bwd_kv(*head, dk.data_ptr(), dv.data_ptr(), None,
                                   *shape, stream)
        _build.check(err, "flash_attention_backward dK/dV kernel launch")
        launches["dkdv"] += 1
        dq = torch.empty((b, h, nq, d), dtype=q.dtype, device=q.device)
        err = lib.cfa_flash_bwd_q(*head, dq.data_ptr(), *shape, stream)
        _build.check(err, "flash_attention_backward dQ kernel launch")
        launches["dq"] += 1
    return dq, dk, dv


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    block_sizes=None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    fused: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FA2 backward. q/o/do [B,H,Nq,d], k/v [B,Hkv,Nk,d], lse [B,H,Nq]
    (natural log, as the forward returns it) → (dQ [B,H,Nq,d],
    dK/dV [B,Hkv,Nk,d]) in the input dtypes.

    GQA: dK/dV sum the query heads of each group in fp32. `causal`,
    `window`, `kv_offset` and the segment ids mask as in the forward; a
    row that saw no key (LSE = NEG_INF) gives and gets zero gradients.
    `fused`: None
    and True run the single-pass kernel K4, False the split pair K2 + K3;
    all three give the same gradients. The JAX version picks fused only
    while its full-sequence state fits a TPU VMEM budget
    (`CFA_BWD_FUSED_BUDGET`, `CFA_BWD_FUSED`): that budget has no GPU
    counterpart (K4 keeps no full-sequence state on chip), so neither it
    nor the environment knobs are ported. On the card the kernels take
    bf16 q/k/v/dO with d in {64, 128}; the counts of their launches are
    `flash_attention_backward.launches["dkdv"]`, `["dq"]` and `["fused"]`.
    """
    check_qkv(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or (
            lse.shape != q.shape[:3]):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    window = int(window or 0)
    if window and not causal:
        raise ValueError("window requires causal=True")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    if q_segment_ids is not None and (
            tuple(q_segment_ids.shape) != (q.shape[0], q.shape[2])
            or tuple(kv_segment_ids.shape) != (k.shape[0], k.shape[2])):
        raise ValueError(
            f"segment ids {tuple(q_segment_ids.shape)} / "
            f"{tuple(kv_segment_ids.shape)} do not match q "
            f"{tuple(q.shape)} / k {tuple(k.shape)}")
    if block_sizes is not None:
        raise NotImplementedError("block_sizes: the kernels' tiles are fixed")
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, o, lse, do, scale=scale, causal=causal, window=window,
            kv_offset=kv_offset, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _bwd_cuda(q, k, v, o, lse, do, scale, causal, window, kv_offset,
                     q_segment_ids, kv_segment_ids,
                     fused is None or bool(fused))


flash_attention_backward.launches = {"dkdv": 0, "dq": 0, "fused": 0}
