"""FlashAttention-2 backward: host function, CUDA kernel launches, plain
version.

Counterpart of cuda_flashattention_tpu/ops/flash_bwd.py
(`flash_attention_backward`). On a CUDA tensor it launches the
hand-written Hopper kernels of csrc/flash_bwd.cu: the fused single pass
K4 (dK/dV per key tile, dQ added with fp32 atomics) by default, or the
split pair K2 (dK/dV) + K3 (dQ) with `fused=False`. On a CPU tensor it
runs `flash_attention_backward_plain`, a dense PyTorch version of the same
numerics; the CPU tests and the on-card comparisons use it.

D = rowsum(dO ⊙ O) is one PyTorch reduction before the kernels, as the
JAX split path computes it (the JAX fused kernel's in-kernel D is a VMEM
schedule, not a different result).

Not yet ported (raise NotImplementedError): sliding `window`, segment ids
and explicit `block_sizes`, as in the forward.
"""

from __future__ import annotations

import ctypes
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


def flash_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    kv_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense PyTorch version of the kernels' arithmetic, on any device.

    S from the raw q in fp32 times scale·log2e; P = exp2(S − LSE·log2e),
    0 where masked or where the row's LSE < NEG_INF/2; dS = P ⊙ (dP − D)
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


def _bwd_cuda(q, k, v, o, lse, do, scale, causal, kv_offset, fused):
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA backward takes d in {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if x.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the CUDA backward takes bf16 inputs, got {name} {x.dtype}")
    for name, x in (("k", k), ("v", v), ("o", o), ("lse", lse), ("do", do)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    q, k, v, do = (kernel_operand(x) for x in (q, k, v, do))
    lse = lse.float().contiguous()
    delta = (do.float() * o.float()).sum(-1)  # [B, H, Nq] fp32
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
    dk = torch.empty((b, h_kv, nk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h_kv, nk, d), dtype=v.dtype, device=q.device)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    shape = (b, h, h_kv, nq, nk, d, strides, resolve_scale(scale, d),
             int(bool(causal)), int(kv_offset))
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

    GQA: dK/dV sum the query heads of each group in fp32. `fused`: None
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
    if int(window or 0):
        raise NotImplementedError("sliding window is not ported yet")
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise NotImplementedError("segment ids are not ported yet")
    if block_sizes is not None:
        raise NotImplementedError("block_sizes: the kernels' tiles are fixed")
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do,
                                              scale=scale, causal=causal,
                                              kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _bwd_cuda(q, k, v, o, lse, do, scale, causal, kv_offset,
                     fused is None or bool(fused))


flash_attention_backward.launches = {"dkdv": 0, "dq": 0, "fused": 0}
