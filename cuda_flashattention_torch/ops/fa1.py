"""FlashAttention-1 forward: the ladder rung below FA2.

Counterpart of cuda_flashattention_tpu/ops/fa1.py (`fa1_attention`). FA1
differs from FA2 (ops/flash_fwd.py) in the step that defines it: O is
re-normalised after every K/V block,

    o = (l_prev · alpha · o_prev + P·V) / max(l_new, 1e-30),

instead of being divided by l once at the end. The rung exists to make
that trade-off observable beside FA2 and the oracle. Forward only, O
only (no LSE), no GQA.

On a CUDA tensor it launches the hand-written Hopper kernel of
csrc/fa1.cu (the forward's wgmma + TMA body: one CTA per 128-row Q tile
streams K and V through a ring of shared-memory stages; a renormalising
block is one to four 64-key tiles, walked twice: its row max first, then
P and P·V), in bf16, in fp16 (csrc/fa1_f16.cu) or, for fp32 inputs and
inputs of mixed float types, its fp32 build (each tile split into bf16 hi
and lo parts, P rounded to v's type where that is narrower; at d = 256 it
walks each 64-key tile as two 32-key tiles, whose split K + V fits beside
the split Q tile). On a CPU tensor it runs
`fa1_attention_plain`, which walks the same blocks in PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import (
    FA1_HEAD_DIMS,
    NEG_INF,
    ROUND_CODES,
    cdiv,
    kernel_operand,
    pad_heads,
    resolve_scale,
    round_up,
)

# what the card's kernel takes (csrc/fa1.cu): block_q in multiples of 64
# rows (rows are independent, so block_q changes no number; a CTA owns 128),
# keys per tile, and the most tiles a renormalising block may span
KERNEL_BLOCK_Q = 64
KERNEL_SUB_K = 64
KERNEL_MAX_SUB = 4


def _prescale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Q · scale, rounded in Q's dtype, as the TPU host function does (for
    an fp16 Q the factor first rounded to fp16, as JAX's weakly typed
    scalar is; `ops/flash_fwd.py::_prescale_q` says why only there)."""
    if q.dtype == torch.float16:
        return q * torch.tensor(scale, dtype=q.dtype)
    return (q * scale).to(q.dtype)


def fa1_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    block_q: int = 256,
    block_k: int = 256,
) -> torch.Tensor:
    """Block-by-block PyTorch version of the kernel's arithmetic, on any
    device: per Q block of `block_q` rows, a walk over every K/V block of
    `block_k` keys (those wholly above the causal diagonal included, as in
    the TPU kernel) with fp32 scores from the prescaled Q, masked scores
    at NEG_INF with probability 0, P rounded to V's dtype before P·V, and
    the renormalising update after each block."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    qs = _prescale_q(q, resolve_scale(scale, d)).float()
    kf, vf = k.float(), v.float()
    neg = torch.full((), NEG_INF, device=q.device)
    out = torch.empty((b, h, nq, d), dtype=q.dtype, device=q.device)
    for r0 in range(0, nq, block_q):
        qb = qs[:, :, r0:r0 + block_q]
        rows = torch.arange(r0, r0 + qb.shape[2], device=q.device)[:, None]
        m = torch.full((b, h, qb.shape[2], 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((b, h, qb.shape[2], d), device=q.device)
        for c0 in range(0, nk, block_k):
            s = qb @ kf[:, :, c0:c0 + block_k].transpose(-1, -2)
            if causal:
                cols = torch.arange(c0, c0 + s.shape[-1],
                                    device=q.device)[None, :]
                s = torch.where(cols <= rows, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m_new),
                            torch.zeros((), device=q.device))
            alpha = torch.exp(m - m_new)
            l_new = l * alpha + p.sum(dim=-1, keepdim=True)
            pv = p.to(v.dtype).float() @ vf[:, :, c0:c0 + block_k]
            o = (l * alpha * o + pv) / l_new.clamp_min(1e-30)
            m, l = m_new, l_new
        out[:, :, r0:r0 + block_q] = o.to(q.dtype)
    return out


def _kernel_sub_tiles(nq: int, nk: int, block_q: int, block_k: int) -> int:
    """The number of 64-key sub-tiles per renormalising block for the
    card's kernel, or ValueError for block sizes it does not take."""
    if block_q % KERNEL_BLOCK_Q != 0 and block_q < nq:
        raise ValueError(
            f"the CUDA FA1 takes block_q a multiple of {KERNEL_BLOCK_Q} (or "
            f"one block over all {nq} rows), got {block_q}")
    most = KERNEL_SUB_K * KERNEL_MAX_SUB
    if block_k >= nk and nk <= most:
        return max(1, cdiv(nk, KERNEL_SUB_K))  # one block over all keys
    if block_k % KERNEL_SUB_K == 0 and block_k <= most:
        return block_k // KERNEL_SUB_K
    raise ValueError(
        f"the CUDA FA1 takes block_k in "
        f"{tuple(KERNEL_SUB_K * i for i in range(1, KERNEL_MAX_SUB + 1))} "
        f"(or one block over all keys when Nk <= {most}), got {block_k} "
        f"for Nk = {nk}")


def _fa1_cuda(q, k, v, scale, causal, block_q, block_k):
    b, h, nq, d = q.shape
    nk = k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in ROUND_CODES:
            raise NotImplementedError(
                f"the CUDA FA1 takes bf16, fp16 or fp32 inputs, got {name} "
                f"{x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    n_sub = _kernel_sub_tiles(nq, nk, block_q, block_k)
    # the scale from the caller's d, before narrow heads are padded
    qs = _prescale_q(q, resolve_scale(scale, d))
    # one 2-byte type: its build (fp16: `cfa_fa1_f16`); fp32, or mixed
    # float types upcast exactly (JAX's promotion), the fp32 build, which
    # rounds P to v's type (f32 = 1 + its `ROUND_CODES`) and writes fp32 O
    one = q.dtype == k.dtype == v.dtype
    unit = "_f16" if one and q.dtype == torch.float16 else ""
    f32 = 0 if one and q.dtype != torch.float32 else 1 + ROUND_CODES[v.dtype]
    if f32:
        qs, k, v = qs.float(), k.float(), v.float()
    d_run, (qs, k, v) = pad_heads("FA1", qs, k, v, dims=FA1_HEAD_DIMS)
    qs, k, v = kernel_operand(qs), kernel_operand(k), kernel_operand(v)
    o = torch.empty((b, h, nq, d_run), dtype=qs.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*qs.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), "cfa_fa1" + unit)(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
            nq, nk, d_run, strides, int(bool(causal)), n_sub, f32, stream)
    _build.check(err, "fa1_attention kernel launch")
    fa1_attention.launches += 1
    return o[..., :d].to(q.dtype)


def fa1_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    block_q: int = 256,
    block_k: int = 256,
) -> torch.Tensor:
    """FlashAttention-1 forward. q [B,H,Nq,d], k/v [B,H,Nk,d] → O
    [B,H,Nq,d] in q's dtype. `causal` masks key j for query i when j > i.

    `block_k` is the number of keys after which O is renormalised, and
    `block_q` the rows worked on together; as in the JAX function each is
    first clamped to max(8, min(block, round_up(N, 8))). Rows are
    independent, so `block_q` changes no number. On the card a CTA owns 128
    rows and the kernel takes bf16, fp16 or fp32 inputs (its fp32 build:
    each tile split into bf16 hi and lo parts; mixed float types run it
    on exactly upcast operands, P rounded to v's dtype as in JAX), d in
    {64, 128, 256} or any d below 256 on zero-padded heads
    (`ops.common.pad_heads`, the scale from the caller's d; past 256 no
    build), `block_q` a multiple of 64 (or one block over all rows) and `block_k` in {64, 128,
    192, 256} (or one block over all keys when Nk ≤ 256); any other value
    raises ValueError. The count of its launches is
    `fa1_attention.launches`."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected q/k/v [B,H,N,d], got q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    b, h, nq, d = q.shape
    if k.shape[1] != h:
        raise ValueError("fa1 is the educational rung: no GQA "
                         f"(q heads {h} != kv heads {k.shape[1]})")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    block_q = max(8, min(int(block_q), round_up(nq, 8)))
    block_k = max(8, min(int(block_k), round_up(k.shape[2], 8)))
    if q.device.type == "cpu":
        return fa1_attention_plain(q, k, v, scale=scale, causal=causal,
                                   block_q=block_q, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _fa1_cuda(q, k, v, scale, causal, block_q, block_k)


fa1_attention.launches = 0
