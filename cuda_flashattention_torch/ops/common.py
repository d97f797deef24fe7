"""Shared helpers of the attention ops (counterpart of
cuda_flashattention_tpu/ops/common.py, without its TPU-only parts: the
VMEM block-size heuristics, interpret-mode selection and the fp8 bit
casts, which Hopper's hardware conversion of e4m3 makes needless)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# A finite stand-in for -inf: exp(x - NEG_INF) == 0 in fp32 while avoiding
# inf - inf = nan in the running-max updates. Empty rows report it as LSE.
NEG_INF = -1e30

# head dims the CUDA kernels are instantiated for (csrc/*.cu)
KERNEL_HEAD_DIMS = (64, 128)


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def resolve_scale(scale: Optional[float], d: int) -> float:
    """Softmax scale: 1/sqrt(d) unless given."""
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def resolve_device(device=None) -> torch.device:
    """The device an entry point allocates on: `None` means the card (the
    current CUDA device), and raises RuntimeError when there is none —
    it never falls back to the CPU. Ask for the CPU with `device="cpu"`."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present: this allocates on the card by "
            "default; pass device=\"cpu\" to allocate on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def quantize_q_per_head(q: torch.Tensor,
                        axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-head absmax int8 quantisation of Q for the integer Q·Kᵀ path
    (`quantize_q`): absmax over `axes`, sigma = max(absmax, 1e-12) / 127,
    codes round(q / sigma) (half to even) clipped to ±127. Returns
    (q_int8, sigma fp32, broadcastable against q)."""
    qf = q.float()
    sq = qf.abs().amax(dim=axes, keepdim=True).clamp_min(1e-12) / 127.0
    q8 = torch.clamp(torch.round(qf / sq), -127, 127).to(torch.int8)
    return q8, sq


def check_qkv(q, k, v) -> None:
    """Raise ValueError unless q [B,H,Nq,d] and k/v [B,Hkv,Nk,d] fit
    together, with Hkv dividing H (GQA)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected [B,H,N,d] inputs, got q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or (
            k.shape[3] != q.shape[3]):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")


def kernel_operand(x):
    """Tensor x as the attention kernels read it: unit stride on d and
    16-byte aligned rows (every other stride a multiple of the elements in
    16 bytes: 8 for bf16, 16 for int8 and fp8). Copies only when x is
    not."""
    vec = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % vec == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()
