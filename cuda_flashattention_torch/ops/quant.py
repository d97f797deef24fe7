"""Quantized (int8 / fp8 e4m3) K/V storage with per-token scales.

Counterpart of cuda_flashattention_tpu/ops/quant.py. Each row of K and V
(one token of one head) is absmax-quantized over the head dim to int8 or
`torch.float8_e4m3fn` with one fp32 scale; `"mixed"` stores K as int8 and
V as fp8. The decode kernels (ops/decode.py, ops/paged.py) and the forward
kernels (ops/flash_fwd.py, through `flash_attention_quantized`) read the
codes and scales as they are and fold the dequantisation into their
products:

    S = (Q · K_qᵀ) · scale ⊙ k_scaleᵀ
    O += (P ⊙ v_scaleᵀ) · V_q

e4m3 converts to fp32 exactly, in hardware on the card and by
`Tensor.float()` on the CPU, so there is no counterpart of the JAX
package's fp8 bit casts. Accuracy gates, as there: the dequantised round
trip within 1e-3 of the input at int8 and 1e-2 at fp8 on values in
[-0.5, 0.5].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

INT8_MAX = 127.0
# float8_e4m3fn: max finite 448.
FP8_MAX = 448.0

_SUPPORTED = ("int8", "fp8", "mixed")


def _qmax(qtype: str) -> float:
    if qtype == "int8":
        return INT8_MAX
    if qtype == "fp8":
        return FP8_MAX
    # "mixed" applies to a K/V pair (quantize_kv, init_cache,
    # init_paged_cache), never to one tensor
    raise ValueError(
        f"per-tensor qtype must be 'int8' or 'fp8', got {qtype!r}")


def storage_dtype(qtype: str) -> torch.dtype:
    if qtype == "int8":
        return torch.int8
    if qtype == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(
        f"per-tensor qtype must be 'int8' or 'fp8', got {qtype!r}")


def pair_qtypes(qtype: str) -> Tuple[str, str]:
    """Resolve a pair-level qtype to (k_qtype, v_qtype)."""
    if qtype not in _SUPPORTED:
        raise ValueError(f"qtype must be one of {_SUPPORTED}, got {qtype!r}")
    return ("int8", "fp8") if qtype == "mixed" else (qtype, qtype)


def qtype_of(x: torch.Tensor) -> str:
    """The per-tensor qtype a quantized array is stored in."""
    return "int8" if x.dtype == torch.int8 else "fp8"


# the names these two carry in the JAX module
_storage_dtype = storage_dtype
_pair_qtypes = pair_qtypes


@dataclasses.dataclass
class QuantizedKV:
    """A quantized K/V pair: values [B,H,N,d] (int8 or fp8) and scales
    [B,H,N] fp32."""

    k_q: torch.Tensor
    k_scale: torch.Tensor
    v_q: torch.Tensor
    v_scale: torch.Tensor

    @property
    def shape(self):
        return self.k_q.shape

    @property
    def qtype(self) -> str:
        kt, vt = qtype_of(self.k_q), qtype_of(self.v_q)
        return kt if kt == vt else "mixed"

    def dequantize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Materialised fp32 K/V, for tests; the kernels never do this."""
        return (self.k_q.float() * self.k_scale[..., None],
                self.v_q.float() * self.v_scale[..., None])


def quantize_tensor(x: torch.Tensor, qtype: str = "int8",
                    axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmax-quantize along `axis`; returns (values, scale with the axis
    dropped). scale = max(absmax, 1e-12) / qmax, so an all-zero row gets
    codes 0 and a tiny positive scale. int8 rounds half to even and clips
    to ±127; fp8 is the round-to-nearest-even cast of x / scale, whose
    magnitude never exceeds 448."""
    x = x.float()
    qmax = _qmax(qtype)
    absmax = x.abs().amax(dim=axis, keepdim=True)
    scale = absmax.clamp_min(1e-12) / qmax
    y = x / scale
    if qtype == "int8":
        q = torch.clamp(torch.round(y), -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        q = y.to(torch.float8_e4m3fn)
    return q, scale.squeeze(axis)


def quantize_kv(k: torch.Tensor, v: torch.Tensor,
                qtype: str = "int8") -> QuantizedKV:
    """Quantize K/V [B,H,N,d] with per-token (row) scales. `"mixed"`
    stores K as int8, which the decode's integer Q·Kᵀ (`quantize_q`)
    needs, and V as fp8."""
    kt, vt = pair_qtypes(qtype)
    k_q, k_scale = quantize_tensor(k, kt)
    v_q, v_scale = quantize_tensor(v, vt)
    return QuantizedKV(k_q, k_scale, v_q, v_scale)


def flash_attention_quantized(
    q: torch.Tensor,
    kv: QuantizedKV,
    scale: Optional[float] = None,
    causal: bool = False,
    kv_offset: int = 0,
    block_sizes=None,
    quantize_q: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FA2 forward over a quantized K/V pair, the dequantisation folded
    into the kernel's products. An inference path: it has no backward.
    `quantize_q` also runs Q·Kᵀ on per-head int8 Q (fp8 keys are
    re-gridded onto int8 in the kernel); see `flash_attention_forward`.
    Returns (O, LSE) as `flash_attention_forward` does."""
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    return flash_attention_forward(
        q, kv.k_q, kv.v_q, scale=scale, causal=causal, kv_offset=kv_offset,
        block_sizes=block_sizes, k_scale=kv.k_scale, v_scale=kv.v_scale,
        quantize_q=quantize_q)
