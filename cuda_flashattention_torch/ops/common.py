"""Shared helpers of the attention ops (counterpart of
cuda_flashattention_tpu/ops/common.py, without its TPU-only parts: the
VMEM block-size heuristics, interpret-mode selection and fp8 bit casts)."""

from __future__ import annotations

import math
from typing import Optional

# A finite stand-in for -inf: exp(x - NEG_INF) == 0 in fp32 while avoiding
# inf - inf = nan in the running-max updates. Empty rows report it as LSE.
NEG_INF = -1e30


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def resolve_scale(scale: Optional[float], d: int) -> float:
    """Softmax scale: 1/sqrt(d) unless given."""
    return 1.0 / math.sqrt(d) if scale is None else float(scale)
