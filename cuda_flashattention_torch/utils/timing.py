"""Device timing with CUDA events (counterpart of
cuda_flashattention_tpu/utils/timing.py; the TPU's slope timing is not
needed on a GPU, where events bracket the device's own work)."""

from __future__ import annotations

import statistics
from typing import Callable, Optional

import torch


def attention_flops(b: int, h: int, nq: int, nk: int, d: int,
                    causal: bool = False, backward: bool = False) -> float:
    """Matmul FLOPs of one attention call, counted as the JAX package's
    utils/timing.py counts them: 2 products forward (QKᵀ, PV), 5 backward
    (S, dP, dV, dK, dQ), 2·d flops per (query, key) pair each, half the
    pairs when causal."""
    pairs = b * h * nq * nk * (0.5 if causal else 1.0)
    return 2.0 * pairs * d * (5 if backward else 2)


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3,
            before: Optional[Callable[[], object]] = None,
            **kwargs) -> float:
    """Median device milliseconds of one `fn(*args, **kwargs)` call (the
    JAX function's name and arguments; the JAX one returns wall seconds),
    after `warmup` calls: each call bracketed by its own pair of CUDA
    events on the current stream, so the time is the device's, not the
    enqueue's. `before()`, when given, runs ahead of each timed call and
    outside its events (to evict the L2 cache, say). Raises when there is
    no card: a CPU time is never reported as a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn needs a CUDA device")
    for _ in range(warmup):
        fn(*args, **kwargs)
    pairs = []
    for _ in range(iters):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kwargs)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def cuda_time_ms(fn: Callable[[], object], iters: int = 20,
                 warmup: int = 3,
                 before: Optional[Callable[[], object]] = None) -> float:
    """`time_fn` of a call with no arguments."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    return time_fn(fn, iters=iters, warmup=warmup, before=before)
