"""Device timing with CUDA events, the card's peak rates and its memory
counters (counterpart of cuda_flashattention_tpu/utils/timing.py; the
TPU's chained and scanned timings are not needed on a GPU, where events
bracket the device's own work)."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, Optional

import torch

# Dense peak rates by `torch.cuda.get_device_name`, from NVIDIA's data
# sheet (the H100 SXM, at its full power limit of 700 W): bf16 and TF32
# tensor-core TFLOP/s, device-memory GB/s.
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}
PEAK_TF32_TFLOPS = {"NVIDIA H100 80GB HBM3": 495.0}
PEAK_HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


def _cuda_device(device) -> Optional[torch.device]:
    """`device` as a CUDA device (None: the current one), or None when it
    is not one or there is no card."""
    if not torch.cuda.is_available():
        return None
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.type == "cuda" else None


def device_peaks(device=None) -> Dict[str, float]:
    """The card's name and its published dense peaks (the JAX function's
    keys, and the TF32 rate an fp32 product runs at on the card): bf16
    `peak_tflops`, `peak_tf32_tflops` and `peak_hbm_gbps`; NaN for a card
    outside the table, and for the CPU (device_kind "cpu"), as the JAX
    function gives for an unknown device."""
    dev = _cuda_device(device)
    kind = torch.cuda.get_device_name(dev) if dev is not None else "cpu"
    nan = float("nan")
    return {
        "device_kind": kind,
        "peak_tflops": PEAK_TFLOPS.get(kind, nan),
        "peak_tf32_tflops": PEAK_TF32_TFLOPS.get(kind, nan),
        "peak_hbm_gbps": PEAK_HBM_GBPS.get(kind, nan),
    }


def memory_stats(device=None) -> Dict[str, int]:
    """The caching allocator's counters of the card whose key names bytes
    or a limit (the JAX function's filter over `torch.cuda.memory_stats`),
    plus `bytes_limit`, the card's total memory (`torch.cuda.mem_get_info`;
    JAX's key for it). Empty for the CPU or without a card."""
    dev = _cuda_device(device)
    if dev is None:
        return {}
    stats = {k: v for k, v in torch.cuda.memory_stats(dev).items()
             if "bytes" in k or "limit" in k}
    stats["bytes_limit"] = torch.cuda.mem_get_info(dev)[1]
    return stats


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
