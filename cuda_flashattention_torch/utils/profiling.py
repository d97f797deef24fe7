"""Device time by kernel, from torch.profiler.

Partial counterpart of cuda_flashattention_tpu/utils/profiling.py. On the
card, `kernel_times` runs a function under torch.profiler and sums the
device time of each kernel by name. It reads kernel events only: the
per-op device totals of `key_averages()` count a kernel again under every
operator that encloses it. The JAX module's trace helpers,
`kernel_report` and memory profile are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass
class KernelTimes:
    """One profiled window: device ms and launch count per kernel name,
    the device-busy ms (the union of the kernels' intervals) and the
    window's host wall ms, which ends in `torch.cuda.synchronize()`."""

    ms: Dict[str, float]
    count: Dict[str, int]
    busy_ms: float
    wall_ms: float


def _union_ms(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def kernel_times(fn: Callable[[], object], iters: int = 1,
                 attempts: int = 3) -> KernelTimes:
    """Profile `iters` calls of `fn()` on the card. The profiler now and
    then hands back a window without its device events; such a window is
    profiled again, up to `attempts` times, and a window may still lack
    some of its launches, so divide a kernel's `ms` by its `count`, not
    by `iters`. Raises when there is no card, or when no attempt recorded
    device activity."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded no device activity in "
                           f"{attempts} attempts")
    ms: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for e in events:
        ms[e.name] = ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        count[e.name] = count.get(e.name, 0) + 1
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in events])
    return KernelTimes(ms=ms, count=count, busy_ms=busy, wall_ms=wall_ms)
