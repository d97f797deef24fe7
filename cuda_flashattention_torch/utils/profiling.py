"""Device time by kernel, from torch.profiler.

Partial counterpart of cuda_flashattention_tpu/utils/profiling.py. On the
card, `kernel_times` runs a function under torch.profiler and sums the
device time of each kernel by name. It reads kernel events only: the
per-op device totals of `key_averages()` count a kernel again under every
operator that encloses it. `device_events` returns those events with the
stream each ran on, and `covered_share` says how much of one set of events
ran under another (the ring's copies under its kernels). The JAX module's
trace helpers,
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


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    """One kernel or copy on the card: its name, the id of the stream it
    ran on, and its start and end on the profiler's clock (µs)."""

    name: str
    stream: int
    start_us: float
    end_us: float


# Host seconds the profiler runs idle before the first launch of a window
# and after its closing synchronize. The profiler keeps only the device
# events that fall inside its window on the host's clock, once their device
# timestamps are mapped to it; a window no longer than the error of that
# mapping can lose every one of its events.
WINDOW_PAD_S = 0.05


def device_events(fn: Callable[[], object], iters: int = 1,
                  attempts: int = 3) -> Tuple[List[DeviceEvent], float]:
    """Profile `iters` calls of `fn()` on the card: (the device events of
    the window, its host wall ms, which ends in `torch.cuda.synchronize()`).
    The window is padded by `WINDOW_PAD_S` of idle time on each side. The
    profiler now and then hands back a window without its device events;
    such a window is profiled again, up to `attempts` times. Raises when
    there is no card, or when no attempt recorded device activity."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_events needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(WINDOW_PAD_S)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(WINDOW_PAD_S)
        events = [DeviceEvent(e.name, e.device_resource_id,
                              e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            return events, wall_ms
    raise RuntimeError(f"torch.profiler recorded no device activity in "
                       f"{attempts} attempts")


def covered_share(events: List[DeviceEvent],
                  cover: List[DeviceEvent]) -> float:
    """The share of the `events`' summed time during which some event of
    `cover` was running (NaN for no events)."""
    merged: List[List[float]] = []
    for c in sorted(cover, key=lambda e: e.start_us):
        if merged and c.start_us <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], c.end_us)
        else:
            merged.append([c.start_us, c.end_us])
    total = under = 0.0
    for e in events:
        total += e.end_us - e.start_us
        under += sum(max(0.0, min(e.end_us, hi) - max(e.start_us, lo))
                     for lo, hi in merged)
    return under / total if total else float("nan")


def kernel_times(fn: Callable[[], object], iters: int = 1,
                 attempts: int = 3) -> KernelTimes:
    """Profile `iters` calls of `fn()` on the card and sum the device time
    by kernel name (see `device_events`). A window may lack some of its
    launches, so divide a kernel's `ms` by its `count`, not by `iters`."""
    events, wall_ms = device_events(fn, iters=iters, attempts=attempts)
    ms: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for e in events:
        ms[e.name] = ms.get(e.name, 0.0) + (e.end_us - e.start_us) / 1e3
        count[e.name] = count.get(e.name, 0) + 1
    busy = _union_ms([(e.start_us, e.end_us) for e in events])
    return KernelTimes(ms=ms, count=count, busy_ms=busy, wall_ms=wall_ms)
