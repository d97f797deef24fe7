"""Traces, named regions, kernel reports, memory snapshots and device
time by kernel, from torch.profiler.

Counterpart of cuda_flashattention_tpu/utils/profiling.py:

    from cuda_flashattention_torch.utils.profiling import annotate, trace

    with trace("/tmp/cfa_trace"):          # a Chrome trace, trace.json
        with annotate("attention_fwd"):    # a named region inside it
            o = flash_attention(q, k, v)
            torch.cuda.synchronize()

`trace` captures the host and, on the card, the device's kernels with
torch.profiler and writes a Chrome trace (chrome://tracing, Perfetto);
`annotate` names a region in it (and an NVTX range on the card);
`kernel_report` turns a measured time into TFLOP/s, GB/s and shares of the
card's peaks (`utils.timing.device_peaks`); `save_device_memory_profile`
pickles the caching allocator's snapshot. On the card, `kernel_times` runs
a function under torch.profiler and sums the device time of each kernel by
name. It reads kernel events only: the per-op device totals of
`key_averages()` count a kernel again under every operator that encloses
it. `device_events` returns those events with the stream each ran on, and
`covered_share` says how much of one set of events ran under another (the
ring's copies under its kernels).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import time
from typing import Callable, Dict, Iterator, List, Tuple

import torch

TRACE_FILE = "trace.json"  # the Chrome trace `trace` writes into log_dir


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the block (host operators and,
    with a card, its kernels and copies) and write it into `log_dir` as
    the Chrome trace `TRACE_FILE`. Yields the profiler, whose `events()`
    can be read once the block is left."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in profiler timelines (`torch.profiler.
    record_function`), and an NVTX range when there is a card; nearly free
    when no trace is active."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def kernel_report(name: str, seconds: float, flops: float = 0.0,
                  bytes_moved: float = 0.0, device=None) -> Dict[str, float]:
    """TFLOP/s, GB/s and their shares of the card's bf16 and memory peaks
    for a measured call, under the JAX function's keys, and its one-line
    summary printed as the JAX function prints it (shares are NaN off a
    card in `device_peaks`' table)."""
    from cuda_flashattention_torch.utils.timing import device_peaks

    peaks = device_peaks(device)
    tflops = flops / seconds / 1e12 if flops else 0.0
    gbps = bytes_moved / seconds / 1e9 if bytes_moved else 0.0
    out = {
        "name": name,
        "ms": seconds * 1e3,
        "tflops": tflops,
        "gbps": gbps,
        "frac_peak_flops": (tflops / peaks["peak_tflops"]
                            if peaks["peak_tflops"] else float("nan")),
        "frac_peak_bw": (gbps / peaks["peak_hbm_gbps"]
                         if peaks["peak_hbm_gbps"] else float("nan")),
    }
    print(f"[kernel_report] {name}: {out['ms']:.3f} ms"
          + (f", {tflops:.1f} TFLOP/s"
             f" ({100*out['frac_peak_flops']:.1f}% peak)" if flops else "")
          + (f", {gbps:.1f} GB/s"
             f" ({100*out['frac_peak_bw']:.1f}% peak)" if bytes_moved
             else ""))
    return out


def save_device_memory_profile(path: str, device=None) -> None:
    """Pickle the card's memory snapshot (`torch.cuda.memory._snapshot`:
    the caching allocator's segments and blocks, with the allocation
    stacks when `torch.cuda.memory._record_memory_history` is on) into
    `path`; it loads in PyTorch's memory viz. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("save_device_memory_profile needs a CUDA device")
    snapshot = torch.cuda.memory._snapshot(device)
    with open(path, "wb") as f:
        pickle.dump(snapshot, f)


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
