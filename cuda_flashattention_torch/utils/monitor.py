"""Card memory and power poller (counterpart of scripts/monitor_tpu.py).

Each poll reads every visible card's caching-allocator counters (bytes in
use, their peak) and its total memory, and prints them with the card's
name, power draw and power limit as `nvidia-smi --query-gpu=...` gives
them (the reference's GPU monitor polls that every 5 s on a daemon
thread). Standalone:

    python -m cuda_flashattention_torch.utils.monitor [interval_s]

or in-process around a workload:

    from cuda_flashattention_torch.utils.monitor import start_monitor
    stop = start_monitor(interval_s=5.0)
    ...  # run the job
    stop()
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

GREEN, YELLOW, RED, RESET = "\033[92m", "\033[93m", "\033[91m", "\033[0m"
SMI_QUERY = "index,name,power.draw,power.limit"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024:
            return f"{n:7.1f}{unit}"
        n /= 1024
    return f"{n:7.1f}TiB"


def parse_smi(text: str) -> Dict[int, Tuple[str, str, str]]:
    """`nvidia-smi --query-gpu=index,name,power.draw,power.limit
    --format=csv,noheader` output as {index: (name, draw, limit)}; lines
    that do not parse are skipped."""
    out = {}
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 4 and parts[0].isdigit():
            out[int(parts[0])] = (parts[1], parts[2], parts[3])
    return out


def _smi() -> Dict[int, Tuple[str, str, str]]:
    """The cards' names and power from nvidia-smi; {} where it is missing
    or fails."""
    try:
        text = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_QUERY}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    return parse_smi(text)


def poll_once(verbose: bool = True) -> List[Tuple[int, int, int, int,
                                                  float]]:
    """One (id, used, peak, limit, pct) row per visible card (bytes: the
    caching allocator's in use and peak, the card's total), printed with
    the card's name and power when `verbose`; [] without a card. (The
    index nvidia-smi reports is the physical one: it matches the row's id
    unless CUDA_VISIBLE_DEVICES reorders the cards.)"""
    if not torch.cuda.is_available():
        return []
    smi = _smi() if verbose else {}
    rows = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        used = stats.get("allocated_bytes.all.current", 0)
        peak = stats.get("allocated_bytes.all.peak", 0)
        limit = torch.cuda.mem_get_info(i)[1]
        pct = 100.0 * used / limit if limit else 0.0
        rows.append((i, used, peak, limit, pct))
        if verbose:
            name, draw, cap = smi.get(i, (torch.cuda.get_device_name(i),
                                          "n/a", "n/a"))
            color = GREEN if pct < 60 else (YELLOW if pct < 85 else RED)
            print(f"[{time.strftime('%H:%M:%S')}] dev{i} ({name}, power "
                  f"{draw} of {cap}): {color}{_fmt_bytes(used)} used{RESET}"
                  f" / {_fmt_bytes(limit)} limit (peak {_fmt_bytes(peak)}, "
                  f"{pct:.1f}%)", flush=True)
    return rows


def start_monitor(interval_s: float = 5.0):
    """Run `poll_once` every `interval_s` on a daemon thread; returns the
    callable that stops it (as the JAX monitor's does)."""
    stop_evt = threading.Event()

    def loop():
        while not stop_evt.is_set():
            try:
                poll_once()
            except Exception as e:  # monitoring must never kill the job
                print(f"[monitor] {e}", file=sys.stderr)
            stop_evt.wait(interval_s)

    threading.Thread(target=loop, daemon=True).start()
    return stop_evt.set


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    interval = float(argv[0]) if argv else 5.0
    while True:
        poll_once()
        time.sleep(interval)


if __name__ == "__main__":
    sys.exit(main())
