"""What the ladder stages share: their command line, their devices, their
pass line and their timing.

Counterpart of examples/_common.py, without JAX. Each stage runs its ranks
on the visible cards, one rank per card; with a single card (or
`--one-card`) its ranks share card 0, each with its own compute and copy
stream, as the JAX stages put 8 virtual devices on one CPU. `--cpu` runs
the stage on CPU tensors, where every kernel is its plain version. A stage
prints `[name] Test PASSED!` or `[name] Test FAILED!` and its `main`
returns 0 or 1.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import torch

from cuda_flashattention_torch import config

# the ring stages' sequence: the reference's 5096 (not a tile multiple),
# or what $CFA_LADDER_SEQ says (the CPU tests use a shorter one)
LADDER_SEQ = config.LADDER_SEQ.as_int
DEFAULT_RANKS = 8  # the JAX stages' virtual mesh


def parse(doc: str, argv=None) -> argparse.Namespace:
    """The stages' options: --ranks N, --one-card, --cpu."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help=f"ranks of the mesh (default: one per visible "
                         f"card, or {DEFAULT_RANKS} sharing a single card)")
    ap.add_argument("--one-card", action="store_true",
                    help="put every rank on card 0, however many are "
                         "visible")
    ap.add_argument("--cpu", action="store_true",
                    help="run on CPU tensors (the plain versions)")
    return ap.parse_args(argv)


def devices(ranks: Optional[int], cpu: bool,
            one_card: bool = False) -> List[torch.device]:
    """The ranks' devices: `ranks` (default 8) CPU ranks under `cpu`;
    else one rank per visible card, or `ranks` ranks over the cards in
    turn (all on card 0 under `one_card`, or when one card is visible).
    Raises when no card is visible and `cpu` is not set."""
    if cpu:
        return [torch.device("cpu")] * (ranks or DEFAULT_RANKS)
    if not torch.cuda.is_available():
        raise RuntimeError("the ladder runs on NVIDIA cards: none is "
                           "visible (pass --cpu for the plain versions on "
                           "CPU tensors)")
    cards = 1 if one_card else torch.cuda.device_count()
    n = ranks or (cards if cards > 1 else DEFAULT_RANKS)
    return [torch.device("cuda", i % cards) for i in range(n)]


def where(devs: List[torch.device]) -> str:
    """How the ranks sit, for a stage's report."""
    distinct = list(dict.fromkeys(devs))
    if distinct[0].type == "cpu":
        return f"{len(devs)} CPU ranks"
    if len(distinct) == 1:
        return f"{len(devs)} ranks sharing {distinct[0]}"
    return f"{len(devs)} ranks over {len(distinct)} cards"


def sync(devs: List[torch.device]) -> None:
    for d in dict.fromkeys(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def time_ms(fn: Callable[[], object], devs: List[torch.device],
            iters: int = 5) -> str:
    """Mean ms of `fn()` after one warm-up call, as a printable string: on
    a card between CUDA events on its current stream (fn joins the ranks'
    streams back into it), on CPU ranks by the host's clock."""
    fn()
    sync(devs)
    if devs[0].type == "cuda":
        with torch.cuda.device(devs[0]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return f"{start.elapsed_time(end) / iters:.3f} ms (CUDA events)"
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return f"{(time.perf_counter() - t0) / iters * 1e3:.3f} ms (host clock)"


def report(name: str, ok: bool) -> int:
    """The reference's pass line; 0 when `ok`, else 1."""
    print(f"[{name}] {'Test PASSED!' if ok else 'Test FAILED!'}", flush=True)
    return 0 if ok else 1
