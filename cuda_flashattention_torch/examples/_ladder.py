"""What the ladder stages share: their command line, their devices, their
pass line and their timing.

Counterpart of examples/_common.py, without JAX. Each stage runs its ranks
on the visible cards, one rank per card; with a single card (or
`--one-card`) its ranks share card 0, each with its own compute and copy
stream, as the JAX stages put 8 virtual devices on one CPU. `--cpu` runs
the stage on CPU tensors, where every kernel is its plain version. A stage
prints `[name] Test PASSED!` or `[name] Test FAILED!` and its `main`
returns 0 or 1.

Launched as several processes (scripts/launch_multihost.py, which sets the
`CFA_*` variables), a stage joins their group first (`bootstrap`, the
`init_mpi_nccl` equivalent) and its mesh is the global device list: every
process makes the same global inputs from the same seed, runs its own
ranks, and the verdict is every process's (`agree`); process 0 prints.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from cuda_flashattention_torch import config
from cuda_flashattention_torch.parallel import mesh as mesh_mod

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
    args = ap.parse_args(argv)
    args.cpu = args.cpu or config.CPU.as_bool
    return args


def bootstrap(cpu: bool) -> bool:
    """Join the launcher's process group when `CFA_COORD` names one (the
    counterpart of examples/_common.bootstrap); whether there is one."""
    if not config.COORD():
        return False
    mesh_mod.initialize_distributed(
        config.COORD(), config.NPROC.as_int, config.PID.as_int,
        local_ranks=config.LOCAL_RANKS.as_int, cpu=cpu)
    return True


def devices(ranks: Optional[int], cpu: bool,
            one_card: bool = False) -> list:
    """The ranks' devices. Under the launcher: the global device list
    (its first `ranks` entries when given). Else `ranks` (default 8) CPU
    ranks under `cpu`; or one rank per visible card, or `ranks` ranks
    over the cards in turn (all on card 0 under `one_card`, or when one
    card is visible). Raises when no card is visible and `cpu` is not
    set."""
    if bootstrap(cpu):
        devs = mesh_mod.global_devices()
        return devs[:ranks] if ranks else devs
    if cpu:
        return [torch.device("cpu")] * (ranks or DEFAULT_RANKS)
    if not torch.cuda.is_available():
        raise RuntimeError("the ladder runs on NVIDIA cards: none is "
                           "visible (pass --cpu for the plain versions on "
                           "CPU tensors)")
    cards = 1 if one_card else torch.cuda.device_count()
    n = ranks or (cards if cards > 1 else DEFAULT_RANKS)
    return [torch.device("cuda", i % cards) for i in range(n)]


def where(devs: list) -> str:
    """How the ranks sit, for a stage's report."""
    if isinstance(devs[0], mesh_mod.Place):
        procs = len({d.process for d in devs})
        kind = devs[0].device.type
        return (f"{len(devs)} ranks over {procs} processes "
                f"({len(devs) // procs} each, on "
                f"{'the CPU' if kind == 'cpu' else 'cards'}; transport "
                f"{mesh_mod.TRANSPORT})")
    distinct = list(dict.fromkeys(devs))
    if distinct[0].type == "cpu":
        return f"{len(devs)} CPU ranks"
    if len(distinct) == 1:
        return f"{len(devs)} ranks sharing {distinct[0]}"
    return f"{len(devs)} ranks over {len(distinct)} cards"


def home(devs: list) -> torch.device:
    """Where this process keeps the stage's global inputs and results: its
    own device."""
    if isinstance(devs[0], mesh_mod.Place):
        return next(d.device for d in devs
                    if d.process == mesh_mod.process_index())
    return torch.device(devs[0])


def sync(devs: list) -> None:
    """Wait for this process's cards of the list."""
    if isinstance(devs[0], mesh_mod.Place):
        devs = [d.device for d in devs
                if d.process == mesh_mod.process_index()]
    for d in dict.fromkeys(torch.device(d) for d in devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def time_ms(fn: Callable[[], object], devs: list, iters: int = 5) -> str:
    """Mean ms of `fn()` after one warm-up call, as a printable string: on
    a card between CUDA events on its current stream (fn joins the ranks'
    streams back into it), on CPU ranks by the host's clock."""
    fn()
    sync(devs)
    if home(devs).type == "cuda":
        with torch.cuda.device(home(devs)):
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


def agree(mesh, ok: bool) -> bool:
    """Whether `ok` holds in every process of the mesh (`ok` itself in one
    process): each rank of this process adds its process's verdict to an
    all-reduce over the whole mesh."""
    if not mesh.spans_processes:
        return bool(ok)
    from cuda_flashattention_torch.parallel.collectives import all_reduce
    votes = {}
    for r in mesh.local(range(mesh.size)):
        votes[r] = torch.tensor([1.0 if ok else 0.0], device=mesh.device(r))
    total = all_reduce(mesh, mesh.axis_names, votes)
    return next(iter(total.values())).item() == mesh.size


def report(name: str, ok: bool) -> int:
    """The reference's pass line, printed by process 0; 0 when `ok`, else
    1."""
    if mesh_mod.process_index() == 0:
        print(f"[{name}] {'Test PASSED!' if ok else 'Test FAILED!'}",
              flush=True)
    return 0 if ok else 1
