"""Multi-process launcher: the port's `mpirun` equivalent.

    python -m cuda_flashattention_torch.scripts.launch_multihost \
        [-np N] [--devices-per-proc K] [--cpu] [--timeout S] \
        (-m MODULE | SCRIPT) [ARGS ...]

Counterpart of scripts/launch_multihost.py. It starts N python processes
of the module or script, each with the `CFA_*` variables that
`parallel/mesh.initialize_distributed` reads through the ladder's
bootstrap (`examples/_ladder.bootstrap`): the coordinator on a free local
port (`CFA_COORD`), the process count and index (`CFA_NPROC`,
`CFA_PID`), the ranks each process puts on its device (`CFA_LOCAL_RANKS`,
from `--devices-per-proc`) and, under `--cpu`, `CFA_CPU=1` (the processes
run on the CPU; else process i takes card i mod the visible cards). The
global mesh then spans N·K ranks. Process 0's output is shown as it comes;
the others' is kept and printed, to stderr, for a process that fails
(with `--log-dir DIR`, every process's output but process 0's is also
written to DIR/p<i>.log). When a process fails, the others are stopped,
and the launcher exits with the code of the first process that failed
(124 when `--timeout` ran out). At the timeout each process still running
is first sent `parallel/mesh.STACK_SIGNAL`, on which a process of a group
writes every thread's Python stack to its stderr, so that the output
shows where a late process waits; `shutdown_distributed` also prints a
line per step of each process's shutdown, with the host's clock.

Without `--cpu` the kernel library is built once, before any process
starts (`_build.ensure_built`), so that N processes do not run nvcc N
times; the build's lock file covers a library that is still missing.

    python -m cuda_flashattention_torch.scripts.launch_multihost -np 2 \
        --devices-per-proc 2 --cpu -m cuda_flashattention_torch.examples.ppermute_verify
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List

# seconds the processes still running at the timeout get to write their
# stacks before they are stopped
STACK_WAIT_S = 3.0
# the characters of a failed process's output that the launcher prints
TAIL_CHARS = 16000


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse(argv=None) -> argparse.Namespace:
    """The launcher's options, up to `-m MODULE` or the script; what
    follows goes to the processes untouched (`args.command`)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-np", type=int, default=2, help="number of processes")
    ap.add_argument("--devices-per-proc", type=int, default=1,
                    help="mesh ranks each process puts on its card (or on "
                         "the CPU under --cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="run every process on the CPU")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds after which every process is stopped")
    ap.add_argument("--log-dir", type=Path, default=None,
                    help="write each process's output but process 0's "
                         "to DIR/p<i>.log")
    valued = {"-np", "--devices-per-proc", "--timeout", "--log-dir"}
    i = 0
    while i < len(argv) and argv[i] != "-m" and argv[i].startswith("-"):
        i += 2 if argv[i] in valued else 1
    if i >= len(argv) or (argv[i] == "-m" and i + 1 >= len(argv)):
        ap.error("name a script, or a module after -m")
    args = ap.parse_args(argv[:i])
    args.command = (["-m", *argv[i + 1:]] if argv[i] == "-m"
                    else argv[i:])
    return args


def child_env(coord: str, nproc: int, pid: int, local_ranks: int,
              cpu: bool) -> dict:
    """The environment of process `pid`."""
    env = dict(os.environ)
    env.update({"CFA_COORD": coord, "CFA_NPROC": str(nproc),
                "CFA_PID": str(pid), "CFA_LOCAL_RANKS": str(local_ranks),
                "CFA_CPU": "1" if cpu else "0"})
    return env


def dump_stacks(procs) -> None:
    """Ask each process for its threads' stacks (`STACK_SIGNAL`, which a
    process of a group answers on its stderr) and give them
    `STACK_WAIT_S` to write them."""
    from cuda_flashattention_torch.parallel.mesh import STACK_SIGNAL
    for p in procs:
        try:
            p.send_signal(STACK_SIGNAL)
        except ProcessLookupError:  # it ended meanwhile
            pass
    time.sleep(STACK_WAIT_S)


def main(argv=None) -> int:
    args = parse(argv)
    if not args.cpu:
        from cuda_flashattention_torch import _build
        _build.ensure_built()
    cmd: List[str] = [sys.executable, *args.command]
    coord = f"127.0.0.1:{free_port()}"
    procs, logs = [], []
    for pid in range(args.np):
        log = None if pid == 0 else tempfile.TemporaryFile(mode="w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            cmd, env=child_env(coord, args.np, pid, args.devices_per_proc,
                               args.cpu),
            stdout=log, stderr=None if log is None else subprocess.STDOUT))
    deadline = None if args.timeout is None else \
        time.monotonic() + args.timeout
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            if deadline is not None and time.monotonic() > deadline:
                late = [i for i, p in enumerate(procs) if p.poll() is None]
                print(f"[launch_multihost] processes {late} still running "
                      f"after {args.timeout} s: their stacks, then they "
                      f"are stopped", file=sys.stderr, flush=True)
                dump_stacks([procs[i] for i in late])
                rc = 124
                break
            failed = [i for i, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed:
                rc = procs[failed[0]].returncode
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if args.log_dir is not None:
        args.log_dir.mkdir(parents=True, exist_ok=True)
    for pid, (p, log) in enumerate(zip(procs, logs)):
        text = ""
        if log is not None:
            log.seek(0)
            text = log.read()
            log.close()
            if args.log_dir is not None:
                (args.log_dir / f"p{pid}.log").write_text(text)
        if p.returncode != 0:
            print(f"[launch_multihost] process {pid} exited {p.returncode}",
                  file=sys.stderr)
            print("".join(f"[p{pid}] {line}\n"
                          for line in text[-TAIL_CHARS:].splitlines()),
                  file=sys.stderr, end="")
    if rc == 0:
        rc = next((p.returncode for p in procs if p.returncode), 0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
