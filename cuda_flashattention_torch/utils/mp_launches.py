"""Run the 4-process launch of `chip_smoke.py`'s phase 30 again and again,
and show where each process spent its shutdown.

    python3 cuda_flashattention_torch/utils/mp_launches.py [--runs 20]
                                                          [--out DIR]

Each launch is `launch_multihost -np 4 --devices-per-proc 1 --timeout
MP_TIMEOUT --log-dir DIR/launch<i>` of `utils/multiprocess_paths.py
--check` over chip_smoke's `MP_FOUR_PATHS` with `MP_FOUR_OPTIONS` (the
processes share card 0: the staged transport). Every launch's stdout and
stderr, and every process's output, are kept under DIR (default
build/mp_launches under the checkout). Per launch it prints the exit code,
the seconds, and from the lines `shutdown_distributed` writes (`[mesh] pN
shutdown: STEP at T`) each process's time from the first process's
"begins" to its own "begins" and to its "group destroyed". The runs stop at the first
launch that fails; at the launcher's timeout that launch's output holds
the stacks of the processes still running (`parallel/mesh.STACK_SIGNAL`).
Needs a CUDA device.
"""

import argparse
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MARK = re.compile(r"\[mesh\] p(\d+) shutdown: (.+) at ([0-9.]+)")


def shutdown_steps(texts):
    """{process: {step: host time}} from the outputs' shutdown lines."""
    steps = {}
    for text in texts:
        for m in MARK.finditer(text):
            steps.setdefault(int(m.group(1)), {})[m.group(2)] = float(
                m.group(3))
    return steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "mp_launches")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from cuda_flashattention_torch import _build

    if not torch.cuda.is_available():
        raise SystemExit("mp_launches: no CUDA device")
    card = torch.cuda.get_device_name(0)
    print(chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]), flush=True)
    _build.ensure_built()
    args.out.mkdir(parents=True, exist_ok=True)
    passed = 0
    for i in range(args.runs):
        logs = args.out / f"launch{i}"
        report = logs / "reports"
        cmd = [sys.executable, "-m",
               "cuda_flashattention_torch.scripts.launch_multihost", "-np",
               "4", "--devices-per-proc", "1", "--timeout",
               str(chip_smoke.MP_TIMEOUT), "--log-dir", str(logs), "-m",
               "cuda_flashattention_torch.utils.multiprocess_paths", "--out",
               str(report), "--check", *chip_smoke.MP_FOUR_OPTIONS,
               *chip_smoke.MP_FOUR_PATHS]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           env={**os.environ, "PYTHONPATH": str(ROOT)},
                           timeout=chip_smoke.MP_TIMEOUT + 60)
        secs = time.perf_counter() - t0
        (logs / "stdout.txt").write_text(p.stdout)
        (logs / "stderr.txt").write_text(p.stderr)
        texts = [p.stderr] + [f.read_text() for f in sorted(
            logs.glob("p*.log"))]
        steps = shutdown_steps(texts)
        t_first = min((s["begins"] for s in steps.values()
                       if "begins" in s), default=float("nan"))
        line = ", ".join(
            f"p{q} begins +{s.get('begins', float('nan')) - t_first:.3f} "
            f"destroyed +{s.get('group destroyed', float('nan')) - t_first:.3f}"
            for q, s in sorted(steps.items()))
        print(f"[mp_launches] launch {i}: exit {p.returncode} in "
              f"{secs:.1f} s; shutdown (s after the first process began "
              f"it): {line or 'no lines'} ({card})", flush=True)
        if p.returncode != 0:
            print(f"[mp_launches] launch {i} failed: its stderr (the "
                  f"stacks) under {logs}\n{p.stderr[-20000:]}", flush=True)
            break
        passed += 1
    print(f"[mp_launches] {passed} of {args.runs} launches passed ({card})",
          flush=True)
    return 0 if passed == args.runs else 1


if __name__ == "__main__":
    sys.exit(main())
