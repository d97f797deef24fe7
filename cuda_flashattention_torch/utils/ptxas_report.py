"""Registers and spills of every kernel instance, as ptxas reports them.

Compiles each `csrc/*.cu` once more with `-Xptxas -v` (all sources at
once, into a temporary directory; the library `_build` loads is left as
it is), demangles the entry names with `cu++filt` and prints one line per
kernel instance whose name (mangled or demangled) matches `--match`:
registers a thread (for a warp-specialised kernel the launch's count;
its `setmaxnreg` regions are what the spills show), spill stores and
loads in bytes, and the stack frame. Needs nvcc, so it runs on the
machine with the card:

    python -m cuda_flashattention_torch.utils.ptxas_report \\
        --match 'ILi256E' [--sources 'flash_fwd*'] [--json ptxas.json]

(`ILi256E`: a first template argument of 256, as the names are mangled;
cu++filt writes it `(int)256`.)
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

from cuda_flashattention_torch import _build

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse(text: str) -> Dict[str, Dict[str, int]]:
    """{mangled entry: {regs, spill_stores, spill_loads, stack}} from
    ptxas's verbose output."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur["regs"] = int(m.group(1))
    return out


def demangle(names: List[str], nvcc: str) -> List[str]:
    """The names through cu++filt (beside nvcc), or as they are without
    it."""
    filt = Path(nvcc).with_name("cu++filt")
    if not filt.exists():
        found = shutil.which("cu++filt")
        if found is None:
            return names
        filt = Path(found)
    done = subprocess.run([str(filt)], input="\n".join(names), text=True,
                          capture_output=True, check=True).stdout
    return done.splitlines()


def report(match: str = "", sources: str = "*") -> List[Dict]:
    """One dict per kernel instance whose name matches `match`, of the
    sources whose file name matches the glob `sources`: source, kernel,
    regs, spill_stores, spill_loads, stack."""
    nvcc = _build.find_nvcc()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        srcs = [s for s in _build.sources()
                if fnmatch.fnmatch(s.name, sources)]
        procs = [subprocess.Popen(
            _build.compile_command(nvcc, s, Path(tmp) / f"{s.stem}.o")
            + ["-Xptxas", "-v"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for s in srcs]
        for src, p in zip(srcs, procs):
            text = p.communicate()[0]
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
            found = parse(text)
            names = list(found)
            for name, pretty in zip(names, demangle(names, nvcc)):
                if re.search(match, f"{name} {pretty}"):
                    rows.append(dict(source=src.name, kernel=pretty,
                                     **found[name]))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--match", default="",
                    help="regex on the demangled kernel name")
    ap.add_argument("--sources", default="*",
                    help="glob on the csrc/*.cu file names to compile")
    ap.add_argument("--json", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    rows = report(args.match, args.sources)
    for r in rows:
        print(f"{r['source']:22s} regs {r.get('regs', -1):3d} spill "
              f"{r.get('spill_stores', -1)}/{r.get('spill_loads', -1)} B "
              f"stack {r.get('stack', -1)}  {r['kernel']}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
