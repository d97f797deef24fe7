"""The port's configuration: its environment knobs, each with one
definition, a default and a docstring (counterpart of
cuda_flashattention_tpu/config.py, with the knobs that apply on the
card). Kernel tiles are arguments (`ops.common.BlockSizes`, the tuner of
`utils/autotune.py`), not environment state.

    from cuda_flashattention_torch import config
    path = config.AUTOTUNE_CACHE()

    python -m cuda_flashattention_torch.config   # every knob and its value
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: str
    doc: str

    def __call__(self) -> str:
        return os.environ.get(self.name, self.default)

    @property
    def as_bool(self) -> bool:
        return self() == "1"

    @property
    def as_int(self) -> int:
        return int(self())


LOG_LEVEL = Knob(
    "CFA_LOG_LEVEL", "INFO",
    "Log level of the package's logger (utils/log.py).")

LOG_ALL_PROCS = Knob(
    "CFA_LOG_ALL_PROCS", "0",
    "1 → every process logs; default only process 0 (utils/log.py: the "
    "reference's rank-0-prints convention).")

AUTOTUNE_CACHE = Knob(
    "CFA_AUTOTUNE_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "cfa_torch",
                 "autotune.json"),
    "On-disk cache of the measured tiles, split sizes and page sizes "
    "(utils/autotune.py), keyed by the card's name and the kernel "
    "library's hash.")

NATIVE_CACHE = Knob(
    "CFA_NATIVE_CACHE",
    str(Path(__file__).resolve().parent / "build" / "native"),
    "Build directory of the native C++ oracle (runtime/native.py).")

LADDER_SEQ = Knob(
    "CFA_LADDER_SEQ", "5096",
    "Sequence length of the ladder's ring stages (examples/_ladder.py: "
    "the reference's 5096; the CPU tests use a shorter one).")


def all_knobs() -> Dict[str, Knob]:
    return {k: v for k, v in globals().items() if isinstance(v, Knob)}


def describe() -> str:
    lines = []
    for name, knob in sorted(all_knobs().items()):
        cur = knob()
        mark = "" if cur == knob.default else f"  (set: {cur!r})"
        lines.append(f"{knob.name:24s} default={knob.default!r}{mark}\n"
                     f"    {knob.doc}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(describe())
