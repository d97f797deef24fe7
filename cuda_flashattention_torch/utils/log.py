"""Process-prefixed logging (counterpart of
cuda_flashattention_tpu/utils/log.py).

Every record is prefixed `[pN]` with the process index, so that the
output of several processes stays attributable: the `torch.distributed`
rank once a process group is initialised, else 0 (the port's mesh runs
its ranks in one process).

    from cuda_flashattention_torch.utils.log import get_logger
    log = get_logger(__name__)
    log.info("ring step %d: kv block %d", step, kv_idx)

Knobs (config.py): CFA_LOG_LEVEL (default INFO), CFA_LOG_ALL_PROCS=1 to
log from every process (default: process 0 only, the reference's
rank-0-prints convention).
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

from cuda_flashattention_torch import config

_BASE = "cuda_flashattention_torch"
_CONFIGURED = False


def process_index() -> int:
    """The `torch.distributed` rank when a process group is initialised,
    else 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class _ProcessFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        return config.LOG_ALL_PROCS.as_bool or process_index() == 0


class _ProcessFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        record.proc = process_index()
        return super().format(record)


class _StderrHandler(logging.StreamHandler):
    """A StreamHandler that finds sys.stderr when it emits, not when it is
    made, so that a redirection installed later (pytest's capture, say)
    receives the records."""

    def __init__(self) -> None:
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):
        raise AttributeError("the handler writes to sys.stderr as it is when "
                             "a record comes: redirect sys.stderr instead")


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    handler = _StderrHandler()
    handler.setFormatter(_ProcessFormatter(
        "[p%(proc)d] %(asctime)s %(levelname)s %(name)s: %(message)s",
        datefmt="%H:%M:%S"))
    handler.addFilter(_ProcessFilter())
    root = logging.getLogger(_BASE)
    root.addHandler(handler)
    root.setLevel(config.LOG_LEVEL().upper())
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """The package's logger `name` (under `cuda_flashattention_torch`)."""
    _configure()
    if name and not name.startswith(_BASE):
        name = f"{_BASE}.{name}"
    return logging.getLogger(name or _BASE)
