"""ctypes bridge to the native (C++/OpenMP) exact-attention oracle.

Counterpart of cuda_flashattention_tpu/runtime/native.py. The repo's
`csrc/naive_attention.cpp` is built once with g++ -O3 -fopenmp into a
shared library, cached under a directory keyed by the source's hash, and
called through a plain C interface. It is the oracle independent of
PyTorch and of the port: the torch oracle (`ops/naive.py`) and this one
agreeing catches what either alone would not.

The cache is `$CFA_NATIVE_CACHE` when that is set (the variable the JAX
package reads), else `build/native/` beside this package, which git
ignores. Nothing is built at import: `available()` or the first call
builds. Inputs are torch tensors or arrays; outputs are fp32 numpy
arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from cuda_flashattention_torch import config

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "naive_attention.cpp"
DEFAULT_CACHE = Path(config.NATIVE_CACHE.default)


class NativeBuildError(RuntimeError):
    """The oracle could not be built or loaded (no g++, no source)."""


def cache_dir() -> Path:
    return Path(config.NATIVE_CACHE() or DEFAULT_CACHE)


def _build() -> Path:
    try:
        src = SOURCE.read_bytes()
    except OSError as e:
        raise NativeBuildError(f"no oracle source at {SOURCE}: {e}") from e
    cache = cache_dir()
    lib = cache / f"libcfa_naive_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cache.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=cache)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
           str(SOURCE), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise NativeBuildError(f"g++ not found: {e}") from e
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise NativeBuildError(
            f"native oracle build failed:\n{e.stderr}") from e
    os.replace(tmp, lib)  # a process building beside this one never loads
    # half a file
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    lib.cfa_naive_forward.argtypes = [f32p] * 5 + [i64] * 4 + [
        ctypes.c_float, ctypes.c_int, i64]
    lib.cfa_naive_forward.restype = None
    lib.cfa_naive_backward.argtypes = [f32p] * 7 + [i64] * 4 + [
        ctypes.c_float, ctypes.c_int, i64]
    lib.cfa_naive_backward.restype = None
    lib.cfa_num_threads.restype = ctypes.c_int
    return lib


def available() -> bool:
    """Whether the oracle builds and loads on this machine."""
    try:
        _lib()
        return True
    except (NativeBuildError, OSError):
        return False


def num_threads() -> int:
    """OpenMP threads the oracle runs on."""
    return int(_lib().cfa_num_threads())


def _f32(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _rows(a: np.ndarray, bh: int, n: int, d: int) -> np.ndarray:
    return np.ascontiguousarray(a.reshape(bh, n, d))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _shape(q, k):
    lead = q.shape[:-2]
    nq, d = q.shape[-2:]
    bh = int(np.prod(lead, dtype=np.int64)) if lead else 1
    return lead, bh, nq, k.shape[-2], d


def naive_attention_native(
    q, k, v, scale: Optional[float] = None, causal: bool = False,
    kv_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact attention forward: q [..., Nq, d], k/v [..., Nk, d] with the
    same leading dims → (O, LSE) fp32 with the input's leading dims."""
    q, k, v = _f32(q), _f32(k), _f32(v)
    lead, bh, nq, nk, d = _shape(q, k)
    scale = 1.0 / float(np.sqrt(d)) if scale is None else float(scale)
    qa, ka, va = _rows(q, bh, nq, d), _rows(k, bh, nk, d), _rows(v, bh, nk, d)
    o = np.zeros((bh, nq, d), np.float32)
    lse = np.zeros((bh, nq), np.float32)
    _lib().cfa_naive_forward(_ptr(qa), _ptr(ka), _ptr(va), _ptr(o), _ptr(lse),
                             bh, nq, nk, d, ctypes.c_float(scale),
                             int(causal), int(kv_offset))
    return o.reshape(*lead, nq, d), lse.reshape(*lead, nq)


def naive_attention_backward_native(
    q, k, v, do, scale: Optional[float] = None, causal: bool = False,
    kv_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact attention backward → (dQ, dK, dV) fp32, shapes as the
    inputs'."""
    q, k, v, do = _f32(q), _f32(k), _f32(v), _f32(do)
    lead, bh, nq, nk, d = _shape(q, k)
    scale = 1.0 / float(np.sqrt(d)) if scale is None else float(scale)
    qa, ka, va = _rows(q, bh, nq, d), _rows(k, bh, nk, d), _rows(v, bh, nk, d)
    doa = _rows(do, bh, nq, d)
    dq = np.zeros((bh, nq, d), np.float32)
    dk = np.zeros((bh, nk, d), np.float32)
    dv = np.zeros((bh, nk, d), np.float32)
    _lib().cfa_naive_backward(_ptr(qa), _ptr(ka), _ptr(va), _ptr(doa),
                              _ptr(dq), _ptr(dk), _ptr(dv), bh, nq, nk, d,
                              ctypes.c_float(scale), int(causal),
                              int(kv_offset))
    return (dq.reshape(*lead, nq, d), dk.reshape(*lead, nk, d),
            dv.reshape(*lead, nk, d))
