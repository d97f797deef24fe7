"""Build the package's CUDA kernels at first use and bind them with ctypes.

`csrc/*.cu` are compiled by `nvcc` for Hopper (`sm_90a`), one process
per source, all started together, and linked into one shared library with
a plain C interface, under `build/` beside the sources (a directory git
ignores). The library's file name carries a hash of the sources, the
headers they share (`csrc/*.cuh`) and the flags, so an edited kernel is
rebuilt and a stale one is never loaded.
Each C entry point returns `cudaGetLastError()` after its launch;
`check()` turns a non-zero code into an exception.

Nothing here runs at import: `library()` builds and loads on its first
call, which only a wrapper handed a CUDA tensor makes; `ensure_built()`
builds without loading (the multi-process launcher's step before it
starts its processes).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# where the CUDA toolkit installs itself when neither CUDA_HOME nor PATH
# names it
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)
_PP = ctypes.POINTER(ctypes.c_void_p)
_D = ctypes.c_double
_IP = ctypes.POINTER(ctypes.c_int)

# C signatures of the entry points (all return an int cudaError_t).
SIGNATURES = {
    # ptrs[10] (q, k, v, k_scale, v_scale, q_seg, kv_seg, guard, o, lse),
    # B, H, Hkv, Nq, Nk, D, strides[9] (q/k/v: batch, head, row, in
    # elements), k_type, v_type (0 bf16, 1 int8, 2 fp8, 3 fp32: with an
    # fp32 q), q_f32 (an fp32 q, over fp32, bf16 or one-byte K/V), causal,
    # window, kv_offset, out_type (O in 0 bf16, 1 fp32, 2 fp16), kn (keys
    # of a tile: 64, or 128 over bf16 q/k/v at d <= 128, and 32 for an
    # fp32 q over fp32 k/v at d = 256), stream
    "cfa_flash_fwd": [_PP, _I, _I, _I, _I, _I, _I, _LP,
                      _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # ptrs[10] (q, k, v, k_scale, v_scale, q_factor, c, n_loose, o, lse),
    # B, H, Hkv, Nq, Nk, D, strides[9], k_type, v_type, q_f32, qq, causal,
    # window, kv_offset, out_type, kn, stream
    "cfa_flash_fwd_bound": [_PP, _I, _I, _I, _I, _I, _I, _LP,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # ptrs[12] (q, k, v, k_scale, v_scale, q_factor, c, l_acc, o_acc,
    # n_loose, o, lse), B, H, Hkv, Nq, Nk, D, strides[9], k_type, v_type,
    # q_f32, qq, causal, window, kv_offset, out_type, span, stream
    "cfa_flash_fwd_kmajor": [_PP, _I, _I, _I, _I, _I, _I, _LP,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, k_scale, v_scale, q_sigma, lengths, windows, o, lse, part,
    # tickets (the split's scratch, or NULL), B, H, Hkv, max_n, D, k_type,
    # v_type (0 bf16, 1 int8, 2 fp8, 3 fp32), qq, q_f32 (q and o fp32, else
    # bf16), scale, window, split, stream
    "cfa_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                   _I, _P],
    # q, k_pages, v_pages, k_scale, v_scale, q_sigma, page_table, lengths,
    # windows, o, lse, part, tickets, B, H, Hkv, page, max_pages, D, k_type,
    # v_type, qq, q_f32, scale, window, split, stream
    "cfa_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _I, _I, _P],
    # q, k, v, o, B, H, Nq, Nk, D, strides[9] (q/k/v: batch, head, row),
    # causal, n_sub, f32 (fp32 q/k/v and o, else bf16), stream
    "cfa_fa1": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LP, _I, _I, _I, _P],
    # the backward's prologue: o, dO, delta (out), dq_acc (zeroed, or NULL
    # on the split path), B, H, Nq, D, strides[6] (o/dO: batch, head, row),
    # o_f32, do_f32 (each fp32, else bf16), stream
    "cfa_bwd_delta": [_P, _P, _P, _P, _I, _I, _I, _I, _LP, _I, _I, _P],
    # q, k, v, dO, lse, delta, q_seg, kv_seg (int32 ids or NULL), dk, dv,
    # dq_acc (NULL: K2, else K4), B, H, Hkv, Nq, Nk, D, strides[12]
    # (q/k/v/dO: batch, head, row), scale, causal, window, kv_offset, f32
    # (fp32 q/k/v/dO and dK/dV, else bf16), stream
    "cfa_flash_bwd_kv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _LP, _D, _I, _I, _I, _I,
                         _P],
    # q, k, v, dO, lse, delta, q_seg, kv_seg, dq, B, H, Hkv, Nq, Nk, D,
    # strides[12], scale, causal, window, kv_offset, f32 (fp32 q/k/v/dO
    # and dq, else bf16), stream
    "cfa_flash_bwd_q": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _LP, _D, _I, _I, _I, _I,
                        _P],
    # x, w, out (this launch's shards, W and o), buf[n], flags[n] (per-rank
    # device pointers), n_shards, local[n_local] (the ranks this launch
    # runs), n_local, L, D, grid (CTAs per rank, common to the ring), epoch,
    # sys (flags at system scope), f32 (fp32 x and w), device, stream
    "cfa_device_ring": [_P, _P, _P, _PP, _PP, _I, _IP, _I, _I, _I, _I,
                        ctypes.c_ulonglong, _I, _I, _I, _P],
    # D, sys, f32, device, out: CTAs of that build the card holds at once
    "cfa_device_ring_resident": [_I, _I, _I, _I, _IP],
    # device, peer: cudaDeviceEnablePeerAccess(peer) on `device`
    "cfa_enable_peer_access": [_I, _I],
    # device, bytes, ptr (out), handle (out, 64 bytes): a zeroed cudaMalloc
    # and its IPC handle
    "cfa_ipc_alloc": [_I, _L, _PP, _P],
    # device, handle (64 bytes), ptr (out): another process's allocation
    "cfa_ipc_open": [_I, _P, _PP],
    # device, ptr: unmap an opened allocation / free an own one
    "cfa_ipc_close": [_I, _P],
    "cfa_ipc_free": [_I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
# each source's nvcc seconds in the last build of this process
source_seconds: Dict[str, float] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    """The headers the sources include (hashed, not compiled)."""
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then DEFAULT_CUDA_HOME/bin.
    Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        f"nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of "
        f"cuda_flashattention_torch need the CUDA toolkit to build")


def compile_command(nvcc: str, src: Path, obj: Path) -> List[str]:
    """nvcc command compiling one source into a relocatable object."""
    return [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(nvcc: str, objs: List[Path], out: Path) -> List[str]:
    """nvcc command linking the objects into the shared library."""
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
            *[str(o) for o in objs]]


def _library_path(srcs: List[Path]) -> Path:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for s in [*srcs, *headers()]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libcfa_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> List[float]:
    """Run the commands concurrently (a thread waits on each); raise with
    nvcc's output if any fails. Every process started is waited for.
    Returns each command's seconds."""
    def one(cmd):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        return p, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        done = list(pool.map(one, cmds))
    for cmd, (p, _) in zip(cmds, done):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{p.stdout}")
    return [t for _, t in done]


def _build(out: Path) -> None:
    global build_seconds
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build in a private directory and rename the library into place, so
    # a concurrent process never loads a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sources()
        objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
        secs = _run_all([compile_command(nvcc, s, o)
                         for s, o in zip(srcs, objs)])
        source_seconds.clear()
        source_seconds.update({s.name: t for s, t in zip(srcs, secs)})
        lib = Path(tmp) / out.name
        _run_all([link_command(nvcc, objs, lib)])
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0


def ensure_built() -> Path:
    """The kernels' shared library on disk, built if it is not there. The
    build holds a lock file beside the libraries, so that of several
    processes starting at once (a multi-process launch) one runs nvcc and
    the others wait for its library."""
    path = _library_path(sources())
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            _build(path)
    return path


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = ensure_built()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cfa_error_string.argtypes = [ctypes.c_int]
            lib.cfa_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        name = library().cfa_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")
