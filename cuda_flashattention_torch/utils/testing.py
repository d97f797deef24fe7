"""Test utilities: seeded fixtures, the reference's tolerance comparison
and a max-abs tolerance check.

Counterpart of cuda_flashattention_tpu/utils/testing.py. The fixtures
are made with numpy from a seed, so a parity test hands the very same
values to the JAX package and to this one. Every function takes torch
tensors (any dtype, any device) or array-likes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def seeded_random(shape, seed: int = 42, lo: float = -0.5,
                  hi: float = 0.5) -> np.ndarray:
    """Seeded uniform fp32 data in [lo, hi): the same values as the JAX
    package's `seeded_random`."""
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def random_qkv(
    batch: int, heads: int, nq: int, nk: int, d: int, seed: int = 42,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B,H,Nq,d], k/v [B,H,Nk,d] with the JAX package's `random_qkv`
    values (seeds seed, seed+1, seed+2)."""
    q = seeded_random((batch, heads, nq, d), seed)
    k = seeded_random((batch, heads, nk, d), seed + 1)
    v = seeded_random((batch, heads, nk, d), seed + 2)
    return tuple(torch.from_numpy(a).to(dtype) for a in (q, k, v))


def _as_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x).astype(np.float64)


def compare_outputs(actual, expected, rtol: float = 1e-3, atol: float = 1.0,
                    name: str = "output", max_print: int = 10,
                    verbose: bool = True) -> bool:
    """The reference's relative + absolute check: an element passes if
    |a − e| <= atol or |a − e| <= rtol·|e| (defaults rtol 1e-3, atol 1.0,
    the reference's). Prints the count and the first `max_print` misses
    (index, actual, expected, diff) unless `verbose` is False; returns
    whether every element passed."""
    a, e = _as_f64(actual), _as_f64(expected)
    if a.shape != e.shape:
        raise ValueError(f"{name}: shape mismatch {a.shape} vs {e.shape}")
    diff = np.abs(a - e)
    ok = (diff <= atol) | (diff <= rtol * np.abs(e))
    n_bad = int((~ok).sum())
    if n_bad and verbose:
        print(f"[compare_outputs] {name}: {n_bad}/{a.size} mismatches "
              f"(rtol={rtol}, atol={atol})")
        for idx in np.argwhere(~ok)[:max_print]:
            t = tuple(int(i) for i in idx)
            print(f"  at {t}: actual={a[t]:.6g} expected={e[t]:.6g} "
                  f"diff={diff[t]:.3g}")
    return n_bad == 0


def identity_qk_fixture(n: int = 4, d: int = 4
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's hand-checkable case, for scale 1.0: Q = K with a 1
    at column i % d of row i, V the row-major ramp 0 .. n·d − 1 over n·d
    (fp32 numpy arrays [n, d])."""
    q = np.zeros((n, d), np.float32)
    for i in range(n):
        q[i, i % d] = 1.0
    v = np.arange(n * d, dtype=np.float32).reshape(n, d) / float(n * d)
    return q, q.copy(), v


def print_matrix(name: str, m, max_rows: int = 8, max_cols: int = 8) -> None:
    """Print `m` cut to its first `max_rows` rows (its leading dim) and
    `max_cols` columns (the rest flattened), with "..." when cut."""
    a = _as_f64(m) if isinstance(m, torch.Tensor) else np.asarray(m)
    r = a.shape[0] if a.ndim >= 1 else 1
    print(f"{name} [{a.shape}]:")
    view = a.reshape(r, -1)[:max_rows, :max_cols]
    for row in view:
        print("  " + " ".join(f"{x:9.4f}" for x in row))
    if r > max_rows or view.shape[1] < np.prod(a.shape[1:], dtype=int):
        print("  ...")


def max_abs(x) -> float:
    a = _as_f64(x)
    return float(np.max(np.abs(a))) if a.size else 0.0


def max_abs_diff(actual, expected) -> float:
    a, e = _as_f64(actual), _as_f64(expected)
    if a.shape != e.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {e.shape}")
    return float(np.max(np.abs(a - e))) if a.size else 0.0


def assert_close(actual, expected, tol: float, name: str = "output") -> None:
    """Max-abs-diff gate: raises unless max |actual − expected| <= tol.
    Takes torch tensors (any dtype, any device) and array-likes, JAX
    arrays included."""
    d = max_abs_diff(actual, expected)
    if not d <= tol:
        a, e = _as_f64(actual).ravel(), _as_f64(expected).ravel()
        i = int(np.argmax(np.abs(a - e)))
        raise AssertionError(
            f"{name}: max diff {d:.3e} > tol {tol:.3e} "
            f"(flat idx {i}: actual={a[i]:.6g} expected={e[i]:.6g})")
