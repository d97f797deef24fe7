"""Test utilities: seeded fixtures and a max-abs tolerance check.

Counterpart of cuda_flashattention_tpu/utils/testing.py. The fixtures
are made with numpy from a seed, so a parity test hands the very same
values to the JAX package and to this one.
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
