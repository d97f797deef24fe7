"""The port's bridge to the native C++ oracle (`runtime/native.py`) against
the port's torch oracle (`ops/naive.py`), as tests/test_native_oracle.py
holds the JAX package's bridge to its JAX oracle: a hand-checked 2x2 case,
forward and backward, causal or not, kv_offset, the ladder's 5096-row
shape. fp32; O and gradients within 1e-5, LSE within 1e-4 (1e-4 on O at
5096 keys). Skips when the oracle cannot be built here (no g++)."""

import numpy as np
import pytest
import torch

from cuda_flashattention_torch.ops.naive import (
    naive_attention,
    naive_attention_backward,
)
from cuda_flashattention_torch.runtime import native
from cuda_flashattention_torch.utils.testing import (
    assert_close,
    seeded_random,
)


@pytest.fixture
def oracle():
    if not native.available():
        pytest.skip("the native oracle does not build here (g++/OpenMP)")
    return native


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_hardcoded_2x2(oracle):
    q = np.eye(2, dtype=np.float32)
    v = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    o, lse = oracle.naive_attention_native(q, q, v, scale=1.0)
    e = np.exp(1.0)
    w = e / (e + 1.0)
    expected = np.array([[w * 1 + (1 - w) * 3, w * 2 + (1 - w) * 4],
                         [(1 - w) * 1 + w * 3, (1 - w) * 2 + w * 4]])
    assert_close(o, expected, 1e-5, "native 2x2")
    assert_close(lse, np.log(e + 1.0) * np.ones(2), 1e-5, "native LSE")


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_the_torch_oracle(oracle, causal):
    q = seeded_random((2, 3, 64, 32), seed=1)
    k = seeded_random((2, 3, 48, 32), seed=2)
    v = seeded_random((2, 3, 48, 32), seed=3)
    o_n, lse_n = oracle.naive_attention_native(*_t(q, k, v), causal=causal)
    o_t, lse_t = naive_attention(*_t(q, k, v), causal=causal)
    assert_close(o_n, o_t, 1e-5, "forward O")
    live = torch.isfinite(lse_t).numpy() & (lse_t.numpy() > -60)
    assert_close(lse_n[live], lse_t.numpy()[live], 1e-4, "forward LSE")


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_the_torch_oracle(oracle, causal):
    q = seeded_random((1, 2, 48, 16), seed=4)
    k = seeded_random((1, 2, 32, 16), seed=5)
    v = seeded_random((1, 2, 32, 16), seed=6)
    do = seeded_random((1, 2, 48, 16), seed=7)
    got = oracle.naive_attention_backward_native(q, k, v, do, causal=causal)
    want = naive_attention_backward(*_t(q, k, v, do), causal=causal)
    for name, g, w in zip(("dQ", "dK", "dV"), got, want):
        assert_close(g, w, 1e-5, name)


def test_kv_offset(oracle):
    q = seeded_random((1, 1, 16, 8), seed=8)
    k = seeded_random((1, 1, 32, 8), seed=9)
    v = seeded_random((1, 1, 32, 8), seed=10)
    o_n, _ = oracle.naive_attention_native(q, k, v, causal=True,
                                           kv_offset=8)
    o_t, _ = naive_attention(*_t(q, k, v), causal=True, kv_offset=8)
    assert_close(o_n, o_t, 1e-5, "kv_offset O")


def test_ladder_shape_5096(oracle):
    q = seeded_random((1, 1, 5096, 64), seed=11) * 0.1
    k = seeded_random((1, 1, 5096, 64), seed=12) * 0.1
    v = seeded_random((1, 1, 5096, 64), seed=13)
    o_n, _ = oracle.naive_attention_native(*_t(q, k, v), scale=1.0)
    o_t, _ = naive_attention(*_t(q, k, v), scale=1.0)
    assert_close(o_n, o_t, 1e-4, "5096 O")


def test_threads_reported(oracle):
    assert oracle.num_threads() >= 1


def test_cache_follows_the_environment(oracle, monkeypatch, tmp_path):
    monkeypatch.setenv("CFA_NATIVE_CACHE", str(tmp_path))
    assert native.cache_dir() == tmp_path
    monkeypatch.delenv("CFA_NATIVE_CACHE")
    assert native.cache_dir() == native.DEFAULT_CACHE
