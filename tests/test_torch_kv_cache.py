"""The torch port's KV cache against the JAX package's: append (in place
here, functional there), the overflow error, and decode_step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops import kv_cache as jkv
from cuda_flashattention_torch.ops import kv_cache as tkv

B, HKV, H, MAX_LEN, D = 2, 2, 4, 16, 32


def _tokens(seed, t):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, HKV, t, D)).astype(np.float32),
            rng.uniform(-1, 1, (B, HKV, t, D)).astype(np.float32))


def _filled(chunks):
    jc = jkv.init_cache(B, HKV, MAX_LEN, D, dtype=jnp.float32)
    tc = tkv.init_cache(B, HKV, MAX_LEN, D, dtype=torch.float32)
    for seed, t in chunks:
        k, v = _tokens(seed, t)
        jc = jkv.append(jc, jnp.asarray(k), jnp.asarray(v))
        tc = tkv.append(tc, torch.from_numpy(k), torch.from_numpy(v))
    return jc, tc


def test_append_matches_jax_and_is_in_place():
    tc0 = tkv.init_cache(B, HKV, MAX_LEN, D, dtype=torch.float32)
    ptr = tc0.k.data_ptr()
    k, v = _tokens(0, 5)
    tc = tkv.append(tc0, torch.from_numpy(k), torch.from_numpy(v))
    assert tc is tc0 and tc.k.data_ptr() == ptr and tc.length == 5
    jc, tc = _filled([(0, 5), (1, 1), (2, 3)])
    assert tc.length == int(jc.length) == 9
    np.testing.assert_array_equal(np.asarray(jc.k), tc.k.numpy())
    np.testing.assert_array_equal(np.asarray(jc.v), tc.v.numpy())


def test_append_overflow_raises_and_writes_nothing():
    jc, tc = _filled([(0, 14)])
    k, v = _tokens(1, 3)
    with pytest.raises(ValueError, match="overflow"):
        jkv.append(jc, jnp.asarray(k), jnp.asarray(v))
    before = tc.k.clone()
    with pytest.raises(ValueError, match="overflow"):
        tkv.append(tc, torch.from_numpy(k), torch.from_numpy(v))
    assert tc.length == 14 and torch.equal(tc.k, before)


def test_decode_step_matches_jax():
    jc, tc = _filled([(0, 6), (1, 1)])
    q = np.random.default_rng(9).uniform(-1, 1, (B, H, D)).astype(np.float32)
    o_j, lse_j = jkv.decode_step(jnp.asarray(q), jc)
    o_t, lse_t = tkv.decode_step(torch.from_numpy(q), tc)
    assert np.max(np.abs(np.asarray(o_j) - o_t.numpy())) <= 1e-4
    assert np.max(np.abs(np.asarray(lse_j) - lse_t.numpy())) <= 1e-4


def test_quantized_cache_not_ported():
    with pytest.raises(NotImplementedError):
        tkv.init_cache(B, HKV, MAX_LEN, D, qtype="int8")
