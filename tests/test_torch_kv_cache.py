"""The torch port's KV cache against the JAX package's: append (in place
here, functional there), the overflow error, and decode_step, for
unquantized, int8, fp8 and mixed storage. After the same appends the
quantized caches hold identical codes (fp8 as raw bytes) and scales
within 1e-6 relative; decode_step agrees within 1e-4 in fp32 (5e-3 where
an fp8 array is read with a bf16 compute dtype, see test_torch_decode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops import kv_cache as jkv
from cuda_flashattention_torch.models.convert import kv_cache_from_numpy
from cuda_flashattention_torch.ops import kv_cache as tkv

B, HKV, H, MAX_LEN, D = 2, 2, 4, 16, 32


def _tokens(seed, t):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, HKV, t, D)).astype(np.float32),
            rng.uniform(-1, 1, (B, HKV, t, D)).astype(np.float32))


def _filled(chunks, qtype=None):
    jc = jkv.init_cache(B, HKV, MAX_LEN, D, qtype=qtype, dtype=jnp.float32)
    tc = tkv.init_cache(B, HKV, MAX_LEN, D, qtype=qtype,
                        dtype=torch.float32, device="cpu")
    for seed, t in chunks:
        k, v = _tokens(seed, t)
        jc = jkv.append(jc, jnp.asarray(k), jnp.asarray(v))
        tc = tkv.append(tc, torch.from_numpy(k), torch.from_numpy(v))
    return jc, tc


def test_append_matches_jax_and_is_in_place():
    tc0 = tkv.init_cache(B, HKV, MAX_LEN, D, dtype=torch.float32,
                         device="cpu")
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


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_quantized_append_matches_jax(qtype):
    jc, tc = _filled([(0, 5), (1, 1), (2, 3)], qtype)
    assert tc.quantized and tc.length == int(jc.length) == 9
    assert tc.k.dtype == (torch.float8_e4m3fn if qtype == "fp8"
                          else torch.int8)
    assert tc.v.dtype == (torch.int8 if qtype == "int8"
                          else torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bytes(jc.k), _bytes(tc.k))
    np.testing.assert_array_equal(_bytes(jc.v), _bytes(tc.v))
    for a, b in ((jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=0)
    # rows past the write head keep their initial codes 0 and scales 1
    assert np.all(_bytes(tc.k)[:, :, 9:] == 0)
    assert torch.all(tc.v_scale[:, :, 9:] == 1)


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_quantized_append_overflow_raises_and_writes_nothing(qtype):
    _, tc = _filled([(0, 14)], qtype)
    k, v = _tokens(1, 3)
    before, scales = tc.k.clone(), tc.k_scale.clone()
    with pytest.raises(ValueError, match="overflow"):
        tkv.append(tc, torch.from_numpy(k), torch.from_numpy(v))
    assert tc.length == 14 and torch.equal(tc.k_scale, scales)
    assert np.array_equal(_bytes(tc.k), _bytes(before))


@pytest.mark.parametrize("kw", [dict(), dict(window=4),
                                dict(quantize_q=True)])
@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_quantized_decode_step_matches_jax(qtype, kw):
    jc, tc = _filled([(0, 6), (1, 1), (3, 4)], qtype)
    q = np.random.default_rng(9).uniform(-1, 1, (B, H, D)).astype(np.float32)
    o_j, lse_j = jkv.decode_step(jnp.asarray(q), jc, **kw)
    o_t, lse_t = tkv.decode_step(torch.from_numpy(q), tc, **kw)
    # quantize_q computes in bf16, where the JAX CPU path reads fp8 V
    # through its subnormal-flushing cast
    gate = 5e-3 if (kw.get("quantize_q") and qtype == "mixed") else 1e-4
    assert np.max(np.abs(np.asarray(o_j) - o_t.numpy())) <= gate
    assert np.max(np.abs(np.asarray(lse_j) - lse_t.numpy())) <= gate


@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
def test_cache_carried_across_from_numpy(qtype):
    """kv_cache_from_numpy rebuilds a JAX cache's state on the port's
    side: the same decode_step answer, then the same append."""
    jc, tc = _filled([(0, 7)], qtype)

    def raw(x):
        x = np.asarray(x)
        return x.view(np.uint8) if x.dtype.itemsize == 1 and \
            x.dtype != np.int8 else x

    carried = kv_cache_from_numpy(
        raw(jc.k), raw(jc.v),
        None if qtype is None else np.asarray(jc.k_scale),
        None if qtype is None else np.asarray(jc.v_scale),
        length=int(jc.length))
    assert carried.length == 7 and carried.k.dtype == tc.k.dtype
    assert carried.v.dtype == tc.v.dtype
    assert carried.quantized == (qtype is not None)
    q = torch.from_numpy(
        np.random.default_rng(3).uniform(-1, 1, (B, H, D)).astype(np.float32))
    o_c, _ = tkv.decode_step(q, carried)
    o_t, _ = tkv.decode_step(q, tc)
    assert torch.max(torch.abs(o_c - o_t)) <= 1e-6
    k, v = _tokens(5, 2)
    tkv.append(carried, torch.from_numpy(k), torch.from_numpy(v))
    tkv.append(tc, torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(_bytes(carried.k), _bytes(tc.k))


def test_init_cache_rejects_unknown_qtype():
    with pytest.raises(ValueError, match="qtype must be one of"):
        tkv.init_cache(B, HKV, MAX_LEN, D, qtype="int4", device="cpu")


def test_quantized_cache_not_ported():
    """What is still not ported over a quantized cache: reading it back
    in a later prefill chunk (the forward kernel's quantized form)."""
    from cuda_flashattention_torch.models import transformer as ttf
    cfg = ttf.TransformerConfig(vocab_size=31, d_model=32, n_layers=1,
                                n_heads=2, n_kv_heads=1, d_head=16, d_ff=64,
                                dtype=torch.float32)
    model = ttf.Transformer(cfg, generator=torch.Generator().manual_seed(0))
    caches = ttf.init_caches(cfg, 1, 8, qtype="int8", device="cpu")
    tokens = torch.arange(4, dtype=torch.int32)[None]
    ttf.prefill_chunk(model, tokens[:, :2], 0, caches)  # start 0 is ported
    assert caches[0].length == 2 and caches[0].quantized
    with pytest.raises(NotImplementedError, match="forward kernel"):
        ttf.prefill_chunk(model, tokens[:, 2:], 2, caches)
