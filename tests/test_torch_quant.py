"""The torch port's K/V quantizer against the JAX package's
(cuda_flashattention_tpu/ops/quant.py), on the same numpy inputs.

Gates: int8 and fp8 codes identical (fp8 compared as raw bytes), scales
within 1e-6 relative; attention over the dequantised round trip within
the JAX package's own gates of the fp32 oracle (1e-3 at int8, 1e-2 at fp8,
5e-3 mixed, at its canonical shape: 512 keys, d = 64, values in
[-0.5, 0.5]); and the native e4m3 → fp32 conversion exact on all 256
codes."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops import quant as jq
from cuda_flashattention_tpu.ops.common import (
    quantize_q_per_head as jax_quantize_q,
)
from cuda_flashattention_torch.ops import quant as tq
from cuda_flashattention_torch.ops.common import (
    BlockSizes,
    quantize_q_per_head,
)
from cuda_flashattention_torch.ops.naive import naive_attention

SCALE_RTOL = 1e-6
ROUND_TRIP = {"int8": 1e-3, "fp8": 1e-2, "mixed": 5e-3}


def _codes(x) -> np.ndarray:
    """Stored values as raw bytes, from a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _data(seed, shape, lo=-0.5, hi=0.5):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("qtype", ["int8", "fp8"])
@pytest.mark.parametrize("seed,shape,span", [
    (0, (2, 3, 17, 32), 0.5),
    (1, (1, 2, 64, 64), 3.0),
    (2, (4, 5, 16), 1e-3),
])
def test_quantize_tensor_matches_jax(qtype, seed, shape, span):
    x = _data(seed, shape, -span, span)
    x[..., 0, :] = 0.0  # an all-zero row: codes 0, scale 1e-12 / qmax
    q_j, s_j = jq.quantize_tensor(jnp.asarray(x), qtype)
    q_t, s_t = tq.quantize_tensor(torch.from_numpy(x), qtype)
    assert q_t.dtype == tq._storage_dtype(qtype)
    assert tuple(s_t.shape) == shape[:-1] and s_t.dtype == torch.float32
    np.testing.assert_array_equal(_codes(q_j), _codes(q_t))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                               rtol=SCALE_RTOL, atol=0)
    assert np.all(_codes(q_t)[..., 0, :] == 0)
    assert np.all(s_t.numpy()[..., 0] > 0)


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_quantize_kv_matches_jax_and_round_trips(qtype):
    q, k, v = (_data(s, (1, 1, 512, 64)) for s in (2, 3, 4))
    kv_j = jq.quantize_kv(jnp.asarray(k), jnp.asarray(v), qtype)
    kv_t = tq.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qtype)
    assert kv_t.qtype == kv_j.qtype == qtype
    assert tuple(kv_t.shape) == k.shape
    want_k = torch.float8_e4m3fn if qtype == "fp8" else torch.int8
    want_v = torch.int8 if qtype == "int8" else torch.float8_e4m3fn
    assert kv_t.k_q.dtype == want_k and kv_t.v_q.dtype == want_v
    np.testing.assert_array_equal(_codes(kv_j.k_q), _codes(kv_t.k_q))
    np.testing.assert_array_equal(_codes(kv_j.v_q), _codes(kv_t.v_q))
    np.testing.assert_allclose(kv_t.k_scale.numpy(), np.asarray(kv_j.k_scale),
                               rtol=SCALE_RTOL, atol=0)
    kd, vd = kv_t.dequantize()
    kd_j, vd_j = kv_j.dequantize()
    # the scales may differ in their last bit (XLA divides by qmax as a
    # multiplication by its reciprocal), and the products with them
    np.testing.assert_allclose(kd.numpy(), np.asarray(kd_j),
                               rtol=SCALE_RTOL, atol=0)
    np.testing.assert_allclose(vd.numpy(), np.asarray(vd_j),
                               rtol=SCALE_RTOL, atol=0)
    o, _ = naive_attention(torch.from_numpy(q), kd, vd)
    o_ref, _ = naive_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert torch.max(torch.abs(o - o_ref)).item() <= ROUND_TRIP[qtype]


def test_fp8_values_convert_exactly_on_all_codes():
    """torch's e4m3 → fp32 (and → bf16) is the exact value of every code,
    subnormals included: the port needs no bit-cast decode."""
    codes = np.arange(256, dtype=np.uint8)
    want = codes.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    t = torch.from_numpy(codes).view(torch.float8_e4m3fn)
    got, got_bf16 = t.float().numpy(), t.to(torch.bfloat16).float().numpy()
    finite = np.isfinite(want)
    assert finite.sum() == 254 and np.all(np.isnan(got[~finite]))
    np.testing.assert_array_equal(got[finite], want[finite])
    np.testing.assert_array_equal(got_bf16[finite], want[finite])
    # signed zeros and the 14 subnormal codes keep sign and value
    sub = (codes & 0x7F) < 8
    assert np.all(np.signbit(got[sub]) == (codes[sub] >= 0x80))
    assert np.count_nonzero(got[sub]) == 14


def test_pair_qtypes_and_per_tensor_errors():
    assert tq._pair_qtypes("mixed") == ("int8", "fp8")
    assert tq._pair_qtypes("fp8") == ("fp8", "fp8")
    with pytest.raises(ValueError, match="qtype must be one of"):
        tq._pair_qtypes("int4")
    for fn in (tq._qmax, tq._storage_dtype):
        with pytest.raises(ValueError, match="per-tensor"):
            fn("mixed")
    assert tq._qmax("int8") == jq._qmax("int8") == tq.INT8_MAX
    assert tq._qmax("fp8") == jq._qmax("fp8") == tq.FP8_MAX


@pytest.mark.parametrize("shape,axes", [((2, 4, 32), (-1,)),
                                        ((2, 4, 9, 16), (0, 2, 3))])
def test_quantize_q_per_head_matches_jax(shape, axes):
    q = _data(5, shape, -2.0, 2.0)
    q[0, 1] = 0.0  # an all-zero head
    q8_j, sq_j = jax_quantize_q(jnp.asarray(q), axes)
    q8_t, sq_t = quantize_q_per_head(torch.from_numpy(q), axes)
    assert q8_t.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(q8_j), q8_t.numpy())
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j),
                               rtol=SCALE_RTOL, atol=0)


def test_flash_attention_quantized_names_what_it_waits_for():
    """It waits for nothing any more: it is the forward over the pair's
    codes and scales, and takes the forward's block sizes (refusing what
    is not a `BlockSizes`; an unbuilt tile runs at the nearest built
    one)."""
    kv = tq.quantize_kv(torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 4, 8))
    o, lse = tq.flash_attention_quantized(torch.zeros(1, 1, 4, 8), kv)
    assert tuple(o.shape) == (1, 1, 4, 8) and torch.all(o == 0)
    assert torch.allclose(lse, torch.full((1, 1, 4), float(np.log(4.0))))
    with pytest.raises(TypeError, match="BlockSizes"):
        tq.flash_attention_quantized(torch.zeros(1, 1, 4, 8), kv,
                                     block_sizes=object())
    o1, _ = tq.flash_attention_quantized(torch.zeros(1, 1, 4, 8), kv,
                                         block_sizes=BlockSizes(block_k=128))
    assert torch.equal(o1, o)
    o2, _ = tq.flash_attention_quantized(torch.zeros(1, 1, 4, 8), kv,
                                         block_sizes=BlockSizes())
    assert torch.equal(o2, o)


@pytest.mark.parametrize("quantize_q", [False, True])
@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
@pytest.mark.parametrize("kw", [dict(), dict(causal=True),
                                dict(causal=True, kv_offset=30)])
def test_flash_attention_quantized_matches_jax(qtype, kw, quantize_q):
    """`flash_attention_quantized` on both sides with its default
    "auto" softmax, which is the bound strategy over a quantized pair on
    either side. bf16 Q (so that fp8 keys take the K-major form and, under
    quantize_q, the int8 re-grid), GQA 4 over 2, ragged; gate 5e-3."""
    q = _data(21, (1, 4, 40, 32), -1.0, 1.0)
    k = _data(22, (1, 2, 70, 32), -1.0, 1.0)
    v = _data(23, (1, 2, 70, 32), -1.0, 1.0)
    jkv = jq.quantize_kv(jnp.asarray(k), jnp.asarray(v), qtype)
    tkv = tq.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qtype)
    o_j, lse_j = jq.flash_attention_quantized(
        jnp.asarray(q, jnp.bfloat16), jkv, quantize_q=quantize_q, **kw)
    o_t, lse_t = tq.flash_attention_quantized(
        torch.from_numpy(q).to(torch.bfloat16), tkv, quantize_q=quantize_q,
        **kw)
    assert o_t.dtype == torch.bfloat16 and lse_t.dtype == torch.float32
    assert np.max(np.abs(np.asarray(o_j, np.float32)
                         - o_t.float().numpy())) <= 5e-3
    assert np.max(np.abs(np.asarray(lse_j) - lse_t.numpy())) <= 5e-3
