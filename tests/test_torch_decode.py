"""Parity of the torch port's decode attention with the JAX package's
(`decode_attention`, Pallas kernel in interpret mode on the CPU), with
per-sequence lengths inside an over-allocated cache and GQA; int8, fp8
and mixed caches; `window`, `windows` and both; `quantize_q`; group sizes
1, 4 and 16. Gates on O and LSE: fp32 1e-4, bf16 5e-3, and 5e-3 for an
fp8 array read with a bf16 compute dtype (there the JAX package's CPU
path flushes the fp8 subnormal codes to zero and the port does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops.decode import (
    decode_attention as jax_decode,
)
from cuda_flashattention_tpu.ops.quant import quantize_kv as jax_quantize_kv
from cuda_flashattention_torch.ops.decode import (
    decode_attention,
    decode_attention_plain,
)
from cuda_flashattention_torch.ops.naive import naive_decode
from cuda_flashattention_torch.ops.quant import quantize_kv

GATES = {"float32": 1e-4, "bfloat16": 5e-3}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, b, h, h_kv, max_n, d):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, (b, h, d)).astype(np.float32)
    k = rng.uniform(-1.0, 1.0, (b, h_kv, max_n, d)).astype(np.float32)
    v = rng.uniform(-1.0, 1.0, (b, h_kv, max_n, d)).astype(np.float32)
    return q, k, v


# (b, h, h_kv, max_n, d, lengths, dtype)
CASES = [
    (3, 4, 2, 40, 32, [1, 17, 40], "float32"),
    (2, 4, 4, 33, 64, [33, 5], "float32"),
    (4, 8, 2, 64, 32, [0, 9, 63, 64], "bfloat16"),
    (2, 4, 1, 50, 64, [50, 21], "bfloat16"),
]


@pytest.mark.parametrize("b,h,h_kv,max_n,d,lengths,dtype", CASES)
def test_decode_matches_jax(b, h, h_kv, max_n, d, lengths, dtype):
    q, k, v = _inputs(max_n + d, b, h, h_kv, max_n, d)
    o_j, lse_j = jax_decode(*[jnp.asarray(a, JAX_DT[dtype])
                              for a in (q, k, v)],
                            jnp.asarray(lengths, jnp.int32))
    o_t, lse_t = decode_attention(
        *[torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v)],
        torch.tensor(lengths, dtype=torch.int32))
    assert o_t.dtype == TORCH_DT[dtype] and lse_t.dtype == torch.float32
    assert tuple(o_t.shape) == (b, h, d) and tuple(lse_t.shape) == (b, h)
    gate = GATES[dtype]
    assert np.max(np.abs(np.asarray(o_j, np.float32)
                         - o_t.float().numpy())) <= gate
    assert np.max(np.abs(np.asarray(lse_j) - lse_t.numpy())) <= gate
    empty = [i for i, n in enumerate(lengths) if n == 0]
    assert torch.all(lse_t[empty] == -1e30) and torch.all(o_t[empty] == 0)


def test_decode_matches_oracle_on_live_prefix():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 2, 4, 2, 30, 32))
    lengths = torch.tensor([30, 12], dtype=torch.int32)
    o, _ = decode_attention(q, k, v, lengths)
    for i, n in enumerate(lengths.tolist()):
        ref = naive_decode(q[i], k[i, :, :n].repeat_interleave(2, 0),
                           v[i, :, :n].repeat_interleave(2, 0))
        assert torch.max(torch.abs(o[i] - ref)) <= 1e-5


def _quantized(k, v, qtype):
    """The same codes and scales on both sides (the quantizer's own
    parity is test_torch_quant's)."""
    kv_t = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qtype)
    kv_j = jax_quantize_kv(jnp.asarray(k), jnp.asarray(v), qtype)
    np.testing.assert_array_equal(
        kv_t.k_q.view(torch.uint8).numpy(),
        np.asarray(kv_j.k_q).view(np.uint8))
    return kv_t, kv_j


def _run_both(q, kv_t, kv_j, lengths, dtype, **kw):
    jkw = {n: (jnp.asarray(x, jnp.int32) if n == "windows" else x)
           for n, x in kw.items()}
    tkw = {n: (torch.tensor(x, dtype=torch.int32) if n == "windows" else x)
           for n, x in kw.items()}
    o_j, lse_j = jax_decode(
        jnp.asarray(q, JAX_DT[dtype]), kv_j.k_q, kv_j.v_q,
        jnp.asarray(lengths, jnp.int32), k_scale=kv_j.k_scale,
        v_scale=kv_j.v_scale, **jkw)
    o_t, lse_t = decode_attention(
        torch.from_numpy(q).to(TORCH_DT[dtype]), kv_t.k_q, kv_t.v_q,
        torch.tensor(lengths, dtype=torch.int32), k_scale=kv_t.k_scale,
        v_scale=kv_t.v_scale, **tkw)
    assert o_t.dtype == TORCH_DT[dtype] and lse_t.dtype == torch.float32
    return (np.max(np.abs(np.asarray(o_j, np.float32) - o_t.float().numpy())),
            np.max(np.abs(np.asarray(lse_j) - lse_t.numpy())), o_t, lse_t)


def _gate(dtype, qtype, quantize_q=False):
    fp8_in_bf16 = qtype in ("fp8", "mixed") and (
        dtype == "bfloat16" or quantize_q)
    return 5e-3 if fp8_in_bf16 else GATES[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_quantized_decode_matches_jax(qtype, dtype):
    b, h, h_kv, max_n, d = 3, 8, 2, 70, 32
    lengths = [70, 0, 33]
    q, k, v = _inputs(11, b, h, h_kv, max_n, d)
    kv_t, kv_j = _quantized(k, v, qtype)
    e_o, e_l, o_t, lse_t = _run_both(q, kv_t, kv_j, lengths, dtype)
    assert e_o <= _gate(dtype, qtype) and e_l <= _gate(dtype, qtype)
    assert torch.all(lse_t[1] == -1e30) and torch.all(o_t[1] == 0)


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_quantized_decode_matches_own_dequantized_oracle(qtype):
    """The folded scales equal attention over the materialised
    dequantised cache: no fp8 code is flushed on the port's side."""
    q, k, v = _inputs(12, 2, 4, 2, 48, 32)
    kv = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qtype)
    lengths = torch.tensor([48, 19], dtype=torch.int32)
    o, lse = decode_attention(torch.from_numpy(q), kv.k_q, kv.v_q, lengths,
                              k_scale=kv.k_scale, v_scale=kv.v_scale)
    kd, vd = kv.dequantize()
    o_d, lse_d = decode_attention(torch.from_numpy(q), kd, vd, lengths)
    assert torch.max(torch.abs(o - o_d)) <= 1e-5
    assert torch.max(torch.abs(lse - lse_d)) <= 1e-5


# (window, windows): alone, per sequence, both (the static one caps),
# and windows at or beyond the lengths (no window at all)
WINDOW_CASES = [
    dict(window=16),
    dict(windows=[5, 64, 1, 0]),
    dict(window=16, windows=[40, 7, 16, 100]),
    dict(window=200),
    dict(windows=[64, 64, 9, 70]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", WINDOW_CASES)
def test_windowed_decode_matches_jax(kw, dtype):
    b, h, h_kv, max_n, d = 4, 4, 2, 64, 32
    lengths = [64, 30, 9, 0]
    q, k, v = _inputs(13, b, h, h_kv, max_n, d)
    jkw = {n: (jnp.asarray(x, jnp.int32) if n == "windows" else x)
           for n, x in kw.items()}
    tkw = {n: (torch.tensor(x, dtype=torch.int32) if n == "windows" else x)
           for n, x in kw.items()}
    o_j, lse_j = jax_decode(*[jnp.asarray(a, JAX_DT[dtype])
                              for a in (q, k, v)],
                            jnp.asarray(lengths, jnp.int32), **jkw)
    o_t, lse_t = decode_attention(
        *[torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v)],
        torch.tensor(lengths, dtype=torch.int32), **tkw)
    gate = GATES[dtype]
    assert np.max(np.abs(np.asarray(o_j, np.float32)
                         - o_t.float().numpy())) <= gate
    assert np.max(np.abs(np.asarray(lse_j) - lse_t.numpy())) <= gate


def test_window_is_the_newest_keys_only():
    """window=W over length n equals full attention over keys n−W..n−1."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(14, 2, 4, 2, 40, 32))
    lengths = torch.tensor([40, 25], dtype=torch.int32)
    o, lse = decode_attention(q, k, v, lengths, window=10)
    for i, n in enumerate(lengths.tolist()):
        o_i, lse_i = decode_attention(
            q[i:i + 1], k[i:i + 1, :, n - 10:n], v[i:i + 1, :, n - 10:n],
            torch.tensor([10], dtype=torch.int32))
        assert torch.max(torch.abs(o[i] - o_i[0])) <= 1e-6
        assert torch.max(torch.abs(lse[i] - lse_i[0])) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qtype,window", [("int8", 0), ("mixed", 0),
                                          ("fp8", 0), ("int8", 12)])
def test_quantize_q_matches_jax(qtype, window, dtype):
    b, h, h_kv, max_n, d = 2, 8, 2, 50, 32
    lengths = [50, 27]
    q, k, v = _inputs(15, b, h, h_kv, max_n, d)
    kv_t, kv_j = _quantized(k, v, qtype)
    e_o, e_l, o_qq, _ = _run_both(q, kv_t, kv_j, lengths, dtype,
                                  quantize_q=True, window=window)
    # fp8 K ignores the flag and computes in q's dtype
    gate = _gate(dtype, qtype, quantize_q=qtype != "fp8")
    assert e_o <= gate and e_l <= gate
    _, _, o_plain, _ = _run_both(q, kv_t, kv_j, lengths, dtype,
                                 window=window)
    if qtype == "fp8":
        assert torch.equal(o_qq, o_plain)  # the flag changed nothing
    else:
        d_q = torch.max(torch.abs(o_qq.float() - o_plain.float())).item()
        assert 0 < d_q <= 2e-2  # int8 Q: a different, close answer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 4, 16])
def test_group_sizes_match_jax(group, dtype):
    h_kv = 2
    q, k, v = _inputs(16 + group, 2, h_kv * group, h_kv, 24, 32)
    lengths = [24, 7]
    o_j, lse_j = jax_decode(*[jnp.asarray(a, JAX_DT[dtype])
                              for a in (q, k, v)],
                            jnp.asarray(lengths, jnp.int32))
    o_t, lse_t = decode_attention(
        *[torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v)],
        torch.tensor(lengths, dtype=torch.int32))
    gate = GATES[dtype]
    assert np.max(np.abs(np.asarray(o_j, np.float32)
                         - o_t.float().numpy())) <= gate
    assert np.max(np.abs(np.asarray(lse_j) - lse_t.numpy())) <= gate


def test_dead_cache_rows_may_hold_anything():
    """NaN past the live context, in values and scales, changes nothing."""
    q, k, v = _inputs(17, 2, 4, 2, 20, 32)
    kv = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), "int8")
    lengths = torch.tensor([20, 6], dtype=torch.int32)
    args = (torch.from_numpy(q), kv.k_q, kv.v_q, lengths)
    o, lse = decode_attention(*args, k_scale=kv.k_scale, v_scale=kv.v_scale)
    ks, vs = kv.k_scale.clone(), kv.v_scale.clone()
    ks[1, :, 6:] = float("nan")
    vs[1, :, 6:] = float("nan")
    o_n, lse_n = decode_attention(*args, k_scale=ks, v_scale=vs)
    assert torch.equal(o, o_n) and torch.equal(lse, lse_n)
    kf, vf = torch.from_numpy(k).clone(), torch.from_numpy(v).clone()
    o_f, _ = decode_attention(torch.from_numpy(q), kf, vf, lengths)
    kf[1, :, 6:] = float("nan")
    vf[1, :, 6:] = float("nan")
    o_fn, _ = decode_attention(torch.from_numpy(q), kf, vf, lengths)
    assert torch.equal(o_f, o_fn)


@pytest.mark.parametrize("kw", [
    dict(k_scale=torch.ones(1, 2, 8), v_scale=torch.ones(1, 2, 8)),
    dict(window=4),
    dict(windows=torch.ones(1, dtype=torch.int32)),
    dict(quantize_q=True),
    dict(block_k=8),
])
def test_unported_options_raise(kw):
    """None of the options that used to raise does now: `block_k` is the
    kernel's split size (here the capacity, one split; one past it is
    clamped to it, as the JAX function clamps its block), and the others
    are taken."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 2, 8, 32))
    lengths = torch.tensor([8], dtype=torch.int32)
    if "block_k" in kw:
        past = decode_attention(q, k, v, lengths, block_k=kw["block_k"] + 1)
        at = decode_attention(q, k, v, lengths, block_k=kw["block_k"])
        assert torch.equal(past[0], at[0]) and torch.equal(past[1], at[1])
    o, lse = decode_attention(q, k, v, lengths, **kw)
    assert o.shape == q.shape and lse.shape == q.shape[:2]
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()


def test_scales_come_in_pairs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 2, 8, 32))
    with pytest.raises(ValueError, match="together"):
        decode_attention(q, k, v, torch.tensor([8], dtype=torch.int32),
                         k_scale=torch.ones(1, 2, 8))


def test_cpu_wrapper_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 4, 2, 16, 32))
    lengths = torch.tensor([16, 3], dtype=torch.int32)
    before = decode_attention.launches
    got = decode_attention(q, k, v, lengths, window=5)
    want = decode_attention_plain(q, k, v, lengths, window=5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert decode_attention.launches == before  # no kernel on the CPU


def test_no_plain_fallback_off_the_cpu():
    q = torch.zeros(1, 2, 64, device="meta")
    kv = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q, kv, kv, torch.zeros(1, dtype=torch.int32,
                                                device="meta"))


@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("d", [16, 32])
def test_f32_narrow_heads_match_jax(d, qtype):
    """An fp32 q over an fp32, int8, fp8 or mixed cache at the narrow
    heads the card's decode kernel now takes (d = 16, 32): the compute
    dtype is fp32, so O and LSE within 1e-4."""
    b, h, h_kv, max_n = 3, 8, 2, 70
    lengths = [70, 0, 33]
    q, k, v = _inputs(20 + d, b, h, h_kv, max_n, d)
    if qtype is None:
        o_j, lse_j = jax_decode(*(jnp.asarray(a) for a in (q, k, v)),
                                jnp.asarray(lengths, jnp.int32))
        o_t, lse_t = decode_attention(
            *(torch.from_numpy(a) for a in (q, k, v)),
            torch.tensor(lengths, dtype=torch.int32))
        e_o = np.max(np.abs(np.asarray(o_j) - o_t.numpy()))
        e_l = np.max(np.abs(np.asarray(lse_j) - lse_t.numpy()))
    else:
        kv_t, kv_j = _quantized(k, v, qtype)
        e_o, e_l, o_t, lse_t = _run_both(q, kv_t, kv_j, lengths, "float32")
    assert o_t.dtype == torch.float32 and tuple(o_t.shape) == (b, h, d)
    assert e_o <= GATES["float32"] and e_l <= GATES["float32"]
    assert torch.all(o_t[1] == 0) and torch.all(lse_t[1] == -1e30)


@pytest.mark.parametrize("quantize_q", [False, True])
def test_plain_rounds_p_only_where_the_jax_body_does(quantize_q):
    """The compute dtype is q's, or bf16 under `quantize_q` on an int8-K
    cache (cuda_flashattention_tpu/ops/decode.py: `cd`): over an int8
    cache an fp32 q weights V with P·v_scale unrounded, and `quantize_q`
    rounds it to bf16. Both against the same sums written out here."""
    b, h, h_kv, n, d = 2, 4, 2, 40, 16
    q, k, v = (torch.from_numpy(a) for a in _inputs(31, b, h, h_kv, n, d))
    kv = quantize_kv(k, v, "int8")
    lengths = torch.full((b,), n, dtype=torch.int32)
    o, lse = decode_attention_plain(q, kv.k_q, kv.v_q, lengths,
                                    k_scale=kv.k_scale, v_scale=kv.v_scale,
                                    quantize_q=quantize_q)
    g = h // h_kv
    scale = d ** -0.5
    if quantize_q:
        sq = q.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 127.0
        q8 = torch.clamp(torch.round(q / sq), -127, 127)
        s = torch.einsum("bhgd,bhkd->bhgk", q8.view(b, h_kv, g, d),
                         kv.k_q.float()) * (sq * scale).view(b, h_kv, g, 1)
    else:
        s = torch.einsum("bhgd,bhkd->bhgk", q.view(b, h_kv, g, d),
                         kv.k_q.float()) * scale
    s = s * kv.k_scale[:, :, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    pw = p * kv.v_scale[:, :, None, :]
    unrounded = torch.einsum("bhgk,bhkd->bhgd", pw, kv.v_q.float()) / l
    rounded = torch.einsum("bhgk,bhkd->bhgd", pw.bfloat16().float(),
                           kv.v_q.float()) / l
    want, other = (rounded, unrounded) if quantize_q else (unrounded,
                                                           rounded)
    assert o.dtype == torch.float32
    assert torch.max(torch.abs(o - want.reshape(b, h, d))) <= 1e-6
    assert torch.max(torch.abs(o - other.reshape(b, h, d))) > 1e-5
    assert torch.max(torch.abs(lse - (m + torch.log(l)).reshape(b, h))) <= 1e-5
