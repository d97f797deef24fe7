"""Parity of the torch port's decode attention with the JAX package's
(`decode_attention`, Pallas kernel in interpret mode on the CPU), with
per-sequence lengths inside an over-allocated cache and GQA. Gates: fp32
1e-4 and bf16 5e-3 on O and LSE."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops.decode import (
    decode_attention as jax_decode,
)
from cuda_flashattention_torch.ops.decode import decode_attention
from cuda_flashattention_torch.ops.naive import naive_decode

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


@pytest.mark.parametrize("kw", [
    dict(k_scale=torch.ones(1, 2, 8), v_scale=torch.ones(1, 2, 8)),
    dict(window=4),
    dict(windows=torch.ones(1, dtype=torch.int32)),
    dict(quantize_q=True),
    dict(block_k=8),
])
def test_unported_options_raise(kw):
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 2, 8, 32))
    with pytest.raises(NotImplementedError):
        decode_attention(q, k, v, torch.tensor([8], dtype=torch.int32), **kw)


def test_no_plain_fallback_off_the_cpu():
    q = torch.zeros(1, 2, 64, device="meta")
    kv = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q, kv, kv, torch.zeros(1, dtype=torch.int32,
                                                device="meta"))
