"""Parity of the torch port's flash forward with the JAX package's.

The same numpy inputs go through `cuda_flashattention_tpu`'s
`flash_attention_forward` (its Pallas kernel in interpret mode on the CPU)
and through `cuda_flashattention_torch`'s, which on CPU tensors runs its
plain PyTorch version. Gates: fp32 1e-4 and bf16 5e-3 on O and LSE.
Non-causal JAX calls pin softmax="online", the strategy the port runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_fwd,
)
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_torch.ops.naive import naive_attention

GATES = {"float32": 1e-4, "bfloat16": 5e-3}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, b, h, h_kv, nq, nk, d):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, (b, h, nq, d)).astype(np.float32)
    k = rng.uniform(-1.0, 1.0, (b, h_kv, nk, d)).astype(np.float32)
    v = rng.uniform(-1.0, 1.0, (b, h_kv, nk, d)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype, **kw):
    jx = jax_fwd(*[jnp.asarray(a, JAX_DT[dtype]) for a in arrays],
                 softmax="auto" if kw.get("causal") else "online",
                 **{k: (JAX_DT[v] if k == "out_dtype" else v)
                    for k, v in kw.items()})
    th = flash_attention_forward(
        *[torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrays],
        **{k: (TORCH_DT[v] if k == "out_dtype" else v)
           for k, v in kw.items()})
    return jx, th


def _max_diff(jx, th):
    return float(np.max(np.abs(np.asarray(jx, np.float32)
                               - th.float().numpy())))


# (b, h, h_kv, nq, nk, d, causal, kv_offset, dtype, out_dtype)
CASES = [
    (1, 4, 2, 64, 64, 32, True, 0, "float32", None),
    (1, 4, 2, 37, 53, 32, False, 0, "float32", None),
    (1, 4, 2, 37, 53, 32, True, 16, "float32", None),
    (1, 2, 2, 24, 24, 32, True, -8, "float32", None),  # empty first rows
    (2, 4, 4, 64, 64, 64, True, 0, "bfloat16", None),
    (1, 4, 2, 37, 53, 64, True, 16, "bfloat16", "float32"),
    (1, 4, 2, 48, 96, 32, False, 0, "bfloat16", "float32"),
]


@pytest.mark.parametrize(
    "b,h,h_kv,nq,nk,d,causal,kv_offset,dtype,out_dtype", CASES)
def test_forward_matches_jax(b, h, h_kv, nq, nk, d, causal, kv_offset,
                             dtype, out_dtype):
    arrays = _inputs(nq * 7 + nk, b, h, h_kv, nq, nk, d)
    kw = dict(causal=causal, kv_offset=kv_offset)
    if out_dtype is not None:
        kw["out_dtype"] = out_dtype
    (o_j, lse_j), (o_t, lse_t) = _both(arrays, dtype, **kw)
    want = TORCH_DT[out_dtype or dtype]
    assert o_t.dtype == want and lse_t.dtype == torch.float32
    assert tuple(o_t.shape) == (b, h, nq, d)
    assert tuple(lse_t.shape) == (b, h, nq)
    gate = GATES[dtype]
    assert _max_diff(o_j, o_t) <= gate
    assert _max_diff(lse_j, lse_t) <= gate


def test_empty_rows_report_finite_neg_inf():
    """Rows that see no key give O = 0 and LSE = -1e30 (not -inf)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 2, 24, 24, 32))
    o, lse = flash_attention_forward(q, k, v, causal=True, kv_offset=-8)
    assert torch.all(o[:, :, :8] == 0)
    assert torch.all(lse[:, :, :8] == -1e30)
    assert torch.isfinite(lse).all()


def test_forward_matches_oracle_fp32():
    """The plain path agrees with the dense oracle (GQA by repetition)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 2, 4, 2, 40, 40, 32))
    o, lse = flash_attention_forward(q, k, v, causal=True)
    o_ref, lse_ref = naive_attention(q, k.repeat_interleave(2, 1),
                                     v.repeat_interleave(2, 1), causal=True)
    assert torch.max(torch.abs(o - o_ref)) <= 1e-5
    assert torch.max(torch.abs(lse - lse_ref)) <= 1e-5


@pytest.mark.parametrize("kw", [
    dict(window=4, causal=True),
    dict(k_scale=torch.ones(1, 2, 8), v_scale=torch.ones(1, 2, 8)),
    dict(q_segment_ids=torch.zeros(1, 8), kv_segment_ids=torch.zeros(1, 8)),
    dict(softmax="bound"),
    dict(quantize_q=True),
    dict(block_sizes=object()),
])
def test_unported_options_raise(kw):
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 2, 8, 8, 32))
    with pytest.raises(NotImplementedError):
        flash_attention_forward(q, k, v, **kw)


def test_no_plain_fallback_off_the_cpu():
    """Only CPU tensors take the plain version; other devices raise."""
    q = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_forward(q, q, q, causal=True)
