"""Parity of the torch port's flash backward with the JAX package's.

The same numpy inputs (q, k, v, dO, and the O and LSE of the JAX
forward) go through `cuda_flashattention_tpu`'s `flash_attention_backward`
(its Pallas kernels in interpret mode on the CPU, with `fused` pinned to
True and to False) and through `cuda_flashattention_torch`'s, which on
CPU tensors runs its plain PyTorch version. Gates, per gradient:
max |diff| <= 1e-4 · max |JAX| in fp32 and 2e-2 · max |JAX| in bf16, with
and without a sliding window and segment ids. The backward oracle is held
against the JAX oracle at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops.flash_bwd import (
    flash_attention_backward as jax_bwd,
)
from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_fwd,
)
from cuda_flashattention_tpu.ops.naive import (
    naive_attention_backward as jax_naive_bwd,
)
from cuda_flashattention_tpu.utils.testing import (
    random_qkv as jax_random_qkv,
)
from cuda_flashattention_torch.ops.flash_bwd import flash_attention_backward
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_torch.ops.naive import naive_attention_backward
from cuda_flashattention_torch.utils.testing import (
    assert_close,
    max_abs,
    random_qkv,
    seeded_random,
)

GATES = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, b, h, h_kv, nq, nk, d):
    return (seeded_random((b, h, nq, d), seed),
            seeded_random((b, h_kv, nk, d), seed + 1),
            seeded_random((b, h_kv, nk, d), seed + 2),
            seeded_random((b, h, nq, d), seed + 3))


# (b, h, h_kv, nq, nk, d, causal, kv_offset, dtype)
CASES = [
    (1, 4, 2, 37, 53, 32, True, 16, "float32"),   # GQA, ragged
    (1, 2, 2, 24, 40, 32, True, -8, "float32"),   # empty rows, unseen keys
    (2, 4, 1, 48, 80, 32, False, 0, "float32"),   # MQA, Nq != Nk
    (1, 4, 2, 64, 64, 64, True, 0, "bfloat16"),
    (1, 4, 2, 37, 53, 32, True, 16, "bfloat16"),
    (1, 2, 2, 24, 40, 32, True, -8, "bfloat16"),
    (1, 2, 2, 40, 72, 32, False, 0, "bfloat16"),
]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,causal,kv_offset,dtype", CASES)
def test_backward_matches_jax(b, h, h_kv, nq, nk, d, causal, kv_offset,
                              dtype, fused):
    q, k, v, do = _inputs(nq * 7 + nk + h_kv, b, h, h_kv, nq, nk, d)
    jq, jk, jv, jdo = (jnp.asarray(a, JAX_DT[dtype]) for a in (q, k, v, do))
    kw = dict(causal=causal, kv_offset=kv_offset)
    o, lse = jax_fwd(jq, jk, jv, **kw)
    want = jax_bwd(jq, jk, jv, o, lse, jdo, fused=fused, **kw)

    tq, tk, tv, tdo, to = (
        torch.from_numpy(np.array(a, np.float32)).to(TORCH_DT[dtype])
        for a in (q, k, v, do, o))
    tlse = torch.from_numpy(np.array(lse, np.float32))
    got = flash_attention_backward(tq, tk, tv, to, tlse, tdo, fused=fused,
                                   **kw)
    for g, w, name, shape in zip(got, want, ("dQ", "dK", "dV"),
                                 (q.shape, k.shape, k.shape)):
        assert g.dtype == TORCH_DT[dtype] and tuple(g.shape) == shape
        scale = max_abs(w)
        assert scale > 0, f"{name}: the JAX gradient is all zero"
        assert_close(g, w, GATES[dtype] * scale, name)


# (b, h, h_kv, nq, nk, d, window, kv_offset, dtype): GQA, ragged, a
# prefix slice where only the window cuts, rows before the shard, and a
# window that leaves the last keys unseen and the first rows empty
WINDOW_CASES = [
    (1, 4, 2, 64, 64, 32, 16, 0, "float32"),
    (1, 4, 2, 37, 53, 32, 8, 16, "float32"),
    (2, 2, 1, 40, 100, 32, 16, 60, "float32"),
    (1, 2, 2, 24, 40, 32, 8, -4, "float32"),
    (1, 4, 2, 64, 64, 64, 16, 0, "bfloat16"),
    (1, 4, 2, 37, 53, 32, 8, 16, "bfloat16"),
]


def _compare_with_jax(q, k, v, do, dtype, fused, kw, jkw=None, tkw=None):
    """JAX forward + backward, then the port's backward on the JAX O and
    LSE, per-gradient gate GATES[dtype] · max |JAX|."""
    jkw, tkw = jkw or {}, tkw or {}
    jq, jk, jv, jdo = (jnp.asarray(a, JAX_DT[dtype]) for a in (q, k, v, do))
    o, lse = jax_fwd(jq, jk, jv, **kw, **jkw)
    want = jax_bwd(jq, jk, jv, o, lse, jdo, fused=fused, **kw, **jkw)
    tq, tk, tv, tdo, to = (
        torch.from_numpy(np.array(a, np.float32)).to(TORCH_DT[dtype])
        for a in (q, k, v, do, o))
    tlse = torch.from_numpy(np.array(lse, np.float32))
    got = flash_attention_backward(tq, tk, tv, to, tlse, tdo, fused=fused,
                                   **kw, **tkw)
    for g, w, name, shape in zip(got, want, ("dQ", "dK", "dV"),
                                 (q.shape, k.shape, k.shape)):
        assert g.dtype == TORCH_DT[dtype] and tuple(g.shape) == shape
        scale = max_abs(w)
        assert scale > 0, f"{name}: the JAX gradient is all zero"
        assert_close(g, w, GATES[dtype] * scale, name)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,window,kv_offset,dtype",
                         WINDOW_CASES)
def test_backward_window_matches_jax(b, h, h_kv, nq, nk, d, window,
                                     kv_offset, dtype, fused):
    q, k, v, do = _inputs(nq * 5 + nk + window, b, h, h_kv, nq, nk, d)
    _compare_with_jax(q, k, v, do, dtype, fused,
                      dict(causal=True, window=window, kv_offset=kv_offset))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,h_kv,n,d,kw,dtype", [
    (2, 4, 2, 64, 32, dict(causal=True), "float32"),
    (1, 4, 1, 50, 32, dict(causal=False), "float32"),
    (1, 2, 2, 48, 32, dict(causal=True, window=12), "float32"),
    (1, 4, 2, 64, 64, dict(causal=True), "bfloat16"),
])
def test_backward_segments_match_jax(b, h, h_kv, n, d, kw, dtype, fused):
    q, k, v, do = _inputs(n * 3 + h, b, h, h_kv, n, n, d)
    seg = np.stack([np.repeat(np.arange(4), [n // 4, 3, n // 2,
                                             n - n // 4 - 3 - n // 2])
                    for _ in range(b)]).astype(np.int32)
    seg[-1] = np.roll(seg[-1], 5)  # a segment that wraps: ids 3 | 0.. | 3
    _compare_with_jax(
        q, k, v, do, dtype, fused, kw,
        jkw=dict(q_segment_ids=jnp.asarray(seg),
                 kv_segment_ids=jnp.asarray(seg)),
        tkw=dict(q_segment_ids=torch.from_numpy(seg),
                 kv_segment_ids=torch.from_numpy(seg)))


def test_window_leaves_zero_gradients_where_nothing_is_seen():
    """window 8 at kv_offset 30 over 40 keys: query row r sees keys
    (22 + r, 30 + r], so rows 17.. see none (dQ = 0) and keys 0..22 are
    seen by no row (dK = dV = 0)."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(4, 1, 2, 2, 24, 40, 32))
    kw = dict(causal=True, window=8, kv_offset=30)
    o, lse = flash_attention_forward(q, k, v, **kw)
    assert torch.all(lse[:, :, 17:] == -1e30)
    dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, **kw)
    assert torch.all(dq[:, :, 17:] == 0) and torch.any(dq[:, :, :17] != 0)
    assert torch.all(dk[:, :, :23] == 0) and torch.all(dv[:, :, :23] == 0)
    assert torch.any(dv[:, :, 23:] != 0)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))


def test_unseen_keys_and_empty_rows_get_zero_gradients():
    """kv_offset = -8: query rows 0..7 see no key (dQ = 0) and keys past
    Nq - 1 - 8 are seen by no query (dK = dV = 0)."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(3, 1, 2, 2, 24, 40, 32))
    o = torch.zeros_like(q)
    lse = torch.full((1, 2, 24), -1e30)
    lse[:, :, 8:] = 1.0
    dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                          kv_offset=-8)
    assert torch.all(dq[:, :, :8] == 0) and torch.any(dq[:, :, 8:] != 0)
    assert torch.all(dk[:, :, 16:] == 0) and torch.all(dv[:, :, 16:] == 0)
    assert torch.any(dv[:, :, :16] != 0)


@pytest.mark.parametrize("kw", [
    dict(causal=False),
    dict(causal=True, kv_offset=8),
    dict(causal=True, window=8),
])
def test_naive_backward_matches_jax_oracle(kw):
    q, k, v, do = _inputs(11, 2, 2, 2, 40, 48, 32)
    want = jax_naive_bwd(q, k, v, do, **kw)
    got = naive_attention_backward(*(torch.from_numpy(a)
                                     for a in (q, k, v, do)), **kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert g.dtype == torch.float32
        assert_close(g, w, 1e-5, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fixtures_match_jax(dtype):
    """random_qkv hands both packages the same values."""
    want = jax_random_qkv(1, 2, 24, 40, 32, seed=9, dtype=JAX_DT[dtype])
    got = random_qkv(1, 2, 24, 40, 32, seed=9, dtype=TORCH_DT[dtype])
    for g, w in zip(got, want):
        assert g.dtype == TORCH_DT[dtype]
        assert_close(g, w, 0.0)
    with pytest.raises(AssertionError, match="max diff"):
        assert_close(got[0], np.asarray(want[0], np.float32) + 1e-3, 1e-4)


@pytest.mark.parametrize("kw", [
    dict(block_sizes=object()),                  # TPU tiling: not ported
    dict(window=4),                              # a window needs causal
    dict(q_segment_ids=torch.zeros(1, 8)),       # without kv_segment_ids
])
def test_unported_options_raise(kw):
    """Explicit block sizes are the one option not ported; the others are
    argument combinations that mean nothing."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 2, 8, 8, 32))
    with pytest.raises(NotImplementedError if "block_sizes" in kw
                       else ValueError):
        flash_attention_backward(q, k, v, q, torch.zeros(1, 2, 8), do, **kw)


def test_no_plain_fallback_off_the_cpu():
    """Only CPU tensors take the plain version; other devices raise."""
    q = torch.zeros(1, 2, 8, 64, device="meta")
    lse = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_backward(q, q, q, q, lse, q, causal=True)
