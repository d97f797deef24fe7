"""Gradients through the torch port's differentiable attention against
`jax.grad` of the JAX package's.

`torch.autograd.grad` of <flash_attention(q, k, v), dO> (and of `mha`,
the [B, N, H, d] layout) runs the port's `FlashAttention` function, whose
backward on CPU tensors is the plain version of the backward kernels;
the same numpy inputs go through `jax.grad` of the JAX op (Pallas in
interpret mode), also under a sliding window and segment ids. Gate: fp32,
max |diff| <= 1e-4 · max |JAX| per output and gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops.attention import (
    flash_attention as jax_flash_attention,
    mha as jax_mha,
)
from cuda_flashattention_torch.ops.attention import flash_attention, mha
from cuda_flashattention_torch.utils.testing import (
    assert_close,
    max_abs,
    seeded_random,
)

GATE = 1e-4


def _check(jax_fn, torch_fn, shapes, seed):
    arrays = [seeded_random(s, seed + i) for i, s in enumerate(shapes)]
    q, k, v, do = arrays

    def jax_loss(q, k, v):
        return jnp.vdot(jax_fn(q, k, v), do)

    o_j = jax_fn(q, k, v)
    grads_j = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)

    q_t, k_t, v_t = (torch.from_numpy(a).requires_grad_(True)
                     for a in (q, k, v))
    o_t = torch_fn(q_t, k_t, v_t)
    grads_t = torch.autograd.grad(o_t, (q_t, k_t, v_t),
                                  grad_outputs=torch.from_numpy(do))
    for got, want, name in zip((o_t, *grads_t), (o_j, *grads_j),
                               ("O", "dQ", "dK", "dV")):
        scale = max_abs(want)
        assert scale > 0, f"{name}: the JAX result is all zero"
        assert_close(got, want, GATE * scale, name)


@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", [
    (1, 4, 2, 48, 48, 32, dict(causal=True)),
    (2, 2, 2, 37, 53, 32, dict(causal=True, kv_offset=16)),
    (1, 4, 1, 40, 72, 16, dict(causal=False, scale=0.3)),
])
def test_flash_attention_grad_matches_jax(b, h, h_kv, nq, nk, d, kw):
    _check(lambda q, k, v: jax_flash_attention(q, k, v, **kw),
           lambda q, k, v: flash_attention(q, k, v, **kw),
           [(b, h, nq, d), (b, h_kv, nk, d), (b, h_kv, nk, d),
            (b, h, nq, d)], seed=nq + nk)


def _seg(b, n):
    ids = np.repeat(np.arange(3), [n // 3, 5, n - n // 3 - 5])
    return np.stack([np.roll(ids, 2 * i) for i in range(b)]).astype(np.int32)


@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw,segments", [
    (1, 4, 2, 48, 48, 32, dict(causal=True, window=12), False),
    (2, 2, 1, 37, 53, 32, dict(causal=True, window=8, kv_offset=16), False),
    (1, 2, 2, 24, 40, 16, dict(causal=True, window=8, kv_offset=-4), False),
    (2, 4, 2, 48, 48, 32, dict(causal=True), True),
    (1, 4, 1, 40, 40, 16, dict(causal=False), True),
    (1, 2, 2, 48, 48, 32, dict(causal=True, window=12), True),
])
def test_flash_attention_masks_grad_matches_jax(b, h, h_kv, nq, nk, d, kw,
                                                segments):
    """Window and segment ids through the differentiable op: ids are
    integer inputs that take no gradient."""
    jkw, tkw = dict(kw), dict(kw)
    if segments:
        seg = _seg(b, nk)
        jkw.update(q_segment_ids=jnp.asarray(seg[:, :nq]),
                   kv_segment_ids=jnp.asarray(seg))
        tkw.update(q_segment_ids=torch.from_numpy(seg[:, :nq]),
                   kv_segment_ids=torch.from_numpy(seg))
    _check(lambda q, k, v: jax_flash_attention(q, k, v, **jkw),
           lambda q, k, v: flash_attention(q, k, v, **tkw),
           [(b, h, nq, d), (b, h_kv, nk, d), (b, h_kv, nk, d),
            (b, h, nq, d)], seed=nq + 2 * nk)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_grad_matches_jax(causal):
    """[B, N, H, d] in and out: the gradients flow back through the
    transposes, so the backward sees strided q, k, v and dO."""
    _check(lambda q, k, v: jax_mha(q, k, v, causal=causal),
           lambda q, k, v: mha(q, k, v, causal=causal),
           [(2, 40, 4, 32)] * 4, seed=7)


def test_no_gradient_for_options():
    """Only q, k and v receive gradients; the function's output keeps q's
    dtype and shape."""
    q, k, v = (torch.from_numpy(seeded_random((1, 2, 16, 32), s))
               .requires_grad_(True) for s in range(3))
    o = flash_attention(q, k, v, causal=True)
    assert o.dtype == q.dtype and o.shape == q.shape and o.requires_grad
    o.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


def test_unported_options_raise():
    """Explicit block sizes are the one option not ported; a window
    without causal and half a pair of segment ids are refused as the JAX
    op refuses them."""
    q = torch.from_numpy(seeded_random((1, 2, 8, 32), 0))
    with pytest.raises(NotImplementedError, match="block_sizes"):
        flash_attention(q, q, q, causal=True, block_sizes=object())
    with pytest.raises(ValueError, match="window requires causal"):
        flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match="without kv_segment_ids"):
        flash_attention(q, q, q, q_segment_ids=torch.zeros(1, 8))
