"""Gradients through the torch port's differentiable attention against
`jax.grad` of the JAX package's.

`torch.autograd.grad` of <flash_attention(q, k, v), dO> (and of `mha`,
the [B, N, H, d] layout) runs the port's `FlashAttention` function, whose
backward on CPU tensors is the plain version of the backward kernels;
the same numpy inputs go through `jax.grad` of the JAX op (Pallas in
interpret mode). Gate: fp32, max |diff| <= 1e-4 · max |JAX| per output
and gradient."""

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
    q = torch.from_numpy(seeded_random((1, 2, 8, 32), 0))
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, causal=True, window=4)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, q_segment_ids=torch.zeros(1, 8),
                        kv_segment_ids=torch.zeros(1, 8))
