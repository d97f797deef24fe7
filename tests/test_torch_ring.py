"""Parity of the torch port's ring attention with the JAX package's
(`parallel/ring.py`); the sharded decode is in test_torch_ring_decode.py.

The same numpy inputs, made from a seed, go through the JAX function on
the virtual 8-device CPU mesh of tests/conftest.py (Pallas in interpret
mode) and through the port on a mesh of repeated "cpu" devices (plain
versions of the kernels). Neither `ring_attention` takes a `softmax`
argument: both route their steps through `softmax="auto"`, the same rule
on both sides. Gates: fp32 outputs 1e-4, fp32 gradients 1e-4 · max |JAX|,
bf16 outputs 5e-3 and bf16 gradients 2e-2 · max |JAX|. A JAX ring
backward over the virtual mesh takes 30–60 s to compile, so where a case
only varies what another already holds against JAX, its gradients are
held against the port's own one-device `flash_attention` instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.parallel import ring as jring
from cuda_flashattention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cuda_flashattention_torch.ops.attention import flash_attention
from cuda_flashattention_torch.ops.common import BlockSizes
from cuda_flashattention_torch.parallel import ring as tring
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.utils.testing import (
    assert_close,
    max_abs,
    seeded_random,
)

GATE = 1e-4
BF16_GATE, BF16_GRAD_GATE = 5e-3, 2e-2


def _meshes(n):
    return (jax_make_mesh((n,), ("sp",), jax.devices()[:n]),
            make_mesh((n,), ("sp",), ["cpu"] * n))


def _qkv(b, h, h_kv, n, d, seed):
    return (seeded_random((b, h, n, d), seed),
            seeded_random((b, h_kv, n, d), seed + 1),
            seeded_random((b, h_kv, n, d), seed + 2))


def _both(n_shards, q, k, v, do=None, dtype="float32", jax_grads=True,
          **kw):
    """(JAX O, torch O, reference grads, torch grads) of the two rings;
    the reference gradients are the JAX ring's, or with `jax_grads=False`
    those of the port's `flash_attention` on one device."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jmesh, tmesh = _meshes(n_shards)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(do is not None)
                  for a in (q, k, v))
    o_j = jring.ring_attention(jq, jk, jv, jmesh, **kw)
    o_t = tring.ring_attention(tq, tk, tv, tmesh, **kw)
    assert o_t.dtype == tdt and tuple(o_t.shape) == q.shape
    if do is None:
        return o_j, o_t, None, None
    g_t = torch.autograd.grad(o_t, (tq, tk, tv),
                              torch.from_numpy(do).to(tdt))
    if not jax_grads:
        rq, rk, rv = (torch.from_numpy(a).to(tdt).requires_grad_()
                      for a in (q, k, v))
        g_r = torch.autograd.grad(flash_attention(rq, rk, rv, **kw),
                                  (rq, rk, rv), torch.from_numpy(do).to(tdt))
        return o_j, o_t, [g.float().numpy() for g in g_r], g_t
    g_j = jax.grad(
        lambda *a: jnp.sum(jring.ring_attention(*a, jmesh, **kw).astype(
            jnp.float32) * jnp.asarray(do)), argnums=(0, 1, 2))(jq, jk, jv)
    return o_j, o_t, g_j, g_t


def _assert_grads(g_t, g_j, rel, what):
    for name, a, b in zip(("dQ", "dK", "dV"), g_t, g_j):
        assert max_abs(b) > 0
        assert_close(a, np.asarray(b, np.float32), rel * max_abs(b),
                     f"{what} {name}")


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_ring_forward(n_shards):
    q, k, v = _qkv(1, 2, 2, 128, 32, 42)
    o_j, o_t, _, _ = _both(n_shards, q, k, v)
    assert_close(o_t, o_j, GATE, f"ring O ({n_shards} shards)")


@pytest.mark.parametrize("n_shards", [2, 8])
def test_ring_causal(n_shards):
    q, k, v = _qkv(1, 2, 2, 128, 32, 42)
    o_j, o_t, _, _ = _both(n_shards, q, k, v, causal=True)
    assert_close(o_t, o_j, GATE, f"causal ring O ({n_shards} shards)")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_backward(causal):
    q, k, v = _qkv(1, 1, 1, 64, 16, 42)
    do = seeded_random(q.shape, 55)
    o_j, o_t, g_j, g_t = _both(4, q, k, v, do, causal=causal)
    assert_close(o_t, o_j, GATE, "ring O")
    _assert_grads(g_t, g_j, GATE, f"ring causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_seq_not_divisible(causal):
    """N = 50 over 4 ranks: padded to the shard grid; non-causal marks
    the tail with segment ids that rotate with their shard."""
    q, k, v = _qkv(1, 1, 1, 50, 16, 42)
    do = seeded_random(q.shape, 77)
    o_j, o_t, g_j, g_t = _both(4, q, k, v, do, causal=causal)
    assert_close(o_t, o_j, GATE, f"ragged ring O (causal={causal})")
    _assert_grads(g_t, g_j, GATE, f"ragged ring causal={causal}")


def test_ring_gqa():
    q, k, v = _qkv(1, 4, 2, 64, 16, 71)
    do = seeded_random(q.shape, 74)
    o_j, o_t, g_j, g_t = _both(4, q, k, v, do, causal=True)
    assert_close(o_t, o_j, GATE, "ring gqa O")
    _assert_grads(g_t, g_j, GATE, "ring gqa")


# window → forward step kernels of 4 ranks with L = 16: the ring ends after
# min(4, ceil(W/L) + 1) steps, and step s runs on the 4 − s ranks that have
# a block behind them
@pytest.mark.parametrize("window,steps,calls", [(10, 2, 7), (20, 3, 9),
                                                (40, 4, 10)])
def test_ring_sliding_window(monkeypatch, window, steps, calls):
    q, k, v = _qkv(1, 2, 2, 64, 16, 141)
    do = seeded_random(q.shape, 144)
    count = dict(fwd=0, bwd=0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            count[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tring, "flash_attention_forward",
                        counted("fwd", tring.flash_attention_forward))
    monkeypatch.setattr(tring, "flash_attention_backward",
                        counted("bwd", tring.flash_attention_backward))
    o_j, o_t, g_j, g_t = _both(4, q, k, v, do, jax_grads=window == 20,
                               causal=True, window=window)
    assert_close(o_t, o_j, GATE, f"ring win{window} O")
    _assert_grads(g_t, g_j, GATE, f"ring win{window}")
    assert count == dict(fwd=calls, bwd=calls)
    plan = tring._RingPlan(mesh=None, axis_name="sp", batch_axis=None,
                           head_axis=None, n_shards=4, shard_len=16,
                           scale=1.0, causal=True, window=window,
                           ragged=False)
    assert plan.max_steps == steps


def test_ring_causal_skips_launch_nothing(monkeypatch):
    """Full causal over 4 ranks: 4 diagonal + 3 + 2 + 1 full steps; a
    block ahead of the queries is not attended at all."""
    calls = []
    real = tring.flash_attention_forward
    monkeypatch.setattr(
        tring, "flash_attention_forward",
        lambda *a, **kw: calls.append(kw["causal"]) or real(*a, **kw))
    q, k, v = _qkv(1, 2, 2, 64, 16, 5)
    _both(4, q, k, v, causal=True)
    assert sorted(calls) == [False] * 6 + [True] * 4


def test_ring_bf16():
    q, k, v = _qkv(1, 2, 2, 128, 32, 9)
    do = seeded_random(q.shape, 10)
    o_j, o_t, g_j, g_t = _both(4, q, k, v, do, dtype="bfloat16", causal=True)
    assert_close(o_t, np.asarray(o_j, np.float32), BF16_GATE, "bf16 ring O")
    _assert_grads(g_t, g_j, BF16_GRAD_GATE, "bf16 ring")


@pytest.mark.parametrize("axes", ["dp", "tp", "dp_tp"])
def test_ring_batch_and_head_axes(axes):
    """`batch_axis` and `head_axis` cut B and H over further mesh axes;
    the result is that of one call on the whole tensors."""
    q, k, v = _qkv(2, 4, 2, 64, 16, 31)
    do = seeded_random(q.shape, 32)
    shape, names, kw = {
        "dp": ((2, 4), ("dp", "sp"), dict(batch_axis="dp")),
        "tp": ((2, 4), ("tp", "sp"), dict(head_axis="tp")),
        "dp_tp": ((2, 2, 2), ("dp", "tp", "sp"),
                  dict(batch_axis="dp", head_axis="tp")),
    }[axes]
    jmesh = jax_make_mesh(shape, names)
    tmesh = make_mesh(shape, names, ["cpu"] * 8)
    o_j = jring.ring_attention(*(jnp.asarray(a) for a in (q, k, v)), jmesh,
                               causal=True, **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o_t = tring.ring_attention(tq, tk, tv, tmesh, causal=True, **kw)
    assert_close(o_t, o_j, GATE, f"ring {axes} O")
    g_t = torch.autograd.grad(o_t, (tq, tk, tv), torch.from_numpy(do))
    rq, rk, rv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    g_r = torch.autograd.grad(flash_attention(rq, rk, rv, causal=True),
                              (rq, rk, rv), torch.from_numpy(do))
    _assert_grads(g_t, [g.numpy() for g in g_r], GATE, f"ring {axes}")


def test_ring_f32_wide_heads():
    """fp32 at d = 256 (the width whose fp32 backward the card's d = 256
    builds take): the ring over 4 ranks, GQA 4:2, causal and windowed,
    against the port's one-device `flash_attention`, forward and
    gradients."""
    q, k, v = _qkv(1, 4, 2, 64, 256, 91)
    do = torch.from_numpy(seeded_random(q.shape, 92))
    tmesh = make_mesh((4,), ("sp",), ["cpu"] * 4)
    for kw in (dict(causal=True), dict(causal=True, window=24)):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v))
        o_t = tring.ring_attention(tq, tk, tv, tmesh, **kw)
        g_t = torch.autograd.grad(o_t, (tq, tk, tv), do)
        rq, rk, rv = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v))
        o_r = flash_attention(rq, rk, rv, **kw)
        g_r = torch.autograd.grad(o_r, (rq, rk, rv), do)
        assert o_t.dtype == torch.float32 and o_t.shape == o_r.shape
        assert_close(o_t, o_r.detach().numpy(), GATE, f"d=256 ring O {kw}")
        _assert_grads(g_t, [g.numpy() for g in g_r], GATE,
                      f"d=256 ring {kw}")


def test_ring_ragged_over_eight_ranks():
    """N = 100 over 8 ranks, as the JAX package's own test cuts it:
    forward against JAX, gradients against one device."""
    for causal in (False, True):
        q, k, v = _qkv(1, 1, 1, 100, 16, 42)
        o_j, o_t, g_r, g_t = _both(8, q, k, v, seeded_random(q.shape, 77),
                                   jax_grads=False, causal=causal)
        assert_close(o_t, o_j, GATE, f"ragged ring O (causal={causal})")
        _assert_grads(g_t, g_r, GATE, f"ragged ring causal={causal}")


def test_ring_rejects_bad_arguments():
    _, tmesh = _meshes(4)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 3, 2, 64, 16, 1))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tring.ring_attention(q, k, v, tmesh)
    q = q[:, :2]
    with pytest.raises(ValueError, match="window requires causal"):
        tring.ring_attention(q, k, v, tmesh, window=8)
    with pytest.raises(TypeError, match="BlockSizes"):
        tring.ring_attention(q, k, v, tmesh, block_sizes=(8, 8))
    # a tile below every build runs at the smallest one
    assert torch.equal(
        tring.ring_attention(q, k, v, tmesh,
                             block_sizes=BlockSizes(block_k=8)),
        tring.ring_attention(q, k, v, tmesh))
