"""Parity of the torch port's Ulysses attention with the JAX package's
(`parallel/ulysses.py`): the same numpy inputs through the JAX function
on the virtual CPU mesh (Pallas in interpret mode) and through the port on
a mesh of repeated "cpu" devices. Neither function takes a `softmax`
argument: both run their local attention under `softmax="auto"`. Gates:
fp32 outputs 1e-4, gradients 1e-4 · max |JAX|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cuda_flashattention_tpu.parallel.ulysses import (
    ulysses_attention as jax_ulysses,
)
from cuda_flashattention_torch.ops.naive import naive_attention
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.parallel.ring import ring_attention
from cuda_flashattention_torch.parallel.ulysses import ulysses_attention
from cuda_flashattention_torch.utils.testing import (
    assert_close,
    max_abs,
    seeded_random,
)

GATE = 1e-4


@pytest.fixture(scope="module")
def setup():
    jmesh = jax_make_mesh((4,), ("sp",), jax.devices()[:4])
    tmesh = make_mesh((4,), ("sp",), ["cpu"] * 4)
    q, k, v = (seeded_random((1, 4, 64, 16), seed=s) for s in (151, 152, 153))
    return jmesh, tmesh, (q, k, v)


def _both(jmesh, tmesh, q, k, v, do=None, segment_ids=None, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if segment_ids is not None:
        jkw["segment_ids"] = jnp.asarray(segment_ids, jnp.int32)
        tkw["segment_ids"] = torch.tensor(segment_ids, dtype=torch.int32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(do is not None)
                  for a in (q, k, v))
    o_j = jax_ulysses(jq, jk, jv, mesh=jmesh, **jkw)
    o_t = ulysses_attention(tq, tk, tv, mesh=tmesh, **tkw)
    assert tuple(o_t.shape) == q.shape
    assert_close(o_t, o_j, GATE, f"ulysses O {kw}")
    if do is None:
        return o_t
    g_j = jax.grad(
        lambda *a: jnp.sum(jax_ulysses(*a, mesh=jmesh, **jkw) * do),
        argnums=(0, 1, 2))(jq, jk, jv)
    g_t = torch.autograd.grad(o_t, (tq, tk, tv), torch.from_numpy(do))
    for name, a, b in zip(("dQ", "dK", "dV"), g_t, g_j):
        assert max_abs(b) > 0
        assert_close(a, b, GATE * max_abs(b), f"ulysses {name} {kw}")
    return o_t


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(setup, causal):
    jmesh, tmesh, (q, k, v) = setup
    o = _both(jmesh, tmesh, q, k, v, causal=causal)
    o_ref, _ = naive_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal)
    assert_close(o, o_ref, GATE, "ulysses vs oracle")


def test_ulysses_vs_ring(setup):
    _, tmesh, (q, k, v) = setup
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o_u = ulysses_attention(tq, tk, tv, mesh=tmesh, causal=True)
    o_r = ring_attention(tq, tk, tv, mesh=tmesh, causal=True)
    assert_close(o_u, o_r, GATE, "ulysses vs ring")


def test_ulysses_window(setup):
    jmesh, tmesh, (q, k, v) = setup
    _both(jmesh, tmesh, q, k, v, causal=True, window=20)


def test_ulysses_grad(setup):
    jmesh, tmesh, (q, k, v) = setup
    _both(jmesh, tmesh, q, k, v, do=seeded_random(q.shape, seed=154),
          causal=True)


def test_ulysses_rejects_indivisible_heads(setup):
    _, tmesh, (q, k, v) = setup
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(ValueError, match="divisible by the 'sp' axis"):
        ulysses_attention(tq[:, :3], tk, tv, mesh=tmesh)


def test_ulysses_gqa_head_replication(setup):
    """Hkv = 2 on 4 ranks: KV heads repeat 2× so that each rank owns a
    replica; the gradients fold back onto the true KV heads."""
    jmesh, tmesh, (q, k, v) = setup
    _both(jmesh, tmesh, q, k[:, :2], v[:, :2],
          do=seeded_random(q.shape, seed=191), causal=True)


def test_ulysses_rejects_replication_that_splits_a_group():
    """Hkv = 3 under H = 4 on 4 ranks needs 4× replication, which the
    (broken) GQA group of 4 // 3 = 1 does not allow. With Hkv dividing H
    and the axis dividing H the replication always fits, so this error
    guards malformed head counts, as in the JAX function."""
    tmesh = make_mesh((4,), ("sp",), ["cpu"] * 4)
    q = torch.zeros(1, 4, 16, 8)
    k = v = torch.zeros(1, 3, 16, 8)
    with pytest.raises(ValueError, match="doesn't divide the GQA group"):
        ulysses_attention(q, k, v, mesh=tmesh)


def test_ulysses_segment_ids(setup):
    jmesh, tmesh, (q, k, v) = setup
    ids = [[0] * 20 + [1] * 30 + [2] * 14]
    _both(jmesh, tmesh, q, k, v, segment_ids=ids)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_ragged_seq(setup, causal):
    """N = 50 over 4 ranks: padded to the all-to-all grid; non-causal
    marks the pad rows with segment id −1."""
    jmesh, tmesh, _ = setup
    q, k, v = (seeded_random((1, 4, 50, 16), seed=s) for s in (161, 162, 163))
    _both(jmesh, tmesh, q, k, v, do=seeded_random(q.shape, seed=167),
          causal=causal)


def test_ulysses_ragged_segment_ids(setup):
    jmesh, tmesh, _ = setup
    q, k, v = (seeded_random((1, 4, 50, 16), seed=s) for s in (164, 165, 166))
    _both(jmesh, tmesh, q, k, v, segment_ids=[[0] * 30 + [1] * 20])


def test_ulysses_batch_axis():
    jmesh = jax_make_mesh((2, 4), ("dp", "sp"))
    tmesh = make_mesh((2, 4), ("dp", "sp"), ["cpu"] * 8)
    q, k, v = (seeded_random((2, 4, 32, 16), seed=s) for s in (1, 2, 3))
    _both(jmesh, tmesh, q, k, v, causal=True, batch_axis="dp")
