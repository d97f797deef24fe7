"""Parity of the torch port's sharded-cache decode (`ring_decode`) with
the JAX package's (`parallel/ring.py`).

The same numpy inputs go through the JAX function on the virtual CPU mesh
of tests/conftest.py (Pallas decode kernel in interpret mode) and through
the port on a mesh of repeated "cpu" devices (plain version of the
kernel). Gates on O and LSE: 1e-4 in fp32, an int8 cache 1e-3, fp8 and
mixed caches 1e-2 (the JAX CPU path flushes fp8 subnormal codes, the port
does not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops.quant import quantize_kv as jax_quantize_kv
from cuda_flashattention_tpu.parallel import ring as jring
from cuda_flashattention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cuda_flashattention_torch.ops.quant import quantize_kv
from cuda_flashattention_torch.parallel import ring as tring
from cuda_flashattention_torch.parallel.mesh import make_mesh, shard_on_axis
from cuda_flashattention_torch.utils.testing import (
    assert_close,
    seeded_random,
)

GATE = 1e-4
QUANT_GATES = {"int8": 1e-3, "fp8": 1e-2, "mixed": 1e-2}


def _meshes(n):
    return (jax_make_mesh((n,), ("sp",), jax.devices()[:n]),
            make_mesh((n,), ("sp",), ["cpu"] * n))



def _decode_inputs(b, n, seed):
    return (seeded_random((b, 2, 32), seed),
            seeded_random((b, 2, n, 32), 43), seeded_random((b, 2, n, 32), 44))


def _decode_both(q, k, v, lengths, **kw):
    jmesh, tmesh = _meshes(4)
    jl = lengths if np.isscalar(lengths) else jnp.asarray(lengths, jnp.int32)
    tl = lengths if np.isscalar(lengths) else torch.tensor(lengths)
    o_j, lse_j = jring.ring_decode(*(jnp.asarray(a) for a in (q, k, v)), jl,
                                   jmesh, **kw)
    o_t, lse_t = tring.ring_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                                   tl, tmesh, **kw)
    assert tuple(o_t.shape) == q.shape and tuple(lse_t.shape) == q.shape[:2]
    return o_j, lse_j, o_t, lse_t


@pytest.mark.parametrize("global_len", [1, 100, 256])
def test_ring_decode(global_len):
    q, k, v = _decode_inputs(1, 256, 5)
    o_j, lse_j, o_t, lse_t = _decode_both(q, k, v, global_len)
    assert_close(o_t, o_j, GATE, "ring decode O")
    assert_close(lse_t, lse_j, GATE, "ring decode LSE")


def test_ring_decode_per_sequence_lengths():
    q, k, v = _decode_inputs(3, 256, 7)
    o_j, lse_j, o_t, lse_t = _decode_both(q, k, v, [1, 100, 256])
    assert_close(o_t, o_j, GATE, "ring decode O")
    assert_close(lse_t, lse_j, GATE, "ring decode LSE")


@pytest.mark.parametrize("window", [40, 100, 300])
def test_ring_decode_window(window):
    """The global window cut falls mid-shard, spans shards, or exceeds
    the context."""
    q, k, v = _decode_inputs(2, 256, 9)
    o_j, lse_j, o_t, lse_t = _decode_both(q, k, v, [180, 256], window=window)
    assert_close(o_t, o_j, GATE, f"windowed ring decode O (w={window})")
    assert_close(lse_t, lse_j, GATE, f"windowed ring decode LSE (w={window})")


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_ring_decode_quantized(qtype):
    """The same codes and scales on both sides, through the sharded path,
    given once as global tensors and once as the ranks' resident shards."""
    q = seeded_random((1, 2, 32), 6)
    k, v = seeded_random((1, 2, 512, 32), 43), seeded_random((1, 2, 512, 32),
                                                             44)
    kv_j = jax_quantize_kv(jnp.asarray(k), jnp.asarray(v), qtype)
    kv_t = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qtype)
    np.testing.assert_array_equal(kv_t.k_q.view(torch.uint8).numpy(),
                                  np.asarray(kv_j.k_q).view(np.uint8))
    jmesh, tmesh = _meshes(4)
    o_j, lse_j = jring.ring_decode(jnp.asarray(q), kv_j.k_q, kv_j.v_q, 400,
                                   jmesh, k_scale=kv_j.k_scale,
                                   v_scale=kv_j.v_scale)
    o_t, lse_t = tring.ring_decode(torch.from_numpy(q), kv_t.k_q, kv_t.v_q,
                                   400, tmesh, k_scale=kv_t.k_scale,
                                   v_scale=kv_t.v_scale)
    assert_close(o_t, o_j, QUANT_GATES[qtype], f"ring decode {qtype} O")
    assert_close(lse_t, lse_j, QUANT_GATES[qtype], f"ring decode {qtype} LSE")
    cut = lambda x: shard_on_axis(tmesh, x, 2, "sp")
    o_s, lse_s = tring.ring_decode(
        torch.from_numpy(q), cut(kv_t.k_q), cut(kv_t.v_q), 400, tmesh,
        k_scale=cut(kv_t.k_scale), v_scale=cut(kv_t.v_scale))
    assert torch.equal(o_s, o_t) and torch.equal(lse_s, lse_t)


def test_ring_decode_ragged_cache():
    """A cache length that does not divide the axis is padded to the
    shard grid (scales with 1.0); pad rows lie past every live token."""
    n = 250
    q, k, v = _decode_inputs(1, n, 9)
    for glen in (n, 123):
        o_j, lse_j, o_t, lse_t = _decode_both(q, k, v, glen)
        assert_close(o_t, o_j, GATE, f"ragged ring decode O@{glen}")
        assert_close(lse_t, lse_j, GATE, f"ragged ring decode LSE@{glen}")
    kv_j = jax_quantize_kv(jnp.asarray(k), jnp.asarray(v), "int8")
    kv_t = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), "int8")
    jmesh, tmesh = _meshes(4)
    o_j, _ = jring.ring_decode(jnp.asarray(q), kv_j.k_q, kv_j.v_q, n, jmesh,
                               k_scale=kv_j.k_scale, v_scale=kv_j.v_scale)
    o_t, _ = tring.ring_decode(torch.from_numpy(q), kv_t.k_q, kv_t.v_q, n,
                               tmesh, k_scale=kv_t.k_scale,
                               v_scale=kv_t.v_scale)
    assert_close(o_t, o_j, QUANT_GATES["int8"], "ragged ring decode int8 O")


def test_ring_decode_int8_merge_within_1e3_of_the_whole_cache():
    """An int8 cache sharded over 4 ranks: the fp32 merge of the ranks'
    partials (`_merge_ranks`, what `ring_decode_local` computes before its
    cast to q's dtype) within 1e-3 of one decode over the whole cache and
    of the JAX package's ring decode."""
    from cuda_flashattention_torch.ops.decode import decode_attention
    q = seeded_random((2, 4, 32), 12)
    k, v = seeded_random((2, 2, 512, 32), 43), seeded_random((2, 2, 512, 32),
                                                             44)
    lengths = np.array([300, 512], np.int32)
    kv_t = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), "int8")
    kv_j = jax_quantize_kv(jnp.asarray(k), jnp.asarray(v), "int8")
    jmesh, tmesh = _meshes(4)
    cut = lambda x: shard_on_axis(tmesh, x, 2, "sp")
    qt, lt = torch.from_numpy(q), torch.from_numpy(lengths)
    parts = []
    for i, (ks, vs, kss, vss) in enumerate(zip(
            cut(kv_t.k_q), cut(kv_t.v_q), cut(kv_t.k_scale),
            cut(kv_t.v_scale))):
        local = (lt - 128 * i).clamp(0, 128)
        parts.append(decode_attention(qt, ks, vs, local, k_scale=kss,
                                      v_scale=vss))
    o32, lse = tring._merge_ranks(parts, qt.device)
    assert o32.dtype == torch.float32
    o_w, lse_w = decode_attention(qt, kv_t.k_q, kv_t.v_q, lt,
                                  k_scale=kv_t.k_scale, v_scale=kv_t.v_scale)
    assert_close(o32, o_w, QUANT_GATES["int8"], "int8 merge vs whole O")
    assert_close(lse, lse_w, QUANT_GATES["int8"], "int8 merge vs whole LSE")
    o_j, lse_j = jring.ring_decode(jnp.asarray(q), kv_j.k_q, kv_j.v_q,
                                   jnp.asarray(lengths), jmesh,
                                   k_scale=kv_j.k_scale, v_scale=kv_j.v_scale)
    assert_close(o32, o_j, QUANT_GATES["int8"], "int8 merge vs JAX O")
    assert_close(lse, lse_j, QUANT_GATES["int8"], "int8 merge vs JAX LSE")
    o_r, lse_r = tring.ring_decode(qt, cut(kv_t.k_q), cut(kv_t.v_q), lt,
                                   tmesh, k_scale=cut(kv_t.k_scale),
                                   v_scale=cut(kv_t.v_scale))
    assert torch.equal(o_r, o32) and torch.equal(lse_r, lse)
