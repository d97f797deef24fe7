"""Parity of the torch port's FlashAttention-1 rung with the JAX
package's (`fa1_attention`, Pallas kernel in interpret mode on the CPU):
causal and not, ragged N, Nq != Nk, and a sweep of block sizes. Gates on
O: fp32 1e-4 (the JAX suite holds FA1 to 1e-3 of the oracle) and bf16
5e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops.fa1 import fa1_attention as jax_fa1
from cuda_flashattention_torch.ops import fa1 as tfa1
from cuda_flashattention_torch.ops.fa1 import (
    fa1_attention,
    fa1_attention_plain,
)
from cuda_flashattention_torch.ops.naive import naive_attention

GATES = {"float32": 1e-4, "bfloat16": 5e-3}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, b, h, nq, nk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1.0, 1.0, shape).astype(np.float32)
                 for shape in ((b, h, nq, d), (b, h, nk, d), (b, h, nk, d)))


def _both(q, k, v, dtype, **kw):
    o_j = jax_fa1(*[jnp.asarray(a, JAX_DT[dtype]) for a in (q, k, v)], **kw)
    o_t = fa1_attention(
        *[torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v)], **kw)
    assert o_t.dtype == TORCH_DT[dtype] and tuple(o_t.shape) == q.shape
    return float(np.max(np.abs(np.asarray(o_j, np.float32)
                               - o_t.float().numpy()))), o_t


# (b, h, nq, nk, d, causal, block_q, block_k)
CASES = [
    (2, 2, 64, 64, 32, False, 256, 256),
    (2, 2, 64, 64, 32, True, 256, 256),
    (1, 3, 50, 50, 32, True, 16, 16),     # ragged N: padded and masked
    (1, 2, 37, 83, 64, False, 8, 24),     # Nq != Nk, ragged in both
    (1, 2, 40, 24, 32, True, 16, 8),      # rows past the last key
    (1, 1, 96, 96, 16, True, 32, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,nq,nk,d,causal,block_q,block_k", CASES)
def test_fa1_matches_jax(b, h, nq, nk, d, causal, block_q, block_k, dtype):
    q, k, v = _inputs(nq + nk + d, b, h, nq, nk, d)
    err, _ = _both(q, k, v, dtype, causal=causal, block_q=block_q,
                   block_k=block_k)
    assert err <= GATES[dtype]


@pytest.mark.parametrize("block_k", [8, 16, 32, 48, 128])
@pytest.mark.parametrize("block_q", [8, 32, 128])
def test_fa1_block_size_sweep(block_q, block_k):
    q, k, v = _inputs(7, 1, 2, 72, 72, 32)
    err, o_t = _both(q, k, v, "float32", causal=True, block_q=block_q,
                     block_k=block_k)
    assert err <= GATES["float32"]
    ref, _ = naive_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True)
    assert torch.max(torch.abs(o_t - ref)) <= 1e-3  # the JAX gate for FA1


def test_fa1_custom_scale_and_oracle():
    q, k, v = _inputs(9, 1, 2, 40, 40, 32)
    err, o_t = _both(q, k, v, "float32", scale=0.3, causal=False,
                     block_q=16, block_k=16)
    assert err <= GATES["float32"]
    ref, _ = naive_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             scale=0.3)
    assert torch.max(torch.abs(o_t - ref)) <= 1e-3


def test_fa1_gqa_raises():
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="no GQA"):
        fa1_attention(q, kv, kv)
    with pytest.raises(ValueError):
        jax_fa1(jnp.zeros((1, 4, 8, 16)), jnp.zeros((1, 2, 8, 16)),
                jnp.zeros((1, 2, 8, 16)))


def test_cpu_wrapper_is_the_plain_version_with_clamped_blocks():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 20, 20, 16))
    before = fa1_attention.launches
    got = fa1_attention(q, k, v, causal=True)  # 256 clamps to 24
    want = fa1_attention_plain(q, k, v, causal=True, block_q=24, block_k=24)
    assert torch.equal(got, want) and fa1_attention.launches == before
    meta = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa1_attention(meta, meta, meta)


@pytest.mark.parametrize("nq,nk,block_q,block_k,want", [
    (4096, 4096, 256, 256, 4),
    (4096, 4096, 64, 64, 1),
    (512, 512, 128, 192, 3),
    (100, 104, 104, 104, 2),    # one block over all keys
    (100, 40, 104, 40, 1),
    (37, 300, 40, 304, None),   # one block, but past 256 keys
    (512, 512, 128, 96, None),  # not a multiple of 64
    (512, 512, 96, 128, None),  # block_q neither a multiple of 64 nor all
])
def test_block_sizes_the_card_takes(nq, nk, block_q, block_k, want):
    if want is None:
        with pytest.raises(ValueError, match="the CUDA FA1 takes"):
            tfa1._kernel_sub_tiles(nq, nk, block_q, block_k)
    else:
        assert tfa1._kernel_sub_tiles(nq, nk, block_q, block_k) == want


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_fa1_padded_heads_match_the_unpadded_plain_and_jax(d, causal):
    """What the card runs at a narrow head: Q (prescaled at d's scale), K
    and V zero-padded to the kernel's d = 64 (`ops.common.pad_heads`),
    O sliced back. On the CPU the plain version on the padded heads
    equals the plain version at d and JAX's `fa1_attention` at d (fp32,
    the reference rung's own precision: its seeded 64 x 32 case
    included)."""
    from cuda_flashattention_torch.ops.common import pad_heads
    q, k, v = _inputs(d + causal, 1, 2, 64, 64, d)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    scale = d ** -0.5
    qs = tfa1._prescale_q(qt, scale)
    d_run, (qp, kp, vp) = pad_heads("FA1", qs, kt, vt)
    assert d_run == 64 and qp.shape[-1] == 64
    padded = fa1_attention_plain(qp, kp, vp, scale=1.0, causal=causal,
                                 block_q=64, block_k=64)[..., :d]
    unpadded = fa1_attention_plain(qt, kt, vt, causal=causal, block_q=64,
                                   block_k=64)
    assert float((padded - unpadded).abs().max()) <= 1e-6
    err, _ = _both(q, k, v, "float32", causal=causal, block_q=64,
                   block_k=64)
    o_j = jax_fa1(*[jnp.asarray(a) for a in (q, k, v)], causal=causal,
                  block_q=64, block_k=64)
    assert err <= GATES["float32"]
    assert float(np.max(np.abs(np.asarray(o_j) - padded.numpy()))) <= (
        GATES["float32"])
