"""fp32 at head width 256, in the torch port against the JAX package on
the CPU: the same numpy inputs (seeded) go through the JAX function
(Pallas in interpret mode) and through the port's (the plain versions of
the kernels, which the fp32 d = 256 builds of K1, K1b and K5 compute on
the card).

- An fp32 model at d_head 256 (vocab 64, d_model 64, 2 layers, 2 heads
  over 1 KV head, d_ff 128) on JAX's weights (`params_from_jax`):
  `prefill_chunked` (chunks of 3 over a 7-token prompt) and 4 greedy
  `decode_one` steps over a bf16 cache, an fp8 one, a mixed one (int8 K,
  fp8 V) and, with a sliding window of 4, an int8 one. The last chunk's
  and every step's logits within 1e-3 · max(1, max |JAX|), the greedy
  tokens equal.
- One call with every feature at once: GQA 4:2, causal with `kv_offset`,
  a sliding window, segment ids and a ragged Nq != Nk, fp32, at d = 256
  and at d = 200. The forward's O and LSE, and the backward's dQ, dK and
  dV, within 1e-4 · max(1, max |JAX|).

One JAX call per case, kept in module-scoped fixtures.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_tpu.ops import kv_cache as jkv
from cuda_flashattention_tpu.ops.flash_bwd import (
    flash_attention_backward as jax_bwd,
)
from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_fwd,
)
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import params_from_jax
from cuda_flashattention_torch.ops import kv_cache as tkv
from cuda_flashattention_torch.ops.flash_bwd import flash_attention_backward
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_torch.utils.testing import seeded_random

LOGIT_GATE = 1e-3
F32_GATE = 1e-4


def _diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _within(got, want, gate):
    top = max(1.0, float(np.max(np.abs(np.asarray(want, np.float32)))))
    return _diff(got, want) <= gate * top


# ---- the fp32 model at d_head 256 over every cache ------------------------

_SIZES = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
              n_kv_heads=1, d_head=256, d_ff=128, max_seq=64)
JCFG = jtf.TransformerConfig(**_SIZES, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(**_SIZES, dtype=torch.float32)
PROMPT, CHUNK, STEPS, MAX_LEN = 7, 3, 4, 16

# name: (qtype, cache dtype, window)
CACHES = {
    "bf16": (None, "bfloat16", 0),
    "fp8": ("fp8", "float32", 0),
    "mixed": ("mixed", "float32", 0),
    "int8 window 4": ("int8", "float32", 4),
}


@pytest.fixture(scope="module")
def model_pair():
    """JAX's weights at d_head 256, the port's model holding them, and a
    prompt."""
    jparams = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            TCFG)
    prompt = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, (2, PROMPT)).astype(np.int32)
    return jparams, model, prompt


def _serve_jax(jparams, prompt, name):
    qtype, dtype, window = CACHES[name]
    cfg = dataclasses.replace(JCFG, window=window)
    caches = tuple(jkv.init_cache(2, cfg.n_kv_heads, MAX_LEN, cfg.d_head,
                                  qtype=qtype, dtype=getattr(jnp, dtype))
                   for _ in range(cfg.n_layers))
    lg, caches = jtf.prefill_chunked(jparams, jnp.asarray(prompt), cfg,
                                     caches, chunk=CHUNK)
    logits, toks = [lg], [jnp.argmax(lg, -1)]
    for i in range(STEPS):
        lg, caches = jtf.decode_one(jparams, toks[-1].astype(jnp.int32),
                                    PROMPT + i, cfg, caches)
        logits.append(lg)
        toks.append(jnp.argmax(lg, -1))
    return [np.asarray(x) for x in logits], [np.asarray(t) for t in toks]


@pytest.fixture(scope="module")
def served_jax(model_pair):
    """{cache: (logits of the last chunk and of each step, greedy tokens)}
    from the JAX functions."""
    jparams, _, prompt = model_pair
    return {name: _serve_jax(jparams, prompt, name) for name in CACHES}


@pytest.mark.parametrize("name", list(CACHES))
def test_fp32_d256_model_serves_every_cache_like_jax(model_pair, served_jax,
                                                     name):
    """`prefill_chunked` then greedy `decode_one` steps over the cache:
    each logits row within the gate of JAX's, the same tokens, and a
    cache of the storage JAX holds."""
    _, model, prompt = model_pair
    qtype, dtype, window = CACHES[name]
    if window:  # the same parameters under another config
        model = copy.copy(model)
        model.cfg = dataclasses.replace(TCFG, window=window)
    caches = tuple(tkv.init_cache(2, TCFG.n_kv_heads, MAX_LEN, TCFG.d_head,
                                  qtype=qtype, dtype=getattr(torch, dtype),
                                  device="cpu")
                   for _ in range(TCFG.n_layers))
    lg, caches = ttf.prefill_chunked(model, torch.from_numpy(prompt),
                                     caches, chunk=CHUNK)
    logits, toks = [lg], [torch.argmax(lg, -1)]
    for i in range(STEPS):
        lg, caches = ttf.decode_one(model, toks[-1].to(torch.int32),
                                    PROMPT + i, caches)
        logits.append(lg)
        toks.append(torch.argmax(lg, -1))
    logits_j, toks_j = served_jax[name]
    for got, want in zip(logits, logits_j):
        assert _within(got, want, LOGIT_GATE)
    for got, want in zip(toks, toks_j):
        assert np.array_equal(got.numpy(), want)
    stored = {None: getattr(torch, dtype), "int8": torch.int8,
              "fp8": torch.float8_e4m3fn, "mixed": torch.int8}[qtype]
    assert all(c.k.dtype == stored and c.length == PROMPT + STEPS
               for c in caches)


# ---- every feature at once, forward and backward --------------------------

B, H, H_KV, NQ, NK, OFFSET, WINDOW = 2, 4, 2, 37, 53, 16, 24
# packed sequences over the keys; the rows are the last NQ positions
SEG_LENGTHS = [9, 1, 20, 23]


def _stacked_args(d):
    """fp32 q, k, v, dO and the rows' and keys' segment ids."""
    seed = 4000 + d
    q = seeded_random((B, H, NQ, d), seed)
    k = seeded_random((B, H_KV, NK, d), seed + 1)
    v = seeded_random((B, H_KV, NK, d), seed + 2)
    do = seeded_random((B, H, NQ, d), seed + 3)
    kv_seg = np.broadcast_to(
        np.repeat(np.arange(len(SEG_LENGTHS)), SEG_LENGTHS),
        (B, NK)).astype(np.int32).copy()
    q_seg = kv_seg[:, OFFSET:OFFSET + NQ].copy()
    return (q, k, v, do), q_seg, kv_seg


MASKS = dict(causal=True, window=WINDOW, kv_offset=OFFSET)


@pytest.fixture(scope="module")
def stacked_jax():
    """{d: (O, LSE, dQ, dK, dV)} from the JAX package."""
    out = {}
    for d in (256, 200):
        (q, k, v, do), q_seg, kv_seg = _stacked_args(d)
        jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
        seg = dict(q_segment_ids=jnp.asarray(q_seg),
                   kv_segment_ids=jnp.asarray(kv_seg))
        o, lse = jax_fwd(jq, jk, jv, **MASKS, **seg)
        grads = jax_bwd(jq, jk, jv, o, lse, jdo, **MASKS, **seg)
        out[d] = tuple(np.asarray(x, np.float32) for x in (o, lse, *grads))
    return out


@pytest.mark.parametrize("d", [256, 200])
def test_every_feature_at_once_fp32_matches_jax(stacked_jax, d):
    """GQA, causal with kv_offset, a window, segment ids and a ragged Nq
    != Nk in one fp32 call: O, LSE, dQ, dK and dV within 1e-4 · max(1,
    max |JAX|)."""
    (q, k, v, do), q_seg, kv_seg = _stacked_args(d)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    seg = dict(q_segment_ids=torch.from_numpy(q_seg),
               kv_segment_ids=torch.from_numpy(kv_seg))
    o, lse = flash_attention_forward(tq, tk, tv, **MASKS, **seg)
    grads = flash_attention_backward(tq, tk, tv, o, lse, tdo, **MASKS,
                                     **seg)
    want = stacked_jax[d]
    got = (o, lse, *grads)
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    assert all(x.dtype == torch.float32 for x in got)
    for name, g, w in zip(("O", "LSE", "dQ", "dK", "dV"), got, want):
        assert _within(g, w, F32_GATE), (name, _diff(g, w))
