"""An fp32 model served over bf16 caches, in the torch port against the
JAX package on the CPU: the same numpy inputs (seeded) go through the JAX
function (Pallas in interpret mode) and its counterpart in the port (the
plain versions of the kernels).

- The forward with an fp32 Q over bf16 K/V (the prefix reads of an fp32
  model's chunked prefill over a bf16 cache): online (K1), bound (K1b)
  and bound under causal (K5 in both packages; window, GQA), O and LSE
  within 1e-4.
- `out_dtype`: float16 within one fp16 ulp (2^-10 for |O| < 1); int32 and
  bool as the cast of the fp32 O, which the JAX function also computes;
  float64 and complex64 refused by both.
- Decode and paged decode of an fp32 q over a bf16 cache, O and LSE
  within 1e-4.
- The fp32 model's `prefill_chunked` and `decode_one` over caches made
  with `init_cache(..., dtype=bfloat16)`: logits within 1e-3 · max(1,
  max |JAX|) and greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_tpu.ops import kv_cache as jkv
from cuda_flashattention_tpu.ops import paged as jpaged
from cuda_flashattention_tpu.ops.decode import decode_attention as jax_decode
from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_fwd,
)
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import params_from_jax
from cuda_flashattention_torch.ops import flash_fwd as ff
from cuda_flashattention_torch.ops import kv_cache as tkv
from cuda_flashattention_torch.ops import paged as tpaged
from cuda_flashattention_torch.ops.decode import decode_attention

GATE = 1e-4
FP16_GATE = 2.0 ** -10  # one fp16 ulp in [0.5, 1)
LOGIT_GATE = 1e-3


def _u(rng, *shape, peak=1.0):
    return (rng.uniform(-1, 1, shape) * peak).astype(np.float32)


def _bf16(x):
    """x rounded to bf16, as fp32 numpy (both packages then hold the same
    bf16 values)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# (name, (B, H, Hkv, Nq, Nk, d), mask, softmax, the port's routed form)
FWD_CASES = [
    ("online causal", (1, 4, 2, 40, 70, 64),
     dict(causal=True, kv_offset=30), "online", "online"),
    ("bound", (1, 4, 2, 40, 70, 64), {}, "bound", "bound"),
    ("kmajor causal", (1, 4, 2, 40, 70, 64),
     dict(causal=True, kv_offset=30), "bound", "kmajor"),
    ("kmajor window", (1, 4, 1, 40, 70, 64),
     dict(causal=True, window=24, kv_offset=30), "bound", "kmajor"),
]


def _fwd_inputs(shape, seed):
    b, h, hkv, nq, nk, d = shape
    rng = np.random.default_rng(seed)
    return (_u(rng, b, h, nq, d, peak=4.0), _bf16(_u(rng, b, hkv, nk, d)),
            _bf16(_u(rng, b, hkv, nk, d)))


def _jax_args(q, k, v):
    return (jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16))


def _torch_args(q, k, v):
    return (torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
            torch.from_numpy(v).bfloat16())


@pytest.fixture(scope="module")
def fwd_jax():
    """The JAX forward of each case, fp32 out (one compile each)."""
    out = {}
    for i, (name, shape, kw, softmax, _) in enumerate(FWD_CASES):
        x = _fwd_inputs(shape, i)
        out[name] = (x, jax_fwd(*_jax_args(*x), softmax=softmax, **kw))
    return out


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_forward_fp32_q_over_bf16_kv_matches_jax(fwd_jax, case):
    name, _, kw, softmax, form = case
    x, (o_j, lse_j) = fwd_jax[name]
    q, k, v = _torch_args(*x)
    plan = ff._plan(q, k, v, None, kw.get("causal", False),
                    kw.get("window", 0), kw.get("kv_offset", 0), None, None,
                    None, None, None, softmax, False)
    assert (plan.use_bound, plan.use_kmajor) == (form != "online",
                                                 form == "kmajor")
    o, lse = ff.flash_attention_forward(q, k, v, softmax=softmax, **kw)
    assert o.dtype == torch.float32 and o_j.dtype == jnp.float32
    assert _diff(o, o_j) <= GATE and _diff(lse, lse_j) <= GATE


@pytest.fixture(scope="module")
def out_case():
    shape, kw = (1, 4, 2, 40, 70, 64), dict(causal=True, kv_offset=30)
    q, k, v = _fwd_inputs(shape, 7)
    v = v * 4.0  # |O| past 1: the int32 cast is not all zeros
    return (q, k, v), kw


def test_out_dtype_float16_matches_jax(out_case):
    (q, k, v), kw = out_case
    o_j, _ = jax_fwd(*_jax_args(q, k, v), out_dtype=jnp.float16, **kw)
    o, _ = ff.flash_attention_forward(*_torch_args(q, k, v),
                                      out_dtype=torch.float16, **kw)
    assert o.dtype == torch.float16 and o_j.dtype == jnp.float16
    top = max(1.0, float(np.max(np.abs(np.asarray(o_j, np.float32)))))
    assert _diff(o.float(), o_j) <= FP16_GATE * top


@pytest.mark.parametrize("dt", ["int32", "bool"])
def test_other_out_dtypes_are_the_cast_jax_computes(out_case, dt):
    (q, k, v), kw = out_case
    o_j, _ = jax_fwd(*_jax_args(q, k, v), out_dtype=getattr(jnp, dt), **kw)
    o, _ = ff.flash_attention_forward(*_torch_args(q, k, v),
                                      out_dtype=getattr(torch, dt), **kw)
    o32, _ = ff.flash_attention_forward(*_torch_args(q, k, v), **kw)
    assert str(o.dtype) == f"torch.{dt}" and str(o_j.dtype) == dt
    assert torch.equal(o, o32.to(o.dtype))
    assert np.array_equal(o.numpy(), np.asarray(o_j))
    if dt == "int32":
        assert o.abs().max().item() >= 1


@pytest.mark.parametrize("dt", ["float64", "complex64"])
def test_out_dtypes_jax_refuses_are_refused(out_case, dt):
    (q, k, v), kw = out_case
    with pytest.raises((ValueError, NotImplementedError)):
        jax_fwd(*_jax_args(q, k, v), out_dtype=getattr(jnp, dt), **kw)
    with pytest.raises(ValueError, match="out_dtype"):
        ff.flash_attention_forward(*_torch_args(q, k, v),
                                   out_dtype=getattr(torch, dt), **kw)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("window", [0, 20])
def test_decode_fp32_q_over_bf16_cache_matches_jax(d, window):
    rng = np.random.default_rng(d + window)
    q = _u(rng, 2, 8, d, peak=4.0)
    k, v = _bf16(_u(rng, 2, 2, 50, d)), _bf16(_u(rng, 2, 2, 50, d))
    lengths = np.array([50, 17], np.int32)
    o_j, lse_j = jax_decode(*_jax_args(q, k, v), jnp.asarray(lengths),
                            window=window)
    o, lse = decode_attention(*_torch_args(q, k, v),
                              torch.from_numpy(lengths), window=window)
    assert o.dtype == torch.float32 and o_j.dtype == jnp.float32
    assert _diff(o, o_j) <= GATE and _diff(lse, lse_j) <= GATE


def test_paged_decode_fp32_q_over_bf16_pools_matches_jax():
    """Pools of 8-token pages in bf16, page tables that interleave the two
    sequences' pages, an fp32 q."""
    rng = np.random.default_rng(3)
    b, h, hkv, page, n_pages, d = 2, 8, 2, 8, 12, 32
    q = _u(rng, b, h, d, peak=4.0)
    kp = _bf16(_u(rng, n_pages, hkv, page, d))
    vp = _bf16(_u(rng, n_pages, hkv, page, d))
    table = np.array([[1, 3, 5, 7, 9], [0, 2, 4, 6, 8]], np.int32)
    lengths = np.array([37, 21], np.int32)
    o_j, lse_j = jpaged.paged_decode_attention(
        *_jax_args(q, kp, vp), jnp.asarray(table), jnp.asarray(lengths))
    o, lse = tpaged.paged_decode_attention(
        *_torch_args(q, kp, vp), torch.from_numpy(table),
        torch.from_numpy(lengths))
    assert o.dtype == torch.float32
    assert _diff(o, o_j) <= GATE and _diff(lse, lse_j) <= GATE


JCFG = jtf.TransformerConfig(
    vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, max_seq=64, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(
    vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, max_seq=64, dtype=torch.float32)
PROMPT, CHUNK, STEPS, MAX_LEN = 7, 3, 4, 16


def test_fp32_model_serves_over_bf16_caches_like_jax():
    """The JAX functions take this path as their signatures say: an fp32
    model's `prefill_chunked` and `decode_one` over caches that
    `init_cache(..., dtype=bfloat16)` made. The port, on the same weights
    (`params_from_jax`), gives the last chunk's and every step's logits
    within 1e-3 · max(1, max |JAX|), the same greedy tokens, and caches
    that hold the same bf16 values."""
    jparams = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            TCFG)
    prompt = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, (2, PROMPT)).astype(np.int32)
    jc = tuple(jkv.init_cache(2, JCFG.n_kv_heads, MAX_LEN, JCFG.d_head,
                              dtype=jnp.bfloat16)
               for _ in range(JCFG.n_layers))
    tc = tuple(tkv.init_cache(2, TCFG.n_kv_heads, MAX_LEN, TCFG.d_head,
                              dtype=torch.bfloat16, device="cpu")
               for _ in range(TCFG.n_layers))
    lj, jc = jtf.prefill_chunked(jparams, jnp.asarray(prompt), JCFG, jc,
                                 chunk=CHUNK)
    lt, tc = ttf.prefill_chunked(model, torch.from_numpy(prompt), tc,
                                 chunk=CHUNK)
    assert all(c.k.dtype == jnp.bfloat16 for c in jc)
    assert all(c.k.dtype == torch.bfloat16 for c in tc)
    logits = [(lj, lt)]
    tok_j, tok_t = jnp.argmax(lj, -1), torch.argmax(lt, -1)
    toks = [(np.asarray(tok_j), tok_t.numpy())]
    for i in range(STEPS):
        lj, jc = jtf.decode_one(jparams, tok_j.astype(jnp.int32),
                                PROMPT + i, JCFG, jc)
        lt, tc = ttf.decode_one(model, tok_t.to(torch.int32), PROMPT + i,
                                tc)
        tok_j, tok_t = jnp.argmax(lj, -1), torch.argmax(lt, -1)
        logits.append((lj, lt))
        toks.append((np.asarray(tok_j), tok_t.numpy()))
    for a, b in logits:
        top = max(1.0, float(np.max(np.abs(np.asarray(a)))))
        assert _diff(b, a) <= LOGIT_GATE * top
    for a, b in toks:
        assert np.array_equal(a, b)
    for a, b in zip(jc, tc):
        assert int(a.length) == b.length == PROMPT + STEPS
        assert _diff(b.k.float(), a.k) <= LOGIT_GATE
