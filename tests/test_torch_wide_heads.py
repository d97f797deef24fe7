"""Wide and odd head widths, in the torch port against the JAX package on
the CPU: the same numpy inputs (seeded) go through the JAX function
(Pallas in interpret mode) and its counterpart in the port (the plain
versions of the kernels), at the head widths themselves.

- The forward at d = 256 (causal, window, segment ids, the bound form
  and its K-major route, int8 and fp8 K/V, `quantize_q`) and at d = 96
  and 100, `softmax` pinned on both sides: O and LSE within 1e-4 in fp32
  and 5e-3 in bf16.
- Decode and paged decode at d in {8, 80, 96, 256}, ragged lengths, over
  a cache in q's dtype and an int8 one: the same gates.
- A model at d_head 256 (vocab 64, d_model 64, 2 layers, 2 heads over 1
  KV head, d_ff 128, fp32) on JAX's weights (`params_from_jax`): prefill
  logits within 1e-3 · max(1, max |JAX|), `generate()`'s greedy tokens
  (over an fp32 cache and an int8 one) equal to JAX's, and
  `prefill_chunked` against JAX's chunked prefill.

One JAX call per case, kept in module-scoped fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.models import generate as jgen
from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_tpu.ops import paged as jpaged
from cuda_flashattention_tpu.ops.decode import decode_attention as jax_decode
from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_fwd,
)
from cuda_flashattention_tpu.ops.quant import quantize_kv as jax_quantize_kv
from cuda_flashattention_torch.models import generate as tgen
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import params_from_jax
from cuda_flashattention_torch.ops import flash_fwd as ff
from cuda_flashattention_torch.ops import paged as tpaged
from cuda_flashattention_torch.ops.decode import decode_attention
from cuda_flashattention_torch.ops.quant import quantize_kv

GATES = {"float32": 1e-4, "bfloat16": 5e-3}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
LOGIT_GATE = 1e-3


def _diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _u(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def _segments(b, n, lengths):
    ids = np.repeat(np.arange(len(lengths)), lengths)[:n]
    return np.broadcast_to(ids, (b, n)).astype(np.int32).copy()


# (name, (B, H, Hkv, Nq, Nk, d), dtype, qtype, kw, softmax, port's form)
FWD_CASES = [
    ("causal 256 fp32", (1, 4, 2, 40, 70, 256), "float32", None,
     dict(causal=True, kv_offset=30), "online", "online"),
    ("causal 256 bf16", (1, 4, 2, 40, 70, 256), "bfloat16", None,
     dict(causal=True, kv_offset=30), "online", "online"),
    ("window 256 bf16", (2, 4, 1, 40, 70, 256), "bfloat16", None,
     dict(causal=True, window=24, kv_offset=30), "online", "online"),
    ("segments 256 fp32", (2, 4, 2, 48, 48, 256), "float32", None,
     dict(segments=[10, 1, 20, 17]), "online", "online"),
    ("bound 256 fp32", (1, 4, 2, 40, 70, 256), "float32", None, {},
     "bound", "bound"),
    ("kmajor window 256 bf16", (1, 4, 2, 40, 70, 256), "bfloat16", None,
     dict(causal=True, window=24, kv_offset=30), "bound", "kmajor"),
    ("int8 256 bf16", (1, 4, 2, 40, 70, 256), "bfloat16", "int8",
     dict(causal=True, kv_offset=30), "online", "online"),
    ("int8 bound 256 bf16", (1, 4, 2, 40, 70, 256), "bfloat16", "int8", {},
     "bound", "bound"),
    ("quantize_q int8 256 bf16", (1, 4, 2, 40, 70, 256), "bfloat16", "int8",
     dict(quantize_q=True), "bound", "bound"),
    ("quantize_q fp8 256 bf16", (1, 4, 2, 40, 70, 256), "bfloat16", "fp8",
     dict(quantize_q=True, causal=True, kv_offset=30), "bound", "kmajor"),
    ("causal 96 fp32", (1, 4, 2, 40, 70, 96), "float32", None,
     dict(causal=True, kv_offset=30), "online", "online"),
    ("window 100 fp32", (1, 4, 2, 40, 70, 100), "float32", None,
     dict(causal=True, window=24, kv_offset=30), "bound", "kmajor"),
    ("quantize_q int8 100 bf16", (1, 4, 2, 40, 70, 100), "bfloat16", "int8",
     dict(quantize_q=True), "bound", "bound"),
]


def _fwd_args(shape, dtype, qtype, kw, seed):
    """(JAX args, port args, JAX kwargs, port kwargs) of one case."""
    b, h, hkv, nq, nk, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = _u(rng, b, h, nq, d), _u(rng, b, hkv, nk, d), _u(
        rng, b, hkv, nk, d)
    ja = [jnp.asarray(x, JAX_DT[dtype]) for x in (q, k, v)]
    ta = [torch.from_numpy(x).to(TORCH_DT[dtype]) for x in (q, k, v)]
    jkw, tkw = {}, {}
    if qtype is not None:
        jkv = jax_quantize_kv(jnp.asarray(k), jnp.asarray(v), qtype)
        tkv = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qtype)
        ja[1:], ta[1:] = [jkv.k_q, jkv.v_q], [tkv.k_q, tkv.v_q]
        jkw = dict(k_scale=jkv.k_scale, v_scale=jkv.v_scale)
        tkw = dict(k_scale=tkv.k_scale, v_scale=tkv.v_scale)
    for name, x in kw.items():
        if name == "segments":
            seg = _segments(b, nq, x)
            jkw.update(q_segment_ids=jnp.asarray(seg),
                       kv_segment_ids=jnp.asarray(seg))
            tkw.update(q_segment_ids=torch.from_numpy(seg),
                       kv_segment_ids=torch.from_numpy(seg))
        else:
            jkw[name] = tkw[name] = x
    return ja, ta, jkw, tkw


@pytest.fixture(scope="module")
def fwd_jax():
    """The JAX forward of each case (one compile each)."""
    out = {}
    for i, (name, shape, dtype, qtype, kw, softmax, _) in enumerate(
            FWD_CASES):
        ja, _, jkw, _ = _fwd_args(shape, dtype, qtype, kw, i)
        out[name] = jax_fwd(*ja, softmax=softmax, **jkw)
    return out


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_forward_wide_heads_matches_jax(fwd_jax, case):
    name, shape, dtype, qtype, kw, softmax, form = case
    i = FWD_CASES.index(case)
    _, ta, _, tkw = _fwd_args(shape, dtype, qtype, kw, i)
    plan = ff._plan(*ta, None, tkw.get("causal", False),
                    tkw.get("window", 0), tkw.get("kv_offset", 0), None,
                    tkw.get("k_scale"), tkw.get("v_scale"),
                    tkw.get("q_segment_ids"), tkw.get("kv_segment_ids"),
                    softmax, tkw.get("quantize_q", False))
    assert (plan.use_bound, plan.use_kmajor) == (form != "online",
                                                 form == "kmajor")
    o, lse = ff.flash_attention_forward(*ta, softmax=softmax, **tkw)
    o_j, lse_j = fwd_jax[name]
    b, h, _, nq, _, d = shape
    assert tuple(o.shape) == o_j.shape == (b, h, nq, d)
    assert o.dtype == TORCH_DT[dtype]
    assert _diff(o.float(), o_j) <= GATES[dtype]
    assert _diff(lse, lse_j) <= GATES[dtype]


# decode: (d, dtype, qtype)
DECODE_CASES = [(d, dt, qt) for d in (8, 80, 96, 256)
                for dt, qt in (("float32", None), ("bfloat16", None),
                               ("bfloat16", "int8"))]


def _decode_args(d, dtype, qtype, seed):
    rng = np.random.default_rng(seed)
    b, h, hkv, n = 3, 8, 2, 50
    q, k, v = _u(rng, b, h, d), _u(rng, b, hkv, n, d), _u(rng, b, hkv, n, d)
    lengths = np.array([50, 1, 23], np.int32)
    ja = [jnp.asarray(x, JAX_DT[dtype]) for x in (q, k, v)]
    ta = [torch.from_numpy(x).to(TORCH_DT[dtype]) for x in (q, k, v)]
    jkw, tkw = {}, {}
    if qtype is not None:
        jkv = jax_quantize_kv(jnp.asarray(k), jnp.asarray(v), qtype)
        tkv = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qtype)
        ja[1:], ta[1:] = [jkv.k_q, jkv.v_q], [tkv.k_q, tkv.v_q]
        jkw = dict(k_scale=jkv.k_scale, v_scale=jkv.v_scale)
        tkw = dict(k_scale=tkv.k_scale, v_scale=tkv.v_scale)
    return ja, ta, jkw, tkw, lengths


@pytest.fixture(scope="module")
def decode_jax():
    out = {}
    for i, (d, dt, qt) in enumerate(DECODE_CASES):
        ja, _, jkw, _, lengths = _decode_args(d, dt, qt, i)
        out[d, dt, qt] = jax_decode(*ja, jnp.asarray(lengths), window=20,
                                    **jkw)
    return out


@pytest.mark.parametrize("d,dtype,qtype", DECODE_CASES)
def test_decode_wide_and_odd_heads_match_jax(decode_jax, d, dtype, qtype):
    i = DECODE_CASES.index((d, dtype, qtype))
    _, ta, _, tkw, lengths = _decode_args(d, dtype, qtype, i)
    o, lse = decode_attention(*ta, torch.from_numpy(lengths), window=20,
                              **tkw)
    o_j, lse_j = decode_jax[d, dtype, qtype]
    assert tuple(o.shape) == o_j.shape == (3, 8, d)
    assert _diff(o.float(), o_j) <= GATES[dtype]
    assert _diff(lse, lse_j) <= GATES[dtype]


def _paged_args(d, dtype, qtype, seed):
    """Pools of 8-token pages (an int8 pool with its scale pools), page
    tables interleaving the sequences' pages."""
    rng = np.random.default_rng(seed)
    b, h, hkv, page, n_pages = 2, 8, 2, 8, 12
    q = _u(rng, b, h, d)
    kp, vp = _u(rng, n_pages, hkv, page, d), _u(rng, n_pages, hkv, page, d)
    table = np.array([[1, 3, 5, 7, 9], [0, 2, 4, 6, 8]], np.int32)
    lengths = np.array([37, 21], np.int32)
    ja = [jnp.asarray(x, JAX_DT[dtype]) for x in (q, kp, vp)]
    ta = [torch.from_numpy(x).to(TORCH_DT[dtype]) for x in (q, kp, vp)]
    jkw, tkw = {}, {}
    if qtype is not None:
        jkv = jax_quantize_kv(jnp.asarray(kp), jnp.asarray(vp), qtype)
        tkv = quantize_kv(torch.from_numpy(kp), torch.from_numpy(vp), qtype)
        ja[1:], ta[1:] = [jkv.k_q, jkv.v_q], [tkv.k_q, tkv.v_q]
        jkw = dict(k_scale=jkv.k_scale, v_scale=jkv.v_scale)
        tkw = dict(k_scale=tkv.k_scale, v_scale=tkv.v_scale)
    return ja, ta, jkw, tkw, table, lengths


PAGED_CASES = [(d, dt, qt) for d in (8, 80, 96, 256)
               for dt, qt in (("bfloat16", None), ("bfloat16", "int8"))]


@pytest.fixture(scope="module")
def paged_jax():
    out = {}
    for i, (d, dt, qt) in enumerate(PAGED_CASES):
        ja, _, jkw, _, table, lengths = _paged_args(d, dt, qt, i)
        out[d, dt, qt] = jpaged.paged_decode_attention(
            *ja, jnp.asarray(table), jnp.asarray(lengths), **jkw)
    return out


@pytest.mark.parametrize("d,dtype,qtype", PAGED_CASES)
def test_paged_decode_wide_and_odd_heads_match_jax(paged_jax, d, dtype,
                                                   qtype):
    i = PAGED_CASES.index((d, dtype, qtype))
    _, ta, _, tkw, table, lengths = _paged_args(d, dtype, qtype, i)
    o, lse = tpaged.paged_decode_attention(
        *ta, torch.from_numpy(table), torch.from_numpy(lengths), **tkw)
    o_j, lse_j = paged_jax[d, dtype, qtype]
    assert tuple(o.shape) == o_j.shape == (2, 8, d)
    assert _diff(o.float(), o_j) <= GATES[dtype]
    assert _diff(lse, lse_j) <= GATES[dtype]


# ---- a model at d_head 256 ------------------------------------------------

_SIZES = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
              n_kv_heads=1, d_head=256, d_ff=128, max_seq=64)
JCFG = jtf.TransformerConfig(**_SIZES, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(**_SIZES, dtype=torch.float32)
PROMPT, CHUNK, STEPS = 7, 3, 4


@pytest.fixture(scope="module")
def model_pair():
    """JAX's weights at d_head 256, and the port's model holding them."""
    jparams = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            TCFG)
    prompt = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, (2, PROMPT)).astype(np.int32)
    return jparams, model, prompt


def test_params_from_jax_at_d_head_256(model_pair):
    """q/k/v projections of width n_heads · 256 and n_kv_heads · 256, as
    JAX holds them (transposed)."""
    jparams, model, _ = model_pair
    blk, layer = model.layers[0], jparams["layers"][0]
    assert tuple(blk.wq.weight.shape) == (2 * 256, 64)
    assert tuple(blk.wk.weight.shape) == (256, 64)
    assert tuple(blk.wo.weight.shape) == (64, 2 * 256)
    assert np.array_equal(blk.wq.weight.detach().numpy().T,
                          np.asarray(layer["wq"], np.float32))


def test_prefill_logits_at_d_head_256_match_jax(model_pair):
    jparams, model, prompt = model_pair
    jc = jtf.init_caches(JCFG, 2, PROMPT + STEPS)
    lj, _ = jtf.prefill(jparams, jnp.asarray(prompt), JCFG, jc)
    tc = ttf.init_caches(TCFG, 2, PROMPT + STEPS, device="cpu")
    lt, _ = ttf.prefill(model, torch.from_numpy(prompt), tc)
    top = max(1.0, float(np.max(np.abs(np.asarray(lj)))))
    assert _diff(lt, lj) <= LOGIT_GATE * top


@pytest.mark.parametrize("qtype", [None, "int8"])
def test_generate_at_d_head_256_matches_jax(model_pair, qtype):
    """Greedy `generate()` over an fp32 cache and an int8 one: the same
    tokens as JAX's, the last step's logits within the gate."""
    jparams, model, prompt = model_pair
    tok_j, lj = jgen.generate(jparams, jnp.asarray(prompt), JCFG, STEPS,
                              qtype=qtype)
    tok_t, lt = tgen.generate(model, torch.from_numpy(prompt), STEPS,
                              qtype=qtype)
    assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
    top = max(1.0, float(np.max(np.abs(np.asarray(lj)))))
    assert _diff(lt, lj) <= LOGIT_GATE * top


def test_prefill_chunked_at_d_head_256_matches_jax(model_pair):
    """Chunks of 3 over a 7-token prompt (the later chunks read their
    prefix from the cache at d = 256), then decode steps: logits within
    the gate, greedy tokens equal."""
    jparams, model, prompt = model_pair
    jc = jtf.init_caches(JCFG, 2, PROMPT + STEPS)
    tc = ttf.init_caches(TCFG, 2, PROMPT + STEPS, device="cpu")
    lj, jc = jtf.prefill_chunked(jparams, jnp.asarray(prompt), JCFG, jc,
                                 chunk=CHUNK)
    lt, tc = ttf.prefill_chunked(model, torch.from_numpy(prompt), tc,
                                 chunk=CHUNK)
    pairs = [(lj, lt)]
    tok_j, tok_t = jnp.argmax(lj, -1), torch.argmax(lt, -1)
    for i in range(STEPS):
        assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
        lj, jc = jtf.decode_one(jparams, tok_j.astype(jnp.int32),
                                PROMPT + i, JCFG, jc)
        lt, tc = ttf.decode_one(model, tok_t.to(torch.int32), PROMPT + i,
                                tc)
        tok_j, tok_t = jnp.argmax(lj, -1), torch.argmax(lt, -1)
        pairs.append((lj, lt))
    for a, b in pairs:
        top = max(1.0, float(np.max(np.abs(np.asarray(a)))))
        assert _diff(b, a) <= LOGIT_GATE * top
