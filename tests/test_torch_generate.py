"""The torch port's serving path against the JAX package's, end to end.

The JAX package's `init_params` for the fp32 test model of
tests/test_generate.py is carried across with `params_from_jax`; prompts
come from a numpy seed. Prefill logits and cache contents, chunked
prefill, one decode step and the last logits of `generate` agree within
1e-4; greedy `generate` tokens are identical. Over an int8 or a mixed
cache (the latter with `quantize_q`) the last logits agree within 1e-3.
Chunked prefill is also held against the JAX `prefill_chunked` over bf16,
int8, fp8 and mixed caches with and without `cfg.window` (a window shorter
than a chunk, whose last rows miss the prefix altogether, among them), and
greedy `generate` with a window gives identical tokens."""

import copy
import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.models import generate as jgen
from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_torch.models import generate as tgen
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import params_from_jax

JCFG = jtf.TransformerConfig(
    vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, max_seq=64, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(
    vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, max_seq=64, dtype=torch.float32)
GATE = 1e-4
QUANT_GATE = 1e-3  # last logits of generate() over a quantized cache


@pytest.fixture(scope="module")
def setup():
    jparams = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            TCFG)
    prompt = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, (2, 7)).astype(np.int32)
    return jparams, model, prompt


def _diff(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.numpy())))


def test_prefill_logits_and_caches_match(setup):
    jparams, model, prompt = setup
    lj, cj = jtf.prefill(jparams, jnp.asarray(prompt), JCFG,
                         jtf.init_caches(JCFG, 2, 16))
    lt, ct = ttf.prefill(model, torch.from_numpy(prompt),
                         ttf.init_caches(TCFG, 2, 16, device="cpu"))
    assert _diff(lj, lt) <= GATE
    for a, b in zip(cj, ct):
        assert int(a.length) == b.length == 7
        assert _diff(a.k, b.k) <= GATE and _diff(a.v, b.v) <= GATE


def test_chunked_prefill_matches(setup):
    jparams, model, prompt = setup
    lj, _ = jtf.prefill_chunked(jparams, jnp.asarray(prompt), JCFG,
                                jtf.init_caches(JCFG, 2, 16), chunk=3)
    lt, ct = ttf.prefill_chunked(model, torch.from_numpy(prompt),
                                 ttf.init_caches(TCFG, 2, 16, device="cpu"), chunk=3)
    assert _diff(lj, lt) <= GATE
    whole, _ = ttf.prefill(model, torch.from_numpy(prompt),
                           ttf.init_caches(TCFG, 2, 16, device="cpu"))
    assert torch.max(torch.abs(whole - lt)) <= GATE
    assert all(c.length == 7 for c in ct)


@pytest.mark.parametrize("window", [0, 2, 5])
@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
def test_chunked_prefill_matches_jax(setup, qtype, window):
    """A 7-token prompt in chunks of 3: the second and third chunks read
    the cached prefix through the forward's quantized and windowed forms
    (window 2 < chunk: a chunk's last row sees no prefix key and drops
    out of the combine; window 5 cuts the prefix slice at start − 5). The
    caches end up holding the same codes and scales."""
    jparams, model, prompt = setup
    jcfg = dataclasses.replace(JCFG, window=window)
    wmodel = copy.copy(model)  # the same parameters, another config
    wmodel.cfg = dataclasses.replace(TCFG, window=window)
    lj, cj = jtf.prefill_chunked(
        jparams, jnp.asarray(prompt), jcfg,
        jtf.init_caches(jcfg, 2, 16, qtype=qtype), chunk=3)
    lt, ct = ttf.prefill_chunked(
        wmodel, torch.from_numpy(prompt),
        ttf.init_caches(wmodel.cfg, 2, 16, qtype=qtype, device="cpu"),
        chunk=3)
    assert torch.isfinite(lt).all()
    assert _diff(lj, lt) <= (GATE if qtype is None else QUANT_GATE)
    for a, b in zip(cj, ct):
        assert int(a.length) == b.length == 7
        if qtype is None:
            assert _diff(a.k, b.k) <= GATE
        else:
            assert _diff(a.k_scale, b.k_scale) <= 1e-6
            assert _diff(a.v_scale, b.v_scale) <= 1e-6
    # against the port's own whole-prompt prefill over the same storage
    whole, _ = ttf.prefill(
        wmodel, torch.from_numpy(prompt),
        ttf.init_caches(wmodel.cfg, 2, 16, qtype=qtype, device="cpu"))
    if qtype is None:
        assert torch.max(torch.abs(whole - lt)) <= GATE
    else:
        # the prefix is read back quantized (0.4% per element at int8, 6%
        # at e4m3), the whole prompt attends its unquantized K/V
        d = torch.max(torch.abs(whole - lt)).item()
        assert 0 < d <= (0.05 if qtype == "int8" else 0.5)


@pytest.mark.parametrize("window", [3, 8])
def test_windowed_prefill_decode_and_generate_match(setup, window):
    """cfg.window in prefill, decode_one and generate: same logits, and
    identical greedy tokens; the window changes the logits."""
    jparams, model, prompt = setup
    jcfg = dataclasses.replace(JCFG, window=window)
    wmodel = copy.copy(model)  # the same parameters, another config
    wmodel.cfg = dataclasses.replace(TCFG, window=window)
    lj, _ = jtf.prefill(jparams, jnp.asarray(prompt), jcfg,
                        jtf.init_caches(jcfg, 2, 16))
    lt, _ = ttf.prefill(wmodel, torch.from_numpy(prompt),
                        ttf.init_caches(wmodel.cfg, 2, 16, device="cpu"))
    assert _diff(lj, lt) <= GATE
    if window < prompt.shape[1]:
        full, _ = ttf.prefill(model, torch.from_numpy(prompt),
                              ttf.init_caches(TCFG, 2, 16, device="cpu"))
        assert torch.max(torch.abs(full - lt)) > 1e-3
    out_j, lj = jgen.generate(jparams, jnp.asarray(prompt), jcfg,
                              max_new_tokens=6)
    out_t, lt = tgen.generate(wmodel, torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(np.asarray(out_j), out_t.numpy())
    assert _diff(lj, lt) <= GATE


def test_decode_one_matches(setup):
    jparams, model, prompt = setup
    _, cj = jtf.prefill(jparams, jnp.asarray(prompt), JCFG,
                        jtf.init_caches(JCFG, 2, 16))
    _, ct = ttf.prefill(model, torch.from_numpy(prompt),
                        ttf.init_caches(TCFG, 2, 16, device="cpu"))
    token = np.array([3, 50], np.int32)
    lj, cj = jtf.decode_one(jparams, jnp.asarray(token), 7, JCFG, cj)
    lt, ct = ttf.decode_one(model, torch.from_numpy(token), 7, ct)
    assert _diff(lj, lt) <= GATE
    assert ct[0].length == int(cj[0].length) == 8
    assert _diff(cj[1].k, ct[1].k) <= GATE


def test_greedy_generate_tokens_identical(setup):
    jparams, model, prompt = setup
    out_j, lj = jgen.generate(jparams, jnp.asarray(prompt), JCFG,
                              max_new_tokens=6)
    out_t, lt = tgen.generate(model, torch.from_numpy(prompt), 6)
    assert tuple(out_t.shape) == (2, 13)
    np.testing.assert_array_equal(np.asarray(out_j), out_t.numpy())
    assert _diff(lj, lt) <= GATE


@pytest.mark.parametrize("qtype,quantize_q", [("int8", False),
                                              ("mixed", True)])
def test_quantized_generate_matches_jax(setup, qtype, quantize_q):
    """`generate` over a quantized cache: both sides quantize the same K/V
    onto the same grid at append, so the last logits agree within
    QUANT_GATE (the fp8 V of a mixed cache is read natively here and
    through a bit cast that flushes e4m3 subnormals there), and the greedy
    tokens are identical unless a JAX top-2 logit margin is inside that
    gate, which this seed's are not."""
    jparams, model, prompt = setup
    out_j, lj = jgen.generate(jparams, jnp.asarray(prompt), JCFG,
                              max_new_tokens=6, qtype=qtype,
                              quantize_q=quantize_q)
    out_t, lt = tgen.generate(model, torch.from_numpy(prompt), 6,
                              qtype=qtype, quantize_q=quantize_q)
    assert _diff(lj, lt) <= QUANT_GATE
    top2 = np.sort(np.asarray(lj), axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > QUANT_GATE)
    np.testing.assert_array_equal(np.asarray(out_j), out_t.numpy())
    # the quantized cache changes the logits: it is really in the path
    _, l_full = tgen.generate(model, torch.from_numpy(prompt), 6)
    assert torch.max(torch.abs(l_full - lt)) > 0


def test_sampled_generate_reproducible(setup):
    _, model, prompt = setup
    p = torch.from_numpy(prompt)
    runs = [tgen.generate(model, p, 5, temperature=0.8,
                          generator=torch.Generator().manual_seed(42))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < TCFG.vocab_size)).all()


def test_generate_max_len_too_small_raises(setup):
    _, model, prompt = setup
    with pytest.raises(ValueError, match="max_len"):
        tgen.generate(model, torch.from_numpy(prompt), 6, max_len=10)


def test_seeded_init_is_reproducible():
    a = ttf.Transformer(TCFG, generator=torch.Generator().manual_seed(5))
    b = ttf.Transformer(TCFG, generator=torch.Generator().manual_seed(5))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    # normal / sqrt(fan_in): the q projection's weights have std 1/8 here
    assert abs(a.layers[0].wq.weight.std().item() - 64 ** -0.5) < 0.02
