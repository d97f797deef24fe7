"""The port's ladder (`cuda_flashattention_torch/examples`), on CPU ranks.

Stages 00-06 run in-process with `--cpu` (the ring stages on 8 ranks at
SEQ = 2544, the JAX ladder's CI size: 318 rows per rank, not a tile
multiple) and must print their pass line; `python -m
cuda_flashattention_torch.examples --cpu` runs once as a subprocess.
Stage 03's O and stage 04's O and gradients are held against the JAX
functions the JAX stages call (`flash_attention_forward`;
`ring_attention` and `jax.grad` over the virtual 8-device mesh of
tests/conftest.py) on the same numpy inputs: fp32, O within 1e-4,
gradients within 1e-4 · max |JAX|. Stage 05's rollouts run on the JAX
stage's weights (`init_params(PRNGKey(0))`, carried across by
`params_from_jax`) and prompt, against the JAX functions: the
teacher-forced tokens and their logits, `generate` over the fp32 cache
(tokens identical, logits within 1e-4 · max(1, max |JAX|)) and over the
int8 cache (logits within 1e-3). Stage 06's paged O of each step against
the JAX `paged_decode_step` on the same lifecycle, within 1e-5."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.models import generate as jgen
from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_tpu.ops import paged as jpaged
from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_forward,
)
from cuda_flashattention_tpu.parallel import ring as jring
from cuda_flashattention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cuda_flashattention_torch.examples import (
    _ladder,
    attention_1chip,
    generate as stage05,
    paged_serving as stage06,
    ring_attention,
)
from cuda_flashattention_torch.models.convert import params_from_jax
from cuda_flashattention_torch.utils.testing import assert_close, max_abs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, RANKS, GATE = 2544, 8, 1e-4


@pytest.fixture
def ci_seq(monkeypatch):
    monkeypatch.setenv("CFA_LADDER_SEQ", str(SEQ))
    monkeypatch.setattr(_ladder, "LADDER_SEQ", SEQ)


@pytest.mark.parametrize("stage,line", [
    ("psum_vecadd", "[00_psum_vecadd] Test PASSED!"),
    ("ppermute_verify", "[01_ppermute_verify] Test PASSED!"),
    ("overlap", "[02_overlap] Test PASSED!"),
    ("attention_1chip", "[03_attention_1chip] Test PASSED!"),
    ("ring_attention", "[04_ring_attention] Test PASSED!"),
    ("generate", "[05_generate] Test PASSED!"),
    ("paged_serving", "[06_paged_serving] Test PASSED!"),
])
def test_ladder_stage_passes_on_cpu_ranks(stage, line, ci_seq, capsys):
    import importlib
    module = importlib.import_module(
        f"cuda_flashattention_torch.examples.{stage}")
    assert module.main(["--cpu", "--ranks", str(RANKS)]) == 0
    assert line in capsys.readouterr().out


def test_ladder_runner_subprocess():
    env = dict(os.environ, CFA_LADDER_SEQ=str(SEQ))
    r = subprocess.run(
        [sys.executable, "-m", "cuda_flashattention_torch.examples", "--cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert r.stdout.count("Test PASSED!") == 8, r.stdout
    assert "ladder: 8 of 8 stages passed" in r.stdout


def test_ladder_runner_reports_a_failed_stage(monkeypatch, capsys):
    from cuda_flashattention_torch.examples import __main__ as runner
    from cuda_flashattention_torch.examples import psum_vecadd
    monkeypatch.setattr(psum_vecadd, "main", lambda argv: 1)
    assert runner.main(["--cpu", "00", "01"]) == 1
    out = capsys.readouterr().out
    assert "failed: 00 psum_vecadd" in out and "1 of 2 stages" in out


def test_ladder_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        _ladder.devices(None, cpu=False)
    assert _ladder.devices(None, cpu=True) == [torch.device("cpu")] * 8


def test_stage03_matches_the_jax_function():
    q, k, v = attention_1chip.inputs(SEQ, "cpu")
    o, lse = attention_1chip.flash_attention_forward(q, k, v, scale=1.0)
    o_j, lse_j = jax_forward(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                             scale=1.0)
    assert_close(o, np.asarray(o_j), GATE, "stage 03 O")
    assert_close(lse, np.asarray(lse_j), GATE, "stage 03 LSE")


def test_stage04_matches_the_jax_ring():
    o, oc, grads, (q, k, v, do) = ring_attention.run(SEQ, ["cpu"] * RANKS)
    mesh = jax_make_mesh((RANKS,), ("sp",), jax.devices()[:RANKS])
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    kw = dict(mesh=mesh, axis_name="sp", scale=1.0)
    assert_close(o, np.asarray(jring.ring_attention(jq, jk, jv, **kw)), GATE,
                 "ring O (full)")
    assert_close(oc, np.asarray(jring.ring_attention(jq, jk, jv, causal=True,
                                                     **kw)),
                 GATE, "ring O (causal)")

    def loss(q, k, v):
        return jnp.sum(jring.ring_attention(q, k, v, causal=True, **kw)
                       * jdo)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for name, g, w in zip(("dQ", "dK", "dV"), grads, want):
        w = np.asarray(w)
        assert_close(g, w, GATE * max_abs(w), f"ring {name}")


def test_stage05_matches_the_jax_stage():
    """Stage 05's rollouts on the JAX stage's weights and prompt. The JAX
    teacher-forced logits come from one causal `forward` over the final
    sequence: position t's logits see tokens <= t only, so they are the
    step's."""
    c = stage05.CFG
    jcfg = jtf.TransformerConfig(
        vocab_size=c.vocab_size, d_model=c.d_model, n_layers=c.n_layers,
        n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, d_head=c.d_head,
        d_ff=c.d_ff, max_seq=c.max_seq, dtype=jnp.float32)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jprompt = jax.random.randint(jax.random.PRNGKey(1),
                                 (stage05.BATCH, stage05.PROMPT), 0,
                                 c.vocab_size)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), c)
    r = stage05.rollouts(model, torch.tensor(np.asarray(jprompt)))
    ref = r["ref"].numpy()
    n = stage05.PROMPT
    # the teacher-forced logits that chose each new token, and the tokens
    lj = np.asarray(jtf.forward(jparams, jnp.asarray(ref), jcfg))
    lj = lj[:, n - 1:-1].transpose(1, 0, 2)  # [N, B, V]
    assert_close(r["ref_logits"], lj, GATE * max(1.0, max_abs(lj)),
                 "teacher-forced logits")
    np.testing.assert_array_equal(lj.argmax(-1).T, ref[:, n:])
    # generate over the fp32 cache, then the int8 cache
    for key, kw, gate in (("", {}, GATE), ("8", dict(qtype="int8"), 1e-3)):
        out_j, last_j = jgen.generate(jparams, jprompt, jcfg,
                                      max_new_tokens=stage05.NEW, **kw)
        last_j = np.asarray(last_j)
        np.testing.assert_array_equal(r["out" + key].numpy(),
                                      np.asarray(out_j))
        assert_close(r["logits" + key], last_j,
                     gate * max(1.0, max_abs(last_j)), f"generate{key}")
    np.testing.assert_array_equal(r["out"].numpy(), ref)


def test_stage06_matches_the_jax_paged_step():
    """Stage 06's paged O of each decode step against the JAX
    `paged_decode_step` on the same lifecycle and inputs (1e-5)."""
    outs, refs, freed, kept = stage06.run("cpu")
    assert (freed, kept) == (3, 2)
    k_prompt, v_prompt, steps = stage06.draws()
    cache = jpaged.init_paged_cache(
        n_pages=stage06.N_PAGES, batch=stage06.B,
        max_pages=stage06.MAX_PAGES, heads_kv=stage06.HKV,
        page_size=stage06.PAGE, d=stage06.D, dtype=jnp.float32)
    alloc = jpaged.PageAllocator(stage06.N_PAGES)
    for i in range(stage06.B):
        cache = alloc.reserve_for(cache, i, stage06.PROMPT)
    cache = jpaged.paged_bulk_append(cache, jnp.asarray(k_prompt),
                                     jnp.asarray(v_prompt))
    for t, (k_new, v_new, q) in enumerate(steps):
        for i in range(stage06.B):
            cache = alloc.reserve_for(cache, i, 1)
        cache = jpaged.paged_append(cache, jnp.asarray(k_new),
                                    jnp.asarray(v_new))
        o_j, _ = jpaged.paged_decode_step(jnp.asarray(q), cache)
        assert_close(outs[t], np.asarray(o_j), 1e-5, f"step {t} paged O")
        assert_close(refs[t], np.asarray(o_j), 1e-5, f"step {t} shadow O")
