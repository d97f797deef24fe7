"""The port's ladder (`cuda_flashattention_torch/examples`), on CPU ranks.

Stages 00-04 run in-process with `--cpu` on 8 ranks at SEQ = 2544 (the
JAX ladder's CI size: 318 rows per rank, not a tile multiple) and must
print their pass line; `python -m cuda_flashattention_torch.examples
--cpu` runs once as a subprocess. Stage 03's O and stage 04's O and
gradients are held against the JAX functions the JAX stages call
(`flash_attention_forward`; `ring_attention` and `jax.grad` over the
virtual 8-device mesh of tests/conftest.py) on the same numpy inputs:
fp32, O within 1e-4, gradients within 1e-4 · max |JAX|."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_forward,
)
from cuda_flashattention_tpu.parallel import ring as jring
from cuda_flashattention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cuda_flashattention_torch.examples import (
    _ladder,
    attention_1chip,
    ring_attention,
)
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
    assert r.stdout.count("Test PASSED!") == 6, r.stdout
    assert "ladder: 6 of 6 stages passed" in r.stdout


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
