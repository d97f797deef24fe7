"""The backward at head width 256, in the torch port against the JAX
package on the CPU: the same numpy inputs (seeded) go through the JAX
function (its Pallas kernels in interpret mode, `fused` pinned to True and
to False) and through the port's, which on CPU tensors runs the plain
version of the d = 256 builds of K4, K2 + K3 and the prologue.

- `flash_attention_backward` at d = 256, fused and split: causal with
  `kv_offset`, a sliding window, segment ids (causal and not), GQA 4:2
  and MQA, a ragged Nq != Nk with empty rows and unseen keys. Gates per
  gradient, as tests/test_torch_flash_bwd.py's: max |diff| <= 1e-4 · max
  |JAX| on fp32 inputs, 2e-2 · max |JAX| on bf16 ones.
- d = 200 on heads zero-padded to 256 at d's scale (what the card runs):
  the identity on the function (the unpadded plain backward within 1e-6,
  zero columns past d), and the JAX backward at d = 200 within the fp32
  gate.
- A model at d_head 256 (vocab 64, d_model 64, 2 layers, 2 heads over 1
  KV head, d_ff 128, fp32, T = 24) on JAX's weights (`params_from_jax`):
  the loss within 1e-5, every gradient and the parameters after one
  SGD(1e-2) `make_train_step` within 1e-4 · max |JAX|, with and without a
  sliding window.

One JAX call per case, kept in module-scoped fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_tpu.ops.flash_bwd import (
    flash_attention_backward as jax_bwd,
)
from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_fwd,
)
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from cuda_flashattention_torch.ops.common import (
    BWD_HEAD_DIMS,
    pad_heads,
    resolve_scale,
)
from cuda_flashattention_torch.ops.flash_bwd import flash_attention_backward
from cuda_flashattention_torch.utils.testing import (
    assert_close,
    max_abs,
    seeded_random,
)

GATES = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _segments(b, n, lengths):
    ids = np.repeat(np.arange(len(lengths)), lengths)[:n]
    return np.broadcast_to(ids, (b, n)).astype(np.int32).copy()


# name: ((b, h, h_kv, nq, nk), dtype, kw, segment lengths or None)
CASES = {
    "causal offset fp32": ((1, 4, 2, 37, 53), "float32",
                           dict(causal=True, kv_offset=16), None),
    "causal offset bf16": ((1, 4, 2, 37, 53), "bfloat16",
                           dict(causal=True, kv_offset=16), None),
    "window fp32": ((1, 4, 2, 40, 64), "float32",
                    dict(causal=True, window=8, kv_offset=24), None),
    "window bf16": ((2, 4, 2, 40, 64), "bfloat16",
                    dict(causal=True, window=12, kv_offset=24), None),
    "segments causal bf16": ((2, 4, 2, 48, 48), "bfloat16",
                             dict(causal=True), [12, 3, 24, 9]),
    "segments fp32": ((1, 4, 1, 40, 40), "float32", dict(causal=False),
                      [10, 1, 29]),
    "ragged empty rows fp32": ((1, 2, 2, 24, 40), "float32",
                               dict(causal=True, kv_offset=-8), None),
    "MQA non-causal bf16": ((2, 4, 1, 24, 56), "bfloat16",
                            dict(causal=False), None),
}
D = 256


def _args(name):
    (b, h, h_kv, nq, nk), _, kw, lengths = CASES[name]
    seed = 1000 + sum(map(ord, name))
    q = seeded_random((b, h, nq, D), seed)
    k = seeded_random((b, h_kv, nk, D), seed + 1)
    v = seeded_random((b, h_kv, nk, D), seed + 2)
    do = seeded_random((b, h, nq, D), seed + 3)
    seg = None
    if lengths is not None:
        seg = (_segments(b, nq, lengths), _segments(b, nk, lengths))
    return (q, k, v, do), kw, seg


@pytest.fixture(scope="module")
def bwd_jax():
    """{(case, fused): (O, LSE, dQ, dK, dV)} from the JAX package."""
    out = {}

    def get(name, fused):
        if (name, fused) not in out:
            (q, k, v, do), kw, seg = _args(name)
            dt = JAX_DT[CASES[name][1]]
            jq, jk, jv, jdo = (jnp.asarray(a, dt) for a in (q, k, v, do))
            skw = {} if seg is None else dict(
                q_segment_ids=jnp.asarray(seg[0]),
                kv_segment_ids=jnp.asarray(seg[1]))
            o, lse = jax_fwd(jq, jk, jv, **kw, **skw)
            grads = jax_bwd(jq, jk, jv, o, lse, jdo, fused=fused, **kw,
                            **skw)
            out[name, fused] = tuple(np.asarray(x, np.float32)
                                     for x in (o, lse, *grads))
        return out[name, fused]
    return get


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_backward_at_d256_matches_jax(bwd_jax, name, fused):
    (q, k, v, do), kw, seg = _args(name)
    dtype = CASES[name][1]
    o, lse, *want = bwd_jax(name, fused)
    tq, tk, tv, tdo, to = (torch.from_numpy(np.array(a, np.float32)).to(
        TORCH_DT[dtype]) for a in (q, k, v, do, o))
    skw = {} if seg is None else dict(
        q_segment_ids=torch.from_numpy(seg[0]),
        kv_segment_ids=torch.from_numpy(seg[1]))
    got = flash_attention_backward(tq, tk, tv, to, torch.from_numpy(lse),
                                   tdo, fused=fused, **kw, **skw)
    for g, w, gname, shape in zip(got, want, ("dQ", "dK", "dV"),
                                  (q.shape, k.shape, k.shape)):
        assert g.dtype == TORCH_DT[dtype] and tuple(g.shape) == shape
        scale = max_abs(w)
        assert scale > 0, f"{gname}: the JAX gradient is all zero"
        assert_close(g, w, GATES[dtype] * scale, f"{name} {gname}")


@pytest.mark.parametrize("scale", [None, 0.05])
def test_d200_on_heads_padded_to_256_matches_jax(scale):
    """What the card runs at d = 200: the plain backward on q, k, v, O and
    dO zero-padded to 256 at d's scale, the gradients sliced back. It is
    the identity on the function (the unpadded plain backward within
    1e-6, zero columns past d) and meets the JAX backward at d = 200
    (fp32 gate, fused)."""
    d, (b, h, h_kv, nq, nk) = 200, (1, 4, 2, 37, 53)
    q, k, v, do = (seeded_random(s, 77 + i) for i, s in enumerate(
        [(b, h, nq, d), (b, h_kv, nk, d), (b, h_kv, nk, d), (b, h, nq, d)]))
    kw = dict(causal=True, kv_offset=16, scale=scale)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = jax_fwd(jq, jk, jv, **kw)
    want = jax_bwd(jq, jk, jv, o, lse, jdo, fused=True, **kw)
    tq, tk, tv, tdo, to = (torch.from_numpy(np.array(a, np.float32))
                           for a in (q, k, v, do, o))
    tlse = torch.from_numpy(np.array(lse, np.float32))
    unpadded = flash_attention_backward(tq, tk, tv, to, tlse, tdo, **kw)
    d_run, (pq, pk, pv, po, pdo) = pad_heads("backward", tq, tk, tv, to,
                                             tdo, dims=BWD_HEAD_DIMS)
    assert d_run == 256
    got = flash_attention_backward(pq, pk, pv, po, tlse, pdo, causal=True,
                                   kv_offset=16,
                                   scale=resolve_scale(scale, d))
    for g, u, w, name in zip(got, unpadded, want, ("dQ", "dK", "dV")):
        assert torch.all(g[..., d:] == 0), name
        assert torch.max(torch.abs(g[..., :d] - u)) <= 1e-6, name
        w = np.asarray(w)
        assert_close(g[..., :d], w, GATES["float32"] * max_abs(w), name)


# ---- a model at d_head 256, trained ---------------------------------------

_SIZES = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
              n_kv_heads=1, d_head=256, d_ff=128, max_seq=64)
JCFG = jtf.TransformerConfig(**_SIZES, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(**_SIZES, dtype=torch.float32)
GATE = 1e-4
LOSS_GATE = 1e-5


@pytest.fixture(scope="module")
def setup():
    jparams = jtf.init_params(jax.random.PRNGKey(3), JCFG)
    tokens = np.random.default_rng(4).integers(
        0, JCFG.vocab_size, (2, 24)).astype(np.int32)
    return jparams, tokens


def _assert_trees_close(got, want, what):
    leaves_g = jax.tree_util.tree_leaves_with_path(got)
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in leaves_g] == [p for p, _ in leaves_w]
    for (path, g), (_, w) in zip(leaves_g, leaves_w):
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert_close(g, w, GATE * max_abs(w), name)


@pytest.mark.parametrize("window", [0, 9])
def test_training_at_d_head_256_matches_jax(setup, window):
    """`loss_fn` and every gradient against `jax.value_and_grad(loss_fn)`,
    and the parameters after one SGD(1e-2) `make_train_step` against the
    JAX step's, at d_head 256 (window 0: full causal; 9: the
    sliding-window model)."""
    jparams, tokens = setup
    jcfg = dataclasses.replace(JCFG, window=window)
    tcfg = dataclasses.replace(TCFG, window=window)

    def model():
        return params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), tcfg)

    tok = torch.from_numpy(tokens)
    loss_j, grads_j = jax.value_and_grad(jtf.loss_fn)(
        jparams, jnp.asarray(tokens), jcfg)
    m = model()
    loss_t = ttf.loss_fn(m, tok)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_GATE
    _assert_trees_close(params_to_jax(m, grads=True),
                        jax.tree_util.tree_map(np.asarray, grads_j), "grad")

    opt = optax.sgd(1e-2)
    new_j, _, step_loss = jtf.make_train_step(jcfg, opt, donate=False)(
        jparams, opt.init(jparams), jnp.asarray(tokens))
    m = model()
    loss_s = ttf.make_train_step(
        m, torch.optim.SGD(m.parameters(), lr=1e-2))(tok)
    assert abs(loss_s.item() - float(step_loss)) <= LOSS_GATE
    _assert_trees_close(params_to_jax(m),
                        jax.tree_util.tree_map(np.asarray, new_j), "param")
