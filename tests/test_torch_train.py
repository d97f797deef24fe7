"""The torch port's training path against the JAX package's, end to end.

The JAX package's `init_params` for the fp32 test model of
tests/test_torch_generate.py is carried across with `params_from_jax`;
tokens come from a numpy seed. `forward` logits, `loss_fn` and every
parameter's gradient are held against `jax.value_and_grad(loss_fn)`, and
the parameters after one SGD(1e-2) step against the JAX
`make_train_step(cfg, optax.sgd(1e-2))`. Gates: 1e-5 on the loss,
1e-4 · max |JAX| on logits, each gradient and each updated parameter."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from cuda_flashattention_torch.utils.testing import assert_close, max_abs

JCFG = jtf.TransformerConfig(
    vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, max_seq=64, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(
    vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, max_seq=64, dtype=torch.float32)
GATE = 1e-4
LOSS_GATE = 1e-5


@pytest.fixture(scope="module")
def setup():
    jparams = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    tokens = np.random.default_rng(2).integers(
        0, JCFG.vocab_size, (2, 24)).astype(np.int32)
    return jparams, tokens


def _model(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), TCFG)


def _assert_trees_close(got, want, what):
    leaves_g = jax.tree_util.tree_leaves_with_path(got)
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in leaves_g] == [p for p, _ in leaves_w]
    for (path, g), (_, w) in zip(leaves_g, leaves_w):
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert_close(g, w, GATE * max_abs(w), name)


def test_forward_logits_match(setup):
    jparams, tokens = setup
    want = jtf.forward(jparams, jnp.asarray(tokens), JCFG)
    got = ttf.forward(_model(jparams), torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 24, 97)
    assert_close(got, want, GATE * max_abs(want), "logits")


def test_loss_and_every_gradient_match(setup):
    jparams, tokens = setup
    loss_j, grads_j = jax.value_and_grad(jtf.loss_fn)(
        jparams, jnp.asarray(tokens), JCFG)
    model = _model(jparams)
    loss_t = ttf.loss_fn(model, torch.from_numpy(tokens))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_GATE
    _assert_trees_close(params_to_jax(model, grads=True),
                        jax.tree_util.tree_map(np.asarray, grads_j), "grad")


def test_sgd_step_matches(setup):
    jparams, tokens = setup
    opt = optax.sgd(1e-2)
    step_j = jtf.make_train_step(JCFG, opt, donate=False)
    new_j, _, loss_j = step_j(jparams, opt.init(jparams),
                              jnp.asarray(tokens))
    model = _model(jparams)
    step_t = ttf.make_train_step(
        model, torch.optim.SGD(model.parameters(), lr=1e-2))
    loss_t = step_t(torch.from_numpy(tokens))
    assert not loss_t.requires_grad
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_GATE
    _assert_trees_close(params_to_jax(model),
                        jax.tree_util.tree_map(np.asarray, new_j), "param")


def test_adam_steps_reduce_loss(setup):
    """As tests/test_model.py does for the JAX step: 10 Adam(3e-3) steps
    on one batch lower the loss."""
    jparams, tokens = setup
    model = _model(jparams)
    step = ttf.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=3e-3))
    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        l0 = ttf.loss_fn(model, tok).item()
    losses = [step(tok).item() for _ in range(10)]
    assert np.isfinite(losses).all()
    assert losses[0] == pytest.approx(l0, abs=1e-6)
    assert losses[-1] < l0, f"loss did not decrease: {l0} -> {losses}"


def test_params_round_trip(setup):
    jparams, _ = setup
    back = params_to_jax(_model(jparams))
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_serving_stays_gradient_free(setup):
    """Parameters are trainable, and prefill builds no autograd graph."""
    jparams, tokens = setup
    model = _model(jparams)
    assert all(p.requires_grad for p in model.parameters())
    logits, _ = ttf.prefill(model, torch.from_numpy(tokens[:, :8]),
                            ttf.init_caches(TCFG, 2, 16, device="cpu"))
    assert not logits.requires_grad
