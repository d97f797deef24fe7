"""Parity of the torch port's GPipe pipeline with the JAX package's
(`parallel/pipeline.py`, `models/transformer.py::pipeline_forward`): the
same numpy weights and inputs through `gpipe_spmd` on the virtual CPU mesh
and through the port on a mesh of repeated "cpu" devices. Gates: 1e-5 on
the toy stack's outputs and gradients (fp32 tanh layers), 1e-4 on the fp32
transformer's logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_tpu.parallel import pipeline as jpipe
from cuda_flashattention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import params_from_jax
from cuda_flashattention_torch.parallel import pipeline as tpipe
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.utils.testing import (
    assert_close,
    max_abs,
    seeded_random,
)

N_LAYERS, D = 8, 16


def jax_stage_fn(stage_w, x):
    for i in range(stage_w.shape[0]):
        x = jnp.tanh(x @ stage_w[i])
    return x


def torch_stage_fn(stage_w, x):
    for i in range(stage_w.shape[0]):
        x = torch.tanh(x @ stage_w[i])
    return x


@pytest.fixture(scope="module")
def setup():
    ws = [seeded_random((D, D), seed=160 + i) * 0.5 for i in range(N_LAYERS)]
    return ws, seeded_random((8, D), seed=170)


def _stacked(ws, grad=False):
    return (jpipe.stack_stage_params([jnp.asarray(w) for w in ws]),
            tpipe.stack_stage_params(
                [torch.from_numpy(w).requires_grad_(grad) for w in ws]))


@pytest.mark.parametrize("n_micro", [2, 4, 8])
def test_pipeline_matches_jax(setup, n_micro):
    ws, x = setup
    jw, tw = _stacked(ws)
    jmesh = jax_make_mesh((4,), ("pp",), jax.devices()[:4])
    tmesh = make_mesh((4,), ("pp",), ["cpu"] * 4)
    y_j = jpipe.gpipe_spmd(
        jax_stage_fn, jax.device_put(jw, jpipe.stage_param_sharding(
            jw, jmesh)), jnp.asarray(x), jmesh, n_micro=n_micro)
    y_t = tpipe.gpipe_spmd(torch_stage_fn, tw, torch.from_numpy(x), tmesh,
                           n_micro=n_micro)
    assert_close(y_t, y_j, 1e-5, f"gpipe m={n_micro}")
    assert_close(y_t, torch_stage_fn(tw, torch.from_numpy(x)), 1e-5,
                 "gpipe vs sequential")


def test_stage_param_sharding_matches_jax(setup):
    """Stage s holds layers [s·L/S, (s+1)·L/S), as `NamedSharding` on the
    pp axis cuts them; the pre-cut stages run the same pipeline."""
    ws, x = setup
    jw, tw = _stacked(ws)
    jmesh = jax_make_mesh((4,), ("pp",), jax.devices()[:4])
    tmesh = make_mesh((4,), ("pp",), ["cpu"] * 4)
    placed = jax.device_put(jw, jpipe.stage_param_sharding(jw, jmesh))
    want = sorted(((s.index[0].start, np.asarray(s.data))
                   for s in placed.addressable_shards), key=lambda t: t[0])
    stages = tpipe.stage_param_sharding(tw, tmesh)
    assert len(stages) == 4
    for stage, (_, data) in zip(stages, want):
        np.testing.assert_array_equal(stage.numpy(), data)
    y = tpipe.gpipe_spmd(torch_stage_fn, stages, torch.from_numpy(x), tmesh,
                         n_micro=4)
    assert_close(y, torch_stage_fn(tw, torch.from_numpy(x)), 1e-5,
                 "gpipe over pre-cut stages")


def test_pipeline_grads_match_jax(setup):
    ws, x = setup
    jw, _ = _stacked(ws)
    jmesh = jax_make_mesh((4,), ("pp",), jax.devices()[:4])
    tmesh = make_mesh((4,), ("pp",), ["cpu"] * 4)
    gw_j, gx_j = jax.grad(
        lambda w, a: jnp.sum(jpipe.gpipe_spmd(jax_stage_fn, w, a, jmesh,
                                              n_micro=4) ** 2),
        argnums=(0, 1))(jax.device_put(
            jw, jpipe.stage_param_sharding(jw, jmesh)), jnp.asarray(x))
    layers = [torch.from_numpy(w).requires_grad_() for w in ws]
    tx = torch.from_numpy(x).requires_grad_()
    y = tpipe.gpipe_spmd(torch_stage_fn, tpipe.stack_stage_params(layers),
                         tx, tmesh, n_micro=4)
    grads = torch.autograd.grad((y ** 2).sum(), [*layers, tx])
    assert_close(torch.stack(grads[:-1]), gw_j, 1e-5, "gpipe dW")
    assert_close(grads[-1], gx_j, 1e-5, "gpipe dX")


def test_pipeline_with_dp(setup):
    ws, x = setup
    jw, tw = _stacked(ws)
    jmesh = jax_make_mesh((2, 4), ("dp", "pp"))
    tmesh = make_mesh((2, 4), ("dp", "pp"), ["cpu"] * 8)
    y_j = jpipe.gpipe_spmd(
        jax_stage_fn,
        jax.device_put(jw, jpipe.stage_param_sharding(jw, jmesh)),
        jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("dp"))),
        jmesh, n_micro=2, batch_axis="dp")
    y_t = tpipe.gpipe_spmd(torch_stage_fn, tw, torch.from_numpy(x), tmesh,
                           n_micro=2, batch_axis="dp")
    assert_close(y_t, y_j, 1e-5, "gpipe dp x pp")


def test_pipeline_rejects_bad_splits(setup):
    ws, x = setup
    _, tw = _stacked(ws)
    tmesh = make_mesh((4,), ("pp",), ["cpu"] * 4)
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.gpipe_spmd(torch_stage_fn, tw, torch.from_numpy(x), tmesh,
                         n_micro=3)
    with pytest.raises(ValueError, match="layers do not divide"):
        tpipe.gpipe_spmd(torch_stage_fn, tw[:6], torch.from_numpy(x), tmesh,
                         n_micro=2)


@pytest.mark.parametrize("batch_axis", [None, "dp"])
def test_transformer_pipeline_forward(batch_axis):
    """The model through the GPipe path: the JAX package's logits, and the
    port's own `forward`; gradients reach every layer's parameters."""
    kw = dict(vocab_size=61, d_model=32, n_layers=4, n_heads=2, n_kv_heads=2,
              d_head=16, d_ff=64, max_seq=16)
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = ttf.TransformerConfig(dtype=torch.float32, **kw)
    jparams = jtf.init_params(jax.random.PRNGKey(5), jcfg)
    tokens = np.random.default_rng(6).integers(0, 61, (4, 16)).astype(
        np.int32)
    shape, names = ((2, 2), ("dp", "pp")) if batch_axis else ((2,), ("pp",))
    jmesh = jax_make_mesh(shape, names, jax.devices()[:int(np.prod(shape))])
    tmesh = make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))
    want = jtf.pipeline_forward(jparams, jnp.asarray(tokens), jcfg, jmesh,
                                n_micro=2, batch_axis=batch_axis)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    tok = torch.from_numpy(tokens)
    got = ttf.pipeline_forward(model, tok, tmesh, n_micro=2,
                               batch_axis=batch_axis)
    assert got.dtype == torch.float32
    assert_close(got, want, 1e-4, "transformer gpipe vs JAX")
    ref = ttf.forward(model, tok)
    assert_close(got, ref, 1e-4, "transformer gpipe vs forward")
    names_p = [n for n, _ in model.named_parameters()]
    g_pp = torch.autograd.grad(got.square().sum(), list(model.parameters()))
    g_ref = torch.autograd.grad(ref.square().sum(), list(model.parameters()))
    for name, a, b in zip(names_p, g_pp, g_ref):
        assert_close(a, b, 1e-4 * max_abs(b), f"gpipe grad {name}")
