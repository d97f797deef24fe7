"""The sequence-, data- and tensor-parallel forms of the torch port's model
(`forward` / `loss_fn` / `make_train_step` with `mesh`, `seq_axis`,
`batch_axis`, `head_axis`; `param_shardings`) against the JAX package's.

The JAX package's `init_params` for a small fp32 model is carried across
with `params_from_jax`; tokens come from a numpy seed. The JAX side runs on
the virtual 8-device CPU mesh (Pallas in interpret mode), the port on a
mesh of repeated "cpu" devices. Gates: 1e-5 on the loss, 1e-4 · max |JAX|
on logits, on each gradient and on each parameter after one SGD(1e-2)
step; the same against the port's own unsharded model."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.utils.testing import assert_close, max_abs

KW = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_head=16, d_ff=128, max_seq=64)
JCFG = jtf.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttf.TransformerConfig(dtype=torch.float32, **KW)
GATE, LOSS_GATE = 1e-4, 1e-5

# mesh layout and the forward keywords of each parallel form
FORMS = {
    "sp": ((4,), ("sp",), dict(seq_axis="sp")),
    "dp_sp": ((2, 4), ("dp", "sp"), dict(seq_axis="sp", batch_axis="dp")),
    "dp_tp_sp": ((2, 2, 2), ("dp", "tp", "sp"),
                 dict(seq_axis="sp", batch_axis="dp", head_axis="tp")),
    "tp": ((2,), ("tp",), dict(head_axis="tp")),
}


@pytest.fixture(scope="module")
def setup():
    jparams = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    tokens = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, (2, 32)).astype(np.int32)
    return jparams, tokens


def _model(jparams, cfg=TCFG):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)


def _meshes(form):
    shape, names, kw = FORMS[form]
    n = int(np.prod(shape))
    return (jax_make_mesh(shape, names, jax.devices()[:n]),
            make_mesh(shape, names, ["cpu"] * n), kw)


def _assert_trees_close(got, want, what):
    leaves_g = jax.tree_util.tree_leaves_with_path(got)
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in leaves_g] == [p for p, _ in leaves_w]
    for (path, g), (_, w) in zip(leaves_g, leaves_w):
        assert_close(g, w, GATE * max_abs(w),
                     f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("form", list(FORMS))
def test_parallel_forward_matches(setup, form):
    jparams, tokens = setup
    jmesh, tmesh, kw = _meshes(form)
    want = jtf.forward(jparams, jnp.asarray(tokens), JCFG, mesh=jmesh, **kw)
    model = _model(jparams)
    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        got = ttf.forward(model, tok, mesh=tmesh, **kw)
        ref = ttf.forward(model, tok)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 32, 128)
    assert_close(got, want, GATE * max_abs(want), f"{form} logits vs JAX")
    assert_close(got, ref, GATE * max_abs(ref), f"{form} logits vs unsharded")


@pytest.mark.parametrize("form", list(FORMS))
def test_parallel_train_step_matches(setup, form):
    """Loss, every gradient, and every parameter after one SGD(1e-2) step:
    the gradients flow through the ring backward (with `head_axis`, one
    ring per head shard)."""
    jparams, tokens = setup
    jmesh, tmesh, kw = _meshes(form)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jnp.asarray(tokens), JCFG, mesh=jmesh,
                              **kw))(jparams)
    model = _model(jparams)
    tok = torch.from_numpy(tokens)
    loss_t = ttf.loss_fn(model, tok, mesh=tmesh, **kw)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_GATE
    _assert_trees_close(params_to_jax(model, grads=True),
                        jax.tree_util.tree_map(np.asarray, grads_j),
                        f"{form} grad")

    if form == "sp":
        opt = optax.sgd(1e-2)
        new_j, _, _ = jtf.make_train_step(
            JCFG, opt, donate=False, mesh=jmesh, **kw)(
                jparams, opt.init(jparams), jnp.asarray(tokens))
    else:  # SGD written out on the JAX gradients (one compile less)
        new_j = jax.tree_util.tree_map(lambda p, g: p - 1e-2 * g, jparams,
                                       grads_j)
    model = _model(jparams)
    step = ttf.make_train_step(
        model, torch.optim.SGD(model.parameters(), lr=1e-2), mesh=tmesh,
        **kw)
    loss_s = step(tok)
    assert not loss_s.requires_grad
    assert abs(loss_s.item() - float(loss_j)) <= LOSS_GATE
    _assert_trees_close(params_to_jax(model),
                        jax.tree_util.tree_map(np.asarray, new_j),
                        f"{form} param")

    plain = _model(jparams)
    ttf.make_train_step(
        plain, torch.optim.SGD(plain.parameters(), lr=1e-2))(tok)
    _assert_trees_close(params_to_jax(model), params_to_jax(plain),
                        f"{form} param vs unsharded")


def test_windowed_sequence_parallel_matches(setup):
    """`cfg.window` ends the ring early; logits and gradients still match
    the JAX model's."""
    import dataclasses
    jparams, tokens = setup
    jcfg = dataclasses.replace(JCFG, window=12)
    tcfg = dataclasses.replace(TCFG, window=12)
    jmesh, tmesh, kw = _meshes("sp")
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jnp.asarray(tokens), jcfg, mesh=jmesh,
                              **kw))(jparams)
    model = _model(jparams, tcfg)
    loss_t = ttf.loss_fn(model, torch.from_numpy(tokens), mesh=tmesh, **kw)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_GATE
    _assert_trees_close(params_to_jax(model, grads=True),
                        jax.tree_util.tree_map(np.asarray, grads_j),
                        "windowed sp grad")


@pytest.mark.parametrize("head_axis", [None, "tp"])
def test_param_shardings_match_jax(setup, head_axis):
    """The port's per-rank slices are the slices `NamedSharding` gives the
    JAX parameters (the port's matrices are the transposes)."""
    jparams, _ = setup
    jmesh = jax_make_mesh((2, 2, 2), ("dp", "tp", "sp"))
    tmesh = make_mesh((2, 2, 2), ("dp", "tp", "sp"), ["cpu"] * 8)
    jspecs = jtf.param_shardings(jparams, jmesh, head_axis=head_axis)
    placed = jax.device_put(jparams, jspecs)
    model = _model(jparams)
    tspecs = ttf.param_shardings(model, tmesh, head_axis=head_axis)
    assert set(tspecs) == {"embed", "final_norm", "layers"}
    assert len(tspecs["layers"]) == KW["n_layers"]
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(-1).tolist()

    def check(name, jarr, tensor, spec, transpose):
        slices = ttf.shard_param(tensor, spec, tmesh)
        assert sorted(slices) == list(range(8))
        for shard in jarr.addressable_shards:
            rank = ids.index(shard.device.id)
            got = slices[rank].detach().numpy()
            want = np.asarray(shard.data)
            np.testing.assert_array_equal(
                got.T if transpose else got, want, err_msg=f"{name} @{rank}")

    check("embed", placed["embed"], model.embed, tspecs["embed"], False)
    check("final_norm", placed["final_norm"], model.final_norm,
          tspecs["final_norm"], False)
    for i, (jl, blk) in enumerate(zip(placed["layers"], model.layers)):
        weights = ttf.layer_weights(blk)
        assert set(weights) == set(jl) == set(tspecs["layers"][i])
        for name, jarr in jl.items():
            check(f"layers[{i}].{name}", jarr, weights[name],
                  tspecs["layers"][i][name], jarr.ndim == 2)
    if head_axis:
        assert tspecs["layers"][0]["wq"] == ("tp", None)
        assert tspecs["layers"][0]["w_down"] == (None, "tp")
        assert isinstance(jspecs["layers"][0]["wq"], NamedSharding)


def test_tensor_parallel_rejects_indivisible_heads(setup):
    jparams, tokens = setup
    tmesh = make_mesh((3, 2), ("tp", "sp"), ["cpu"] * 6)
    with pytest.raises(ValueError, match="does not divide"):
        ttf.forward(_model(jparams), torch.from_numpy(tokens), mesh=tmesh,
                    seq_axis="sp", head_axis="tp")
