"""The sequence-, data- and tensor-parallel forms of the torch port's model
(`forward` / `loss_fn` / `make_train_step` with `mesh`, `seq_axis`,
`batch_axis`, `head_axis`; `param_shardings`, `shard_model`,
`gather_model`) against the JAX package's.

The JAX package's `init_params` for a small fp32 model is carried across
with `params_from_jax`; tokens come from a numpy seed. The JAX side runs on
the virtual 8-device CPU mesh (Pallas in interpret mode), the port on a
mesh of repeated "cpu" devices. Gates: 1e-5 on the loss, 1e-4 · max |JAX|
on logits, on each gradient and on each parameter after one SGD(1e-2)
step; the same against the port's own unsharded model.

The cases after the JAX ones hold what the port does on the ranks against
its own model without a mesh (no JAX compile): where the slices sit, the
rows and weights of every rank's product, the collectives' counts, the
replicas after a step, a sequence that does not divide the axis, and the
RoPE positions of each sequence block."""

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
    placed = ttf.shard_model(model, tmesh, **kw)
    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        got = ttf.forward(placed, tok, mesh=tmesh, **kw)
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
    placed = ttf.shard_model(_model(jparams), tmesh, **kw)
    tok = torch.from_numpy(tokens)
    loss_t = ttf.loss_fn(placed, tok, mesh=tmesh, **kw)
    loss_t.backward()
    placed.sync_grads()
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_GATE
    _assert_trees_close(params_to_jax(ttf.gather_model(placed), grads=True),
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
    placed = ttf.shard_model(_model(jparams), tmesh, **kw)
    step = ttf.make_train_step(
        placed, torch.optim.SGD(placed.parameters(), lr=1e-2), mesh=tmesh,
        **kw)
    loss_s = step(tok)
    assert not loss_s.requires_grad
    assert abs(loss_s.item() - float(loss_j)) <= LOSS_GATE
    model = ttf.gather_model(placed)
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
    placed = ttf.shard_model(_model(jparams, tcfg), tmesh, **kw)
    loss_t = ttf.loss_fn(placed, torch.from_numpy(tokens), mesh=tmesh, **kw)
    loss_t.backward()
    placed.sync_grads()
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_GATE
    _assert_trees_close(params_to_jax(ttf.gather_model(placed), grads=True),
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
        ttf.shard_model(_model(jparams), tmesh, seq_axis="sp",
                        head_axis="tp")


# ---------------------------------------------------------------------------
# On the ranks: against the port's own model without a mesh
# ---------------------------------------------------------------------------

COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")  # cut on the output dim
ROW = ("wo", "w_down")  # cut on the input dim
REPLICATED = ("attn_norm", "mlp_norm")


def _port_mesh(form):
    shape, names, kw = FORMS[form]
    return make_mesh(shape, names, ["cpu"] * int(np.prod(shape))), kw


def test_shard_model_places_tensor_parallel_slices(setup):
    """Each tp rank holds 1/tp of the output rows of wq/wk/wv/w_gate/w_up
    and of the input columns of wo/w_down, as parameters apart from the
    model's; the tp ranks' slices add up to the whole matrix; norms and
    the embedding are whole copies. The ranks share one device here, so
    they share one parameter per slice and per replicated leaf."""
    jparams, _ = setup
    model = _model(jparams)
    mesh, kw = _port_mesh("dp_tp_sp")
    placed = ttf.shard_model(model, mesh, **kw)
    w = placed.weights()
    assert sorted(w) == list(range(8))
    tp = mesh.shape["tp"]
    assert len(list(placed.parameters())) == 2 + KW["n_layers"] * (
        len(REPLICATED) + tp * len(COLUMN + ROW))
    for i, blk in enumerate(model.layers):
        whole = ttf.layer_weights(blk)
        for name, full in whole.items():
            dim = 0 if name in COLUMN else 1 if name in ROW else None
            for r in range(8):
                piece = w[r]["layers"][i][name]
                assert isinstance(piece, torch.nn.Parameter)
                assert piece.data_ptr() != full.data_ptr()
                t = mesh.coords(r)["tp"]
                want = full if dim is None else full.chunk(tp, dim)[t]
                assert torch.equal(piece, want), f"{name} @{r}"
                if dim is not None:
                    assert piece.shape[dim] * tp == full.shape[dim]
                owner = w[0] if dim is None else w[mesh.rank_of(
                    dp=0, tp=t, sp=0)]
                assert piece is owner["layers"][i][name]
            if dim is not None:
                fiber = mesh.axis_ranks("tp", dp=1, sp=1)
                assert sum(w[r]["layers"][i][name].numel()
                           for r in fiber) == full.numel()
    for r in range(8):
        assert torch.equal(w[r]["embed"], model.embed)
        assert torch.equal(w[r]["final_norm"], model.final_norm)


def test_each_rank_multiplies_its_rows_by_its_slices(setup, monkeypatch):
    """A recorder on `F.linear`: in the forward every product of a layer
    takes B/dp × T/sp rows and one rank's slice, never a whole tp-cut
    matrix; the tied unembedding takes the rank's 1/tp of those rows."""
    jparams, tokens = setup
    mesh, kw = _port_mesh("dp_tp_sp")
    placed = ttf.shard_model(_model(jparams), mesh, **kw)
    slices, embeds = {}, {}
    for r, tree in placed.weights().items():
        embeds[id(tree["embed"])] = r
        for lw in tree["layers"]:
            for name in COLUMN + ROW:
                slices[id(lw[name])] = (r, name, lw[name].shape)
    seen = []
    real = torch.nn.functional.linear

    def record(x, weight, *args, **kwargs):
        seen.append((int(np.prod(x.shape[:-1])), id(weight)))
        return real(x, weight, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "linear", record)
    with torch.no_grad():
        ttf.forward(placed, torch.from_numpy(tokens))
    rows = tokens.shape[0] // 2 * tokens.shape[1] // 2
    products = [s for s in seen if s[1] in slices]
    unembeds = [s for s in seen if s[1] in embeds]
    assert len(products) == 8 * KW["n_layers"] * 7
    assert len(unembeds) == 8 and len(seen) == len(products) + 8
    assert all(n == rows for n, _ in products)
    assert all(n == rows // 2 for n, _ in unembeds)
    for _, key in products:
        _, name, shape = slices[key]
        whole = (KW["n_heads"] * KW["d_head"] if name in ("wq", "wo") else
                 KW["n_kv_heads"] * KW["d_head"] if name in ("wk", "wv")
                 else KW["d_ff"])
        assert shape[0 if name in COLUMN else 1] == whole // 2


@pytest.mark.parametrize("form", ["sp", "dp_tp_sp"])
def test_collective_counts(setup, form):
    """Per layer, the forward all-gathers the block's rows twice (before
    the attention and the MLP products) and reduce-scatters twice (after
    wo and w_down), and the backward does each twice again. The ranks
    share one device, and with it one copy of each replicated leaf, whose
    gradient autograd has summed: a train step adds no all-reduce
    (`test_ranks_on_one_card_share_one_copy` holds the grouping over
    distinct cards)."""
    from cuda_flashattention_torch.parallel import collectives
    jparams, tokens = setup
    mesh, kw = _port_mesh(form)
    placed = ttf.shard_model(_model(jparams), mesh, **kw)
    tok = torch.from_numpy(tokens)
    n = KW["n_layers"] * 2 if "head_axis" in kw else 0

    def counts(fn):
        for kind in collectives.calls:
            collectives.calls[kind] = 0
        fn()
        return dict(collectives.calls)

    with torch.no_grad():
        fwd = counts(lambda: ttf.forward(placed, tok))
    both = counts(lambda: ttf.loss_fn(placed, tok).backward())
    step = ttf.make_train_step(
        placed, torch.optim.SGD(placed.parameters(), lr=1e-2))
    train = counts(lambda: step(tok))
    assert fwd == dict(all_reduce=0, all_gather=n, reduce_scatter=n)
    assert both == dict(all_reduce=0, all_gather=2 * n,
                        reduce_scatter=2 * n)
    assert train == dict(all_reduce=0, all_gather=2 * n,
                         reduce_scatter=2 * n)


def test_replicas_equal_after_a_step(setup):
    """After one step every copy of a leaf is bit-identical across the
    ranks that hold it: the tp-cut slices over dp and sp, the norms and
    the embedding over every rank; and every leaf moved."""
    jparams, tokens = setup
    mesh, kw = _port_mesh("dp_tp_sp")
    placed = ttf.shard_model(_model(jparams), mesh, **kw)
    before = {r: [p.detach().clone() for p in m.parameters()]
              for r, m in placed.ranks.items()}
    ttf.make_train_step(placed, torch.optim.SGD(placed.parameters(),
                                                lr=1e-2))(
        torch.from_numpy(tokens))
    w = placed.weights()
    for name in ("embed", "final_norm"):
        assert all(torch.equal(w[r][name], w[0][name]) for r in w)
    for i in range(KW["n_layers"]):
        for name, p0 in w[0]["layers"][i].items():
            for r in w:
                same = name in REPLICATED or (
                    mesh.coords(r)["tp"] == mesh.coords(0)["tp"])
                if same:
                    assert torch.equal(w[r]["layers"][i][name], p0), \
                        f"layers[{i}].{name} @{r}"
    moved = [not torch.equal(a, p) for r, m in placed.ranks.items()
             for a, p in zip(before[r], m.parameters())]
    assert all(moved)


@pytest.mark.parametrize("form", ["sp", "dp_tp_sp"])
def test_ragged_sequence_matches_unsharded(setup, form):
    """T = 30 does not divide sp: the blocks are padded as the ring pads
    (4 × 8 and 2 × 15, the latter cut 8 + 7 over tp). Logits, loss, every
    gradient and one SGD(1e-2) step against the model without a mesh."""
    jparams, tokens = setup
    tok = torch.from_numpy(tokens[:, :30])
    mesh, kw = _port_mesh(form)
    plain = _model(jparams)
    placed = ttf.shard_model(_model(jparams), mesh, **kw)
    with torch.no_grad():
        ref = ttf.forward(plain, tok)
        got = ttf.forward(placed, tok)
    assert tuple(got.shape) == (2, 30, KW["vocab_size"])
    assert_close(got, ref, GATE * max_abs(ref), f"{form} ragged logits")

    loss_ref = ttf.loss_fn(plain, tok)
    loss_ref.backward()
    loss = ttf.loss_fn(placed, tok)
    loss.backward()
    placed.sync_grads()
    assert abs(loss.item() - loss_ref.item()) <= LOSS_GATE
    _assert_trees_close(params_to_jax(ttf.gather_model(placed), grads=True),
                        params_to_jax(plain, grads=True),
                        f"{form} ragged grad")

    ttf.make_train_step(placed, torch.optim.SGD(placed.parameters(),
                                                lr=1e-2))(tok)
    plain = _model(jparams)
    ttf.make_train_step(plain, torch.optim.SGD(plain.parameters(),
                                               lr=1e-2))(tok)
    _assert_trees_close(params_to_jax(ttf.gather_model(placed)),
                        params_to_jax(plain), f"{form} ragged param")


def test_rope_positions_are_global(setup, monkeypatch):
    """Each sequence block is rotated at its global positions: the rotated
    q and k of every block equal the unsharded model's rows at those
    positions (a block rotated at arange(L) would give finite logits and
    fail only here and in the parity tests)."""
    jparams, tokens = setup
    tok = torch.from_numpy(tokens[:, :30])
    mesh, kw = _port_mesh("sp")
    model = _model(jparams)
    placed = ttf.shard_model(model, mesh, **kw)
    calls = []
    real = ttf.rope

    def record(x, positions, theta):
        out = real(x, positions, theta)
        calls.append((positions.clone(), out))
        return out

    monkeypatch.setattr(ttf, "rope", record)
    with torch.no_grad():
        ttf.forward(model, tok)
        whole = calls[:2]  # layer 0: q, k over all 30 positions
        calls.clear()
        ttf.forward(placed, tok)
    assert len(calls) == 4 * 2 * KW["n_layers"]
    for s in range(4):  # layer 0, rank s: q then k
        for (pos, out), (_, ref) in zip(calls[2 * s:2 * s + 2], whole):
            assert pos.tolist() == list(range(8 * s, 8 * s + 8))
            live = pos < 30
            assert_close(out[:, live], ref[:, pos[live]], 1e-6,
                         f"rotated block {s}")


def test_train_step_needs_the_placed_model(setup):
    """On a mesh the train step, the forward and the loss take the model
    that `shard_model` placed; a plain `Transformer` raises."""
    jparams, tokens = setup
    model = _model(jparams)
    tok = torch.from_numpy(tokens)
    mesh, kw = _port_mesh("sp")
    with pytest.raises(TypeError, match="shard_model"):
        ttf.make_train_step(model, torch.optim.SGD(model.parameters(),
                                                   lr=1e-2), mesh=mesh, **kw)
    for fn in (ttf.forward, ttf.loss_fn):
        with pytest.raises(TypeError, match="shard_model"):
            fn(model, tok, mesh=mesh, **kw)


@pytest.mark.parametrize("form", ["sp", "dp_tp_sp"])
def test_ranks_on_one_card_share_one_copy(form):
    """Ranks spread over two cards (rank i on card i % 2; the mesh is
    only built, nothing runs on it): a rank uses the copy of the first
    rank on its card among its leaf's replicas, so each card holds one
    copy per slice, and `sync_grads` sums one rank per card of each
    group of replicas."""
    shape, names, kw = FORMS[form]
    n = int(np.prod(shape))
    mesh = make_mesh(shape, names, [f"cuda:{i % 2}" for i in range(n)])
    plan = ttf._make_plan(TCFG, mesh, kw.get("batch_axis"),
                          kw.get("seq_axis"), kw.get("head_axis"))
    for name in ("embed", "wq", "w_down", "attn_norm"):
        axes = plan.replica_axes(name)
        owners = plan.owners(axes)
        assert sorted(owners) == list(plan.ranks)
        cut = name in COLUMN + ROW and "head_axis" in kw
        assert set(axes) == {a for a in names if a != "tp" or not cut}
        slices = mesh.shape["tp"] if cut else 1
        assert len(set(owners.values())) == 2 * slices, name
        for r, o in owners.items():
            assert o <= r and mesh.device(o) == mesh.device(r)
            if cut:
                assert mesh.coords(o)["tp"] == mesh.coords(r)["tp"]
        groups = [sorted({owners[r] for r in f})
                  for f in mesh.fibers(axes, plan.ranks)]
        assert len(groups) == slices
        assert all(len(g) == 2 and mesh.device(g[0]) != mesh.device(g[1])
                   for g in groups)
