"""The torch port's mesh (`parallel/mesh.py`) against the JAX package's:
the same axis sizes and names give the same rank layout, the same shards
and the same one-hop ring permutation. The port's mesh is an array of
`torch.device` whose entries may repeat; here every rank is "cpu", as the
JAX tests put 8 virtual devices on one CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cuda_flashattention_tpu.parallel import mesh as jmesh_mod
from cuda_flashattention_torch.parallel import mesh as tmesh_mod
from cuda_flashattention_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    make_mesh,
    sequence_mesh,
    shard_on_axis,
)

CPUS = ["cpu"] * 8
LAYOUTS = [((8,), ("sp",)), ((2, 4), ("dp", "sp")),
           ((2, 2, 2), ("dp", "tp", "sp")), ((4, 2), ("pp", "dp")),
           ((1,), ("sp",))]


@pytest.mark.parametrize("sizes,names", LAYOUTS)
def test_layout_matches_jax(sizes, names):
    """Rank = row-major index, as the JAX mesh lays out jax.devices()."""
    jm = jmesh_mod.make_mesh(sizes, names)
    tm = make_mesh(sizes, names, CPUS)
    assert dict(jm.shape) == tm.shape and tm.axis_names == tuple(names)
    assert tm.size == int(np.prod(sizes))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for idx in np.ndindex(*sizes):
        coords = dict(zip(names, idx))
        assert tm.rank_of(**coords) == ids[idx]
    for axis in names:
        ranks = tm.axis_ranks(axis)
        assert len(ranks) == tm.shape[axis]
        take = tuple(slice(None) if n == axis else 0 for n in names)
        assert ranks == list(ids[take])


@pytest.mark.parametrize("axis,mesh_axis", [(2, "sp"), (0, "dp")])
def test_shard_on_axis_matches_jax(axis, mesh_axis):
    x = np.random.default_rng(0).normal(size=(2, 3, 8, 4)).astype(np.float32)
    jm = jmesh_mod.make_mesh((2, 4), ("dp", "sp"))
    tm = make_mesh((2, 4), ("dp", "sp"), CPUS)
    placed = jmesh_mod.shard_on_axis(jm, jnp.asarray(x), axis, mesh_axis)
    want = {}
    for s in placed.addressable_shards:
        want.setdefault(s.index[axis].start or 0, np.asarray(s.data))
    got = shard_on_axis(tm, torch.from_numpy(x), axis, mesh_axis)
    assert len(got) == tm.shape[mesh_axis] == len(want)
    for shard, start in zip(got, sorted(want)):
        assert shard.is_contiguous()
        np.testing.assert_array_equal(shard.numpy(), want[start])
    with pytest.raises(ValueError, match="does not divide"):
        shard_on_axis(tm, torch.zeros(2, 3, 7, 4), 2, "sp")


@pytest.mark.parametrize("n", [1, 2, 8])
def test_send_is_the_ring_permutation(n):
    """Rank-tagged data arrives from the previous rank after one hop, as
    `ppermute` delivers it in the JAX package's ring."""
    jm = jmesh_mod.make_mesh((n,), ("sp",), jax.devices()[:n])
    perm = [(i, (i + 1) % n) for i in range(n)]
    x = np.arange(n, dtype=np.float32).reshape(n, 1)
    want = np.asarray(jax.shard_map(
        lambda a: jax.lax.ppermute(a, "sp", perm), mesh=jm,
        in_specs=P("sp", None), out_specs=P("sp", None))(jnp.asarray(x)))
    tm = make_mesh((n,), ("sp",), CPUS)
    ranks = tm.axis_ranks("sp")
    shards = shard_on_axis(tm, torch.from_numpy(x), 0, "sp")
    got = [None] * n
    with tm.region(ranks, torch.device("cpu")) as reg:
        for i, r in enumerate(ranks):
            sent = tm.send(shards[i], r, ranks[(i + 1) % n])
            got[(i + 1) % n] = sent.wait()
            assert got[(i + 1) % n] is not shards[i]  # a copy, not a view
            reg.keep(shards[i])
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def test_devices_may_repeat_and_cpu_ranks_have_no_streams():
    tm = make_mesh((2, 2), ("dp", "sp"), [torch.device("cpu")] * 4)
    assert isinstance(tm, Mesh) and tm.size == 4
    assert tm.distinct_devices() == [torch.device("cpu")]
    for r in range(4):
        assert tm.device(r) == torch.device("cpu")
        assert tm.streams(r) == (None, None)
        with tm.on(r):
            pass
    tm.barrier(range(4))


def test_make_mesh_raises_when_devices_are_too_few():
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh((2, 4), ("dp", "sp"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2),
             ("sp",))
    tm = make_mesh((4,), ("sp",), CPUS)
    with pytest.raises(ValueError, match="no axis"):
        tm.axis_ranks("tp")
    with pytest.raises(ValueError, match="no axis"):
        tm.rank_of(tp=1)


@pytest.mark.parametrize("build", ["make_mesh", "sequence_mesh"])
def test_default_devices_are_the_cards_and_raise_without_one(build):
    """`devices=None` means the visible CUDA cards: with none present the
    mesh is refused, it does not land on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if build == "make_mesh":
            make_mesh((1,), ("sp",))
        else:
            sequence_mesh(1)


def test_sequence_mesh_takes_given_devices():
    tm = sequence_mesh(4, devices=CPUS)
    assert tm.shape == {"sp": 4}
    assert sequence_mesh(devices=CPUS[:3], axis_name="cp").shape == {"cp": 3}


def test_initialize_distributed(monkeypatch):
    """A no-op for one process, safe to repeat; the multi-process backing
    is not ported and says where it is queued."""
    monkeypatch.setattr(tmesh_mod, "_DISTRIBUTED_INITIALIZED", False)
    initialize_distributed()
    initialize_distributed()
    monkeypatch.setattr(tmesh_mod, "_DISTRIBUTED_INITIALIZED", False)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        initialize_distributed("localhost:1234", num_processes=2,
                               process_id=0)
