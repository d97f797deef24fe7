"""The torch port's mesh (`parallel/mesh.py`) against the JAX package's:
the same axis sizes and names give the same rank layout, the same shards
and the same one-hop ring permutation. The port's mesh is an array of
`torch.device` whose entries may repeat; here every rank is "cpu", as the
JAX tests put 8 virtual devices on one CPU. Its multi-process backing:
`initialize_distributed` in one process, the transport chosen from the
device identities, entries of other processes, and two real processes of
the launcher (a gloo group on the CPU) that build a global mesh and raise
on a silent peer."""

import os
import subprocess
import sys
from pathlib import Path

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

REPO = Path(__file__).resolve().parent.parent
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
    """A no-op for one process, safe to repeat: no group, no transport,
    the mesh stays this process's."""
    monkeypatch.setattr(tmesh_mod, "_DISTRIBUTED_INITIALIZED", False)
    initialize_distributed()
    initialize_distributed()
    initialize_distributed(num_processes=1)
    assert tmesh_mod.TRANSPORT is None and tmesh_mod.process_count() == 1
    tm = make_mesh((2,), ("sp",), CPUS[:2])
    assert not tm.spans_processes and tm.local([0, 1]) == [0, 1]
    monkeypatch.setattr(tmesh_mod, "_DISTRIBUTED_INITIALIZED", False)
    with pytest.raises(ValueError, match="needs coordinator_address"):
        initialize_distributed("127.0.0.1:1", num_processes=2)


def test_initialize_distributed_needs_a_card_or_the_cpu(monkeypatch):
    """Without a card a process of a group raises unless it is asked to
    run on the CPU; it never lands there by itself (and joins no group)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(tmesh_mod, "_DISTRIBUTED_INITIALIZED", False)
    monkeypatch.delenv("CFA_CPU", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed("127.0.0.1:1", num_processes=2, process_id=0)
    assert tmesh_mod._WORLD is None


@pytest.mark.parametrize("identities,transport", [
    (["h/cpu/1", "h/cpu/2"], "gloo"),
    (["h/GPU-a", "h/GPU-b", "h/GPU-c", "h/GPU-d"], "nccl"),
    (["h/GPU-a", "h/GPU-a"], "staged"),
    (["h/GPU-a", "h/GPU-b", "h/GPU-a", "h/GPU-b"], "staged"),
    (["h1/GPU-a", "h2/GPU-a"], "nccl"),
])
def test_transport_from_device_identities(identities, transport):
    """NCCL where every process has a card of its own; processes that
    share a card stage through the host (NCCL refuses two ranks on one
    card); CPU processes send over gloo."""
    assert tmesh_mod.choose_transport(identities) == transport


def test_transport_refuses_cpus_beside_cards():
    with pytest.raises(ValueError, match="mix CPUs and cards"):
        tmesh_mod.choose_transport(["h/cpu/1", "h/GPU-a"])


def test_places_of_other_processes():
    """Entries of the global device list that another process runs:
    this process runs only its own ranks, and a group of an axis takes in
    the other processes' ranks."""
    cpu = torch.device("cpu")
    places = [tmesh_mod.Place(p, cpu) for p in (0, 0, 1, 1)]
    tm = make_mesh((2, 2), ("dp", "sp"), places)
    assert tm.spans_processes and tm.local(range(4)) == [0, 1]
    assert [tm.is_local(r) for r in range(4)] == [True, True, False, False]
    assert tm.home == cpu and tm.process(3) == 1
    assert tm.fibers("dp", [0, 1]) == [[0, 2], [1, 3]]
    assert tm.fibers("sp", [0, 1]) == [[0, 1]]
    with pytest.raises(ValueError, match="entries of their"):
        tm.fibers("sp", [0])  # this process's rank 1 is missing
    with pytest.raises(ValueError, match="runs in process 1"):
        tm.streams(2)
    assert shard_on_axis(tm, torch.zeros(4, 2), 0, "dp")[1] is None


def _launch(tmp_path, body, np=2, timeout=120):
    """Run `body` as a script in `np` processes of the launcher (on the
    CPU); its processes' output."""
    script = tmp_path / "child.py"
    script.write_text(body)
    r = subprocess.run(
        [sys.executable, "-m",
         "cuda_flashattention_torch.scripts.launch_multihost", "-np",
         str(np), "--devices-per-proc", "2", "--cpu", str(script)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=timeout)
    return r


def test_two_process_group_builds_a_global_mesh(tmp_path):
    """`initialize_distributed("127.0.0.1:<port>", num_processes=2,
    process_id=i)` forms a gloo group; `make_mesh` then spans both
    processes' ranks, and a hop between them carries the data."""
    r = _launch(tmp_path, """
import torch
from cuda_flashattention_torch import config
from cuda_flashattention_torch.parallel import mesh as M
M.initialize_distributed(config.COORD(), config.NPROC.as_int,
                         config.PID.as_int)
M.initialize_distributed(config.COORD(), config.NPROC.as_int,
                         config.PID.as_int)  # idempotent
mesh = M.make_mesh((4,), ("sp",))
me = M.process_index()
assert M.TRANSPORT == "gloo" and M.process_count() == 2
assert [mesh.process(r) for r in range(4)] == [0, 0, 1, 1]
assert mesh.local(range(4)) == [2 * me, 2 * me + 1]
with mesh.region(range(4), mesh.home):
    moving = mesh.send(torch.full((3,), 7.0) if me == 0 else None, 1, 2,
                       like=((3,), torch.float32))
    got = moving.wait() if me == 1 else None
if me == 1:
    assert got.tolist() == [7.0, 7.0, 7.0], got
print("mesh", mesh, "ok", flush=True)
""")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "processes=[0, 1]" in r.stdout and "ok" in r.stdout, r.stdout


def test_gpipe_backward_keeps_the_microbatch_order(tmp_path):
    """GPipe's backward across processes walks the reverse schedule
    itself: two microbatches' gradients (the same shape, weighted 1 and
    -7 by the loss, so a swap shows) pair with their own receives even
    where the two processes build the loss, and so their autograd
    graphs, in opposite microbatch orders. Every gradient is bit for bit
    the one-process pipeline's."""
    r = _launch(tmp_path, """
import torch
from cuda_flashattention_torch import config
from cuda_flashattention_torch.parallel import mesh as M
from cuda_flashattention_torch.parallel.pipeline import gpipe_spmd
M.initialize_distributed(config.COORD(), config.NPROC.as_int,
                         config.PID.as_int)
me = M.process_index()

def stage(w, x):
    return torch.tanh(x @ w[0])

gen = torch.Generator().manual_seed(3)
ws = torch.randn(2, 8, 8, generator=gen) * 0.5
x = torch.randn(4, 8, generator=gen)
weights = (1.0, -7.0)
got = []
for mesh in (M.make_mesh((2,), ("pp",), M.global_devices()[::2]),
             M.make_mesh((2,), ("pp",), ["cpu"] * 2)):
    w, a = ws.clone().requires_grad_(), x.clone().requires_grad_()
    y = gpipe_spmd(stage, w, a, mesh, n_micro=2)
    parts = [(y[m * 2:(m + 1) * 2] * c).sum()
             for m, c in enumerate(weights)]
    order = parts if (me == 0 or not mesh.spans_processes) else parts[::-1]
    loss = order[0] + order[1]  # the same value in both orders
    got.append(torch.autograd.grad(loss, (w, a)))
for name, g, want in zip(("dw", "dx"), got[0], got[1]):
    assert torch.equal(g, want), (name, (g - want).abs().max())
print("microbatch order ok", me, flush=True)
""")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "microbatch order ok 0" in r.stdout, r.stdout


def test_lost_peer_raises_within_the_timeout(tmp_path):
    """A peer that never sends makes the receive raise once the group's
    timeout (3 s here) has passed: it does not hang."""
    r = _launch(tmp_path, """
import sys, time, torch
from cuda_flashattention_torch import config
from cuda_flashattention_torch.parallel import mesh as M
M.initialize_distributed(config.COORD(), config.NPROC.as_int,
                         config.PID.as_int, timeout_s=3)
mesh = M.make_mesh((4,), ("sp",))
if M.process_index() == 1:
    time.sleep(8)  # alive, silent
    sys.exit(0)
t0 = time.perf_counter()
try:
    with mesh.region(range(4), mesh.home):
        mesh.send(None, 2, 0, like=((4,), torch.float32)).wait()
except RuntimeError as e:
    print(f"raised after {time.perf_counter() - t0:.2f} s: {e}")
    sys.exit(0)
sys.exit("no error")
""")
    assert r.returncode == 0, r.stdout + r.stderr
    secs = float(r.stdout.split("raised after ")[1].split(" s")[0])
    assert 2.5 <= secs <= 8.0, r.stdout
