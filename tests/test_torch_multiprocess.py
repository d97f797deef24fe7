"""The port's parallel layer across processes, on the CPU: real processes
started by the launcher (`cuda_flashattention_torch.scripts.
launch_multihost`, 2 processes x 2 CPU ranks, a gloo group), as
tests/test_examples.py::test_multiprocess_launcher starts the JAX ladder.

The ladder stages 00, 01, 04 and 07 print their pass lines. The paths of
`utils/multiprocess_paths.py` (ring forward and backward, causal and
ragged non-causal, ring decode, Ulysses, the collectives and their
autograd pairs, GPipe forward and backward, the plain device ring,
and the sp2·dp2 and tp2·sp2 train steps of a small model) write their
global outputs from process 0 to an .npz, which is held here against the
port's one-process function on a mesh of repeated "cpu" devices:
bit-equal where the summation order is the same (every path but the
train step, whose replicated gradients are summed across the processes
and not by autograd on one device: 1e-4 · max there), and, one case per
kind, against the JAX function on the same numpy inputs (fp32, 1e-4, both
sides on `softmax="auto"`; the plain ring 1e-5). One launch per
group of paths and one JAX compile per function (module-scoped
fixtures); every child runs under a 120 s timeout."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_tpu.parallel import pipeline as jpipe
from cuda_flashattention_tpu.parallel import ring as jring
from cuda_flashattention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cuda_flashattention_tpu.parallel.ulysses import (
    ulysses_attention as jax_ulysses,
)
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.utils import multiprocess_paths as mp
from cuda_flashattention_torch.utils.testing import (
    assert_close,
    max_abs,
    seeded_random,
)

REPO = Path(__file__).resolve().parent.parent
GATE = 1e-4
# the paths' sizes: B, H, Hkv, N, d (fp32)
SIZES = ["--batch", "2", "--heads", "4", "--kv-heads", "2", "--seq", "64",
         "--d", "16"]
TRAIN_FORMS = {"dp_sp": "dp=2,sp=2", "tp_sp": "tp=2,sp=2"}
TRAIN_B, TRAIN_T = 2, 32
# the plain device ring over the 4 ranks: L rows a shard, widths, types
K9_ROWS, K9_D = 64, (16, 128)
K9_SIZES = ["--k9-rows", str(K9_ROWS), "--k9-d", *map(str, K9_D),
            "--k9-dtypes", "fp32", "bf16"]


def launch(*target, seq="2544"):
    """The launcher at 2 processes x 2 CPU ranks over `target` (-m MODULE
    ... or a script), under a 120 s timeout."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CFA_LADDER_SEQ=seq)
    r = subprocess.run(
        [sys.executable, "-m", "cuda_flashattention_torch.scripts."
         "launch_multihost", "-np", "2", "--devices-per-proc", "2", "--cpu",
         *target], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, f"rc={r.returncode}\n{r.stdout}\n{r.stderr}"
    return r.stdout


def _args(extra=()):
    """The paths' options, as the launched processes parse them."""
    return mp.parse(["ring_causal", "--out", "unused", *SIZES, *extra])


def _one_process(make):
    """A path's outputs on a mesh of 4 repeated "cpu" ranks in this
    process, shaped as the path's own mesh."""
    devs = [torch.device("cpu")] * 4
    run, shape, names, _ = make(devs)
    return {k: v.detach().float().numpy()
            for k, v in run(make_mesh(shape, names, devs)).items()}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    out = tmp_path_factory.mktemp("paths")
    launch("-m", "cuda_flashattention_torch.utils.multiprocess_paths",
           "--out", str(out), "--save", *SIZES, "ring_causal",
           "ring_ragged", "decode", "ulysses", "collectives", "gpipe", "k9",
           *K9_SIZES)
    return {p.stem: dict(np.load(p)) for p in out.glob("*.npz")}


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh((4,), ("sp",), jax.devices()[:4])


def _qkv(seeds, args):
    b, h, hkv, d, n = args.batch, args.heads, args.kv_heads, args.d, args.seq
    return [seeded_random(shape, s) for shape, s in zip(
        ((b, h, n, d), (b, hkv, n, d), (b, hkv, n, d)), seeds)]


# ---------------------------------------------------------------------------
# The ladder under the launcher
# ---------------------------------------------------------------------------

def test_multiprocess_launcher_ring_of_4():
    """Stage 01 over 2 processes x 2 ranks: the counterpart of
    tests/test_examples.py::test_multiprocess_launcher."""
    out = launch("-m", "cuda_flashattention_torch.examples.ppermute_verify")
    assert "Test PASSED!" in out and "ring of 4" in out, out
    assert "transport gloo" in out, out


@pytest.mark.parametrize("stage", ["psum_vecadd", "ring_attention",
                                   "device_ring"])
def test_multiprocess_ladder_stage(stage):
    out = launch("-m", f"cuda_flashattention_torch.examples.{stage}")
    assert "Test PASSED!" in out and "over 2 processes" in out, out
    assert out.count("Test PASSED!") == 1, out  # process 0 prints


# A script whose process 0 reaches its shutdown first: the others sleep,
# then use the group's store (a barrier among themselves, and a closing
# one registered with `at_shutdown`, as K9's workspaces register theirs,
# after which each leaves a file in the directory given as its argument).
# Process 0 counts those files once its shutdown has returned.
LATE_STORE_USERS = """
import sys, time
from pathlib import Path
from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.parallel import mesh
_ladder.bootstrap(cpu=True)
out = Path(sys.argv[1])
me, late = mesh.process_index(), list(range(1, mesh.process_count()))
if me != 0:
    time.sleep(2.0)
    def closing():
        mesh.store_barrier("late/closed", late)
        (out / f"closed_{me}").touch()
    mesh.at_shutdown(closing)
    mesh.store_barrier("late/work", late)
mesh.shutdown_distributed()
if me == 0:
    n = len(list(out.glob("closed_*")))
    print(f"process 0 left after {n} closing barriers", flush=True)
"""


def test_shutdown_waits_for_the_processes_that_still_use_the_store(
        tmp_path):
    """Process 0 hosts the group's store. It finishes its work first and
    reaches `shutdown_distributed` while the other three still sleep; they
    then use the store (a barrier among themselves, and their shutdown
    hooks' closing barrier). Process 0 leaves only once they have counted
    themselves out, so every process exits with 0 (it used to take the
    store down with it, and the late barriers failed or hung), and
    process 0's shutdown returns only after all three closing barriers
    have passed."""
    script = tmp_path / "late_store_users.py"
    script.write_text(LATE_STORE_USERS)
    marks = tmp_path / "marks"
    marks.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "cuda_flashattention_torch.scripts."
         "launch_multihost", "-np", "4", "--cpu", "--timeout", "90",
         str(script), str(marks)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, f"rc={r.returncode}\n{r.stdout}\n{r.stderr}"
    assert "process 0 left after 3 closing barriers" in r.stdout, r.stdout


STUCK_HOOK = """
import time
from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.parallel import mesh
_ladder.bootstrap(cpu=True)
if mesh.process_index() == 1:
    def stuck_in_its_hook():
        time.sleep(600)
    mesh.at_shutdown(stuck_in_its_hook)
mesh.shutdown_distributed()
"""


def test_launcher_shows_where_a_late_process_waits(tmp_path):
    """A process that never leaves its shutdown hook: at the launcher's
    timeout every process still running writes its threads' stacks
    (`mesh.STACK_SIGNAL`) before it is stopped, so the output names the
    hook process 1 waits in and the store wait process 0 waits in; each
    process's shutdown steps come with the host's clock, and `--log-dir`
    keeps process 1's output."""
    script = tmp_path / "stuck_hook.py"
    script.write_text(STUCK_HOOK)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "cuda_flashattention_torch.scripts."
         "launch_multihost", "-np", "2", "--cpu", "--timeout", "15",
         "--log-dir", str(tmp_path / "logs"), str(script)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 124, r.stderr
    assert "processes [0, 1] still running" in r.stderr, r.stderr
    assert "in stuck_in_its_hook" in r.stderr, r.stderr
    assert "in _leave" in r.stderr, r.stderr
    for step in ("p0 shutdown: begins", "p0 shutdown: sends settled",
                 "p1 shutdown: begins"):
        assert f"[mesh] {step} at " in r.stderr, r.stderr
    assert "in stuck_in_its_hook" in (tmp_path / "logs" / "p1.log").read_text()


# ---------------------------------------------------------------------------
# The paths against the one-process port and the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["ring_causal", "ring_ragged"])
def test_ring_matches_one_process(paths, path):
    args = _args()
    want = _one_process(lambda devs: mp._ring(
        args, devs, torch.device("cpu"), path == "ring_causal"))
    assert set(paths[path]) == set(want) == {"o", "dq", "dk", "dv"}
    for name in want:
        np.testing.assert_array_equal(paths[path][name], want[name],
                                      err_msg=f"{path} {name}")


def test_ring_matches_jax(paths, jax_mesh):
    """The causal ring's O against the JAX ring on the virtual CPU mesh,
    its gradients against JAX's autodiff of the same ring."""
    args = _args()
    q, k, v = _qkv((10, 11, 12), args)
    do = seeded_random(q.shape, 13)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    def loss(*a):
        o = jring.ring_attention(*a, jax_mesh, causal=True)
        return jnp.sum(o * do), o
    (_, o_j), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(jq, jk, jv)
    got = paths["ring_causal"]
    assert_close(got["o"], o_j, GATE, "ring O vs JAX")
    for name, g in zip(("dq", "dk", "dv"), g_j):
        assert_close(got[name], g, GATE * max_abs(g), f"ring {name} vs JAX")


def test_decode_matches(paths, jax_mesh):
    args = _args()
    want = _one_process(lambda devs: mp._decode(args, devs,
                                                torch.device("cpu")))
    for name in ("o", "lse"):
        np.testing.assert_array_equal(paths["decode"][name], want[name])
    b, h, hkv, d, n = args.batch, args.heads, args.kv_heads, args.d, args.seq
    q = seeded_random((b, h, d), 20)
    k, v = (seeded_random((b, hkv, n, d), s) for s in (21, 22))
    lengths = np.random.default_rng(23).integers(1, n + 1, b).astype(
        np.int32)
    o_j, lse_j = jring.ring_decode(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lengths),
                                   jax_mesh)
    assert_close(paths["decode"]["o"], o_j, GATE, "ring decode O vs JAX")
    assert_close(paths["decode"]["lse"], lse_j, GATE,
                 "ring decode LSE vs JAX")


def test_ulysses_matches(paths, jax_mesh):
    args = _args()
    want = _one_process(lambda devs: mp._ulysses(args, devs,
                                                 torch.device("cpu")))
    for name in want:
        np.testing.assert_array_equal(paths["ulysses"][name], want[name],
                                      err_msg=f"ulysses {name}")
    q, k, v = _qkv((30, 31, 32), args)
    o_j = jax_ulysses(*(jnp.asarray(a) for a in (q, k, v)), mesh=jax_mesh,
                      causal=True)
    assert_close(paths["ulysses"]["o"], o_j, GATE, "ulysses O vs JAX")


def test_collectives_same_bits(paths):
    """Every rank's result equals the one-process port's bit for bit;
    within each group every rank holds the same bits (the fp32 sums in
    rank order); the sums against numpy and JAX's psum."""
    got = paths["collectives"]
    want = _one_process(lambda devs: mp._collectives(
        _args(), devs, torch.device("cpu")))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    xs = np.stack([seeded_random((12, 3), 300 + r) for r in range(4)])
    # mesh ("dp", "sp") = (2, 2): dp groups {0, 2} and {1, 3} span the
    # two processes
    for r in range(4):
        group = [r % 2, r % 2 + 2]
        np.testing.assert_array_equal(got["all_reduce_dp"][r],
                                      got["all_reduce_dp"][group[0]])
        assert_close(got["all_reduce_dp"][r], xs[group].sum(0), 1e-6,
                     "all_reduce over dp vs numpy")
        np.testing.assert_array_equal(got["all_reduce_all"][r],
                                      got["all_reduce_all"][0])
        np.testing.assert_array_equal(got["all_gather_dp"][r],
                                      np.concatenate(xs[group]))
    jmesh = jax_make_mesh((2, 2), ("dp", "sp"), jax.devices()[:4])
    psum = jax.shard_map(lambda x: jax.lax.psum(x, "dp"), mesh=jmesh,
                         in_specs=jax.sharding.PartitionSpec(("dp", "sp")),
                         out_specs=jax.sharding.PartitionSpec(("dp", "sp")))
    want_j = np.asarray(psum(jnp.asarray(xs.reshape(48, 3)))).reshape(
        4, 12, 3)
    assert_close(got["all_reduce_dp"], want_j, 1e-6, "all_reduce vs psum")


def test_gpipe_matches(paths):
    """GPipe across processes, forward and backward (the reverse schedule
    of `_GPipeAcross`): the output and the gradients of x and of the whole
    layer stack, bit for bit the one-process pipeline's, and within 1e-5
    of JAX's `gpipe_spmd` and its `jax.grad` (1e-5 · max on the
    gradients)."""
    got = paths["gpipe"]
    want = _one_process(lambda devs: mp._gpipe(_args(), devs,
                                               torch.device("cpu")))
    assert set(got) == set(want) == {"y", "dw", "dx"}
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    ws = [seeded_random((mp.PIPE_D, mp.PIPE_D), 160 + i) * 0.5
          for i in range(mp.PIPE_LAYERS)]
    x = seeded_random((mp.PIPE_B, mp.PIPE_D), 170)
    dy = seeded_random((mp.PIPE_B, mp.PIPE_D), 171)
    jmesh = jax_make_mesh((4,), ("pp",), jax.devices()[:4])
    jw = jpipe.stack_stage_params([jnp.asarray(w) for w in ws])

    def stage(w, a):
        for i in range(w.shape[0]):
            a = jnp.tanh(a @ w[i])
        return a

    def loss(w, a):
        y = jpipe.gpipe_spmd(stage, w, a, jmesh, n_micro=4)
        return jnp.sum(y * dy), y
    (_, y_j), (dw_j, dx_j) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jax.device_put(
            jw, jpipe.stage_param_sharding(jw, jmesh)), jnp.asarray(x))
    assert_close(got["y"], y_j, 1e-5, "gpipe vs JAX")
    assert_close(got["dw"], dw_j, 1e-5 * max_abs(dw_j), "gpipe dW vs JAX")
    assert_close(got["dx"], dx_j, 1e-5 * max_abs(dx_j), "gpipe dX vs JAX")


@pytest.fixture(scope="module")
def example07():
    """examples/07_device_ring.py as a module, untouched."""
    sys.path.insert(0, str(REPO / "examples"))
    try:
        spec = importlib.util.spec_from_file_location(
            "example_07_device_ring", REPO / "examples" / "07_device_ring.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(REPO / "examples"))
    return mod


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("d", K9_D)
def test_device_ring_across_processes(paths, example07, d, dtype):
    """`device_ring_matmul` on CPU tensors over a ring whose ranks run in
    two processes (the plain ring, its hops `Mesh.send` pairs and the
    other process's rows of o shared): bit for bit the one-process ring,
    and within 1e-5 of the JAX example's `xla_ring_matmul` on the same
    values (fp32 shards: the bf16 ones as fp32)."""
    got = paths["k9"][f"o[{K9_ROWS},{d},{dtype}]"]
    args = mp.parse(["k9", "--out", "unused", *K9_SIZES])
    want = _one_process(lambda devs: mp._k9(args, devs,
                                            torch.device("cpu")))
    np.testing.assert_array_equal(got, want[f"o[{K9_ROWS},{d},{dtype}]"])
    i = [(r, dd, dt) for r in args.k9_rows for dd in args.k9_d
         for dt in args.k9_dtypes].index((K9_ROWS, d, dtype))
    x = torch.from_numpy(seeded_random((4 * K9_ROWS, d), 900 + i)).to(
        mp.DTYPES[dtype]).float().numpy()
    w = torch.from_numpy(seeded_random((d, d), 950 + i)).to(
        mp.DTYPES[dtype]).float().numpy()
    with jax.default_matmul_precision("highest"):
        ref = example07.xla_ring_matmul(jnp.asarray(x), jnp.asarray(w),
                                        jax_make_mesh((4,), ("sp",),
                                                      jax.devices()[:4]))
    assert max_abs(ref) > 0
    assert_close(got, ref, 1e-5, f"k9 d={d} {dtype} vs JAX")


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

KW, _ = mp.MODELS["tiny"]
JCFG = jtf.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttf.TransformerConfig(dtype=torch.float32, **KW)


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    """The weights (JAX's init, converted), the tokens, and each form's
    saved loss and gradients from the launched processes."""
    tmp = tmp_path_factory.mktemp("train")
    jparams = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            TCFG)
    torch.save(model.state_dict(), tmp / "weights.pt")
    saved = {}
    for form, axes in TRAIN_FORMS.items():
        launch("-m", "cuda_flashattention_torch.utils.multiprocess_paths",
               "--out", str(tmp / form), "--save", "train", "--axes", axes,
               "--weights", str(tmp / "weights.pt"), "--batch",
               str(TRAIN_B), "--seq", str(TRAIN_T), "--steps", "2")
        saved[form] = dict(np.load(tmp / form / "train.npz"))
    tokens = np.random.default_rng(1).integers(
        0, KW["vocab_size"], (TRAIN_B, TRAIN_T)).astype(np.int32)
    return jparams, tokens, saved


def _grads(saved):
    return {k[5:]: v for k, v in saved.items() if k.startswith("grad/")}


@pytest.mark.parametrize("form", list(TRAIN_FORMS))
def test_train_step_matches_one_process(train, form):
    jparams, tokens, saved = train
    shape, names, kw = mp._axes(TRAIN_FORMS[form])
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            TCFG)
    placed = ttf.shard_model(model, make_mesh(shape, names, ["cpu"] * 4),
                             **kw)
    loss = ttf.loss_fn(placed, torch.from_numpy(tokens))
    loss.backward()
    placed.sync_grads()
    whole = ttf.gather_model(placed)
    got = saved[form]
    assert abs(float(got["loss"]) - loss.item()) <= 1e-5
    grads = _grads(got)
    assert set(grads) == {n for n, _ in whole.named_parameters()}
    for n, p in whole.named_parameters():
        want = p.grad.numpy()
        assert max_abs(want) > 0
        assert_close(grads[n], want, GATE * max_abs(want), f"{form} {n}")


def test_train_step_matches_jax(train):
    """The sp2·dp2 step's loss and gradients against JAX's `loss_fn` and
    its autodiff on the same weights and tokens."""
    jparams, tokens, saved = train
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jnp.asarray(tokens), JCFG))(jparams)
    got = saved["dp_sp"]
    assert abs(float(got["loss"]) - float(loss_j)) <= 1e-5
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            TCFG)
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(_grads(got)[n])
    got_j = params_to_jax(model, grads=True)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(got_j),
            jax.tree_util.tree_leaves_with_path(
                jax.tree_util.tree_map(np.asarray, grads_j))):
        assert_close(g, w, GATE * max_abs(w),
                     f"dp_sp grad {jax.tree_util.keystr(path)}")
