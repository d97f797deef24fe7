"""The device-initiated ring of the torch port (`parallel/device_ring.py`)
on the CPU, where `device_ring_matmul` runs its plain version
`ring_matmul_plain`: held against (Σ_i x_i) @ W from numpy and against the
JAX example's `xla_ring_matmul` (examples/07_device_ring.py, loaded by
path; its Pallas kernel moves data between devices and has no interpret
mode, so the example's own ppermute ring is the JAX side here). Gates:
1e-4 · max |reference| in fp32 (bf16 inputs, fp32 accumulation; the ring
sums the shards' products in ring order, numpy sums the shards first), and
the example's own 1e-2. The CUDA kernel itself runs only on a card: its
tests are the `cuda`-marked ones of tests/test_torch_kernels_cuda.py."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cuda_flashattention_torch.parallel import device_ring
from cuda_flashattention_torch.parallel.device_ring import (
    device_ring_matmul,
    ring_matmul_plain,
)
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.utils.testing import assert_close, max_abs

REPO = Path(__file__).resolve().parent.parent
EXAMPLE_GATE = 1e-2
STAGE = "cuda_flashattention_torch.examples.device_ring"


def _inputs(n, rows, d, seed=0):
    """bf16-representable values, as the example draws them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (n * rows, d)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (d, d)).astype(
        np.float32)).to(torch.bfloat16)
    return x, w


def _reference(x, w, n):
    xf = x.float().numpy().astype(np.float64)
    ref = xf.reshape(n, -1, xf.shape[1]).sum(0) @ w.float().numpy().astype(
        np.float64)
    return np.tile(ref, (n, 1))


@pytest.fixture(scope="module")
def example():
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


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,d", [(64, 128), (24, 64)])
def test_plain_ring_matches_numpy(n, rows, d):
    x, w = _inputs(n, rows, d, seed=n)
    mesh = make_mesh((n,), ("sp",), ["cpu"] * n)
    o = ring_matmul_plain(x, w, mesh)
    ref = _reference(x, w, n)
    assert o.dtype == torch.float32 and tuple(o.shape) == (n * rows, d)
    assert max_abs(ref) > 0
    assert_close(o, ref, 1e-4 * max_abs(ref), f"plain ring n={n}")
    assert max_abs(o.numpy() - ref) < EXAMPLE_GATE


# (n, d): the ring at d = 128, then at d = 256 (K9's widest build) and d =
# 200 (a width the card runs padded to 256); the d = 128 cases keep their
# ids
_JAX_CASES = ([pytest.param(n, 128, id=str(n)) for n in (2, 4, 8)]
              + [pytest.param(n, d, id=f"{n}-d{d}")
                 for d in (256, 200) for n in (2, 4)])


@pytest.mark.parametrize("n,d", _JAX_CASES)
def test_plain_ring_matches_the_jax_example(example, n, d):
    x, w = _inputs(n, 128, d, seed=7)
    jmesh = jax_make_mesh((n,), ("sp",), jax.devices()[:n])
    want = example.xla_ring_matmul(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(w.float().numpy(), jnp.bfloat16), jmesh)
    got = ring_matmul_plain(x, w, make_mesh((n,), ("sp",), ["cpu"] * n))
    assert_close(got, want, 1e-4 * max_abs(want), f"plain ring vs JAX n={n}")


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    x, w = _inputs(4, 64, 128)
    mesh = make_mesh((4,), ("sp",), ["cpu"] * 4)
    calls = []
    monkeypatch.setattr(device_ring, "ring_matmul_plain",
                        lambda *a: calls.append(a) or ring_matmul_plain(*a))
    before = device_ring_matmul.launches
    o = device_ring_matmul(x, w, mesh)
    assert len(calls) == 1 and device_ring_matmul.launches == before
    assert torch.equal(o, ring_matmul_plain(x, w, mesh))


def test_ring_axis_of_a_larger_mesh():
    """Only the named axis rotates; other axes are left at index 0."""
    x, w = _inputs(4, 64, 64, seed=3)
    mesh = make_mesh((2, 4), ("dp", "sp"), ["cpu"] * 8)
    o = device_ring_matmul(x, w, mesh, axis_name="sp")
    ref = _reference(x, w, 4)
    assert_close(o, ref, 1e-4 * max_abs(ref), "ring on an axis")


@pytest.mark.parametrize("bad", ["rows", "w_shape", "devices"])
def test_rejects_bad_arguments(bad):
    mesh = make_mesh((4,), ("sp",), ["cpu"] * 4)
    x, w = _inputs(4, 64, 128)
    if bad == "rows":
        with pytest.raises(ValueError, match="do not divide"):
            device_ring_matmul(x[:250], w, mesh)
    elif bad == "w_shape":
        with pytest.raises(ValueError, match=r"w \[d, d\]"):
            device_ring_matmul(x, w[:, :64], mesh)
    else:
        with pytest.raises(ValueError, match="unsupported device"):
            device_ring_matmul(x.to("meta"), w.to("meta"), mesh)


def test_example_stage_prints_the_ladder_contract():
    """`python -m cuda_flashattention_torch.examples.device_ring --cpu`:
    both rings within 1e-2 of the reference, then `Test PASSED!`."""
    import subprocess
    proc = subprocess.run(
        [sys.executable, "-m", STAGE, "--cpu", "--ranks", "4"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "Test PASSED!"
    assert lines[0].startswith("devices=4") and "diff vs ref" in lines[0]
    assert sum("us/iter" in ln for ln in lines) == 2


def test_example_stage_needs_a_card_unless_asked_for_the_cpu():
    import os
    import subprocess
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", STAGE], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "Test PASSED!" not in proc.stdout


@pytest.mark.parametrize("n,d", _JAX_CASES)
def test_plain_ring_matches_the_jax_example_in_fp32(example, n, d):
    """fp32 shards and W, which the example takes as they come and the
    card's fp32 build computes: the plain ring against `xla_ring_matmul`
    on the same fp32 values."""
    rng = np.random.default_rng(11 + n)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (n * 128, d)).astype(
        np.float32))
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (d, d)).astype(
        np.float32))
    jmesh = jax_make_mesh((n,), ("sp",), jax.devices()[:n])
    with jax.default_matmul_precision("highest"):
        want = example.xla_ring_matmul(jnp.asarray(x.numpy()),
                                       jnp.asarray(w.numpy()), jmesh)
    got = ring_matmul_plain(x, w, make_mesh((n,), ("sp",), ["cpu"] * n))
    assert got.dtype == torch.float32
    ref = _reference(x, w, n)
    assert_close(got, want, 1e-4 * max_abs(want),
                 f"fp32 plain ring vs JAX n={n}")
    assert_close(got, ref, 1e-4 * max_abs(ref), f"fp32 plain ring n={n}")
