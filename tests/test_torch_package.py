"""Guards of the torch port: it imports no JAX, its smoke script refuses
to run without a card, and its kernels are built for Hopper (sm_90a)."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cuda_flashattention_torch import _build

REPO = Path(__file__).resolve().parent.parent


def _python(args, cwd, timeout=120):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _modules():
    """Every module of the package, by import path."""
    root = REPO / "cuda_flashattention_torch"
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        yield ".".join(p for p in parts if p != "__init__")


def test_import_leaves_jax_out():
    """Importing every module of the package (the paged, quant and FA1
    ones included) loads neither JAX nor the JAX package."""
    mods = sorted(set(_modules()))
    assert {"cuda_flashattention_torch.ops.paged",
            "cuda_flashattention_torch.ops.quant",
            "cuda_flashattention_torch.ops.fa1",
            "cuda_flashattention_torch.models.convert",
            "cuda_flashattention_torch.parallel.mesh",
            "cuda_flashattention_torch.parallel.ring",
            "cuda_flashattention_torch.parallel.ulysses",
            "cuda_flashattention_torch.parallel.pipeline",
            "cuda_flashattention_torch.parallel.device_ring",
            "cuda_flashattention_torch.examples.device_ring"} <= set(mods)
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(any(n == 'jax' or n.startswith(('jax.', "
            "'cuda_flashattention_tpu')) for n in sys.modules))")
    proc = _python(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|cuda_flashattention_tpu)\b",
                         re.M)
    root = REPO / "cuda_flashattention_torch"
    for path in [*root.rglob("*.py"), REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


@pytest.mark.parametrize("entry", ["init_cache", "init_caches",
                                   "init_paged_cache", "resolve_device"])
def test_entry_points_raise_without_a_card(entry):
    """`device=None` means the card: with none present the allocating
    entry points raise and do not land on the CPU."""
    import torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops import common, kv_cache, paged
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tfm.TransformerConfig(vocab_size=8, d_model=16, n_layers=1,
                                n_heads=1, n_kv_heads=1, d_head=16, d_ff=16)
    calls = dict(
        init_cache=lambda **kw: kv_cache.init_cache(1, 1, 4, 16, **kw),
        init_caches=lambda **kw: tfm.init_caches(cfg, 1, 4, **kw),
        init_paged_cache=lambda **kw: paged.init_paged_cache(
            2, 1, 2, 1, 4, 16, **kw),
        resolve_device=lambda **kw: common.resolve_device(**kw))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    if entry != "resolve_device":
        out = calls[entry](device="cpu")
        first = out[0] if isinstance(out, tuple) else out
        pool = getattr(first, "k", None)
        pool = first.k_pages if pool is None else pool
        assert pool.device.type == "cpu"


def test_chip_smoke_fails_without_a_card():
    proc = _python(["chip_smoke.py"], cwd=REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _python(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_build_command_targets_sm90a():
    """One nvcc per source (started together), then one link."""
    srcs = _build.sources()
    assert {s.name for s in srcs} == {
        "flash_fwd.cu", "flash_fwd_bound.cu", "flash_fwd_kmajor.cu",
        "flash_bwd.cu", "flash_bwd_kv.cu", "decode.cu", "paged.cu", "fa1.cu",
        "device_ring.cu"}
    # the bodies the sources share are hashed, not compiled
    assert {"decode_body.cuh", "flash_fwd_bound_sm90.cuh"} <= {
        h.name for h in _build.headers()}
    arch = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    for src in srcs:
        cmd = _build.compile_command("nvcc", src, Path("x.o"))
        assert cmd[:3] == arch and cmd[-1] == str(src)
        for flag in ("-std=c++17", "-O3", "-fPIC", "-c"):
            assert flag in cmd
    link = _build.link_command("nvcc", [Path("a.o"), Path("b.o")],
                               Path("out.so"))
    assert link[:3] == arch and "-shared" in link
    assert {"a.o", "b.o", "out.so"} <= {Path(c).name for c in link}


@pytest.mark.parametrize("name", [
    "Mesh", "make_mesh", "sequence_mesh", "shard_on_axis",
    "initialize_distributed", "ring_attention", "ring_decode",
    "ring_decode_local", "combine_partials", "ulysses_attention",
    "gpipe_spmd", "stack_stage_params", "stage_param_sharding",
    "device_ring_matmul", "ring_matmul_plain", "pipeline_forward",
    "param_shardings", "shard_param", "layer_weights"])
def test_distributed_layer_is_exported(name):
    """The names of the JAX package's parallel layer, at the top of the
    port, each from the module named after its JAX counterpart."""
    import cuda_flashattention_torch as cfa
    assert name in cfa.__all__ and callable(getattr(cfa, name))
    home = getattr(cfa, name).__module__
    assert home.startswith(("cuda_flashattention_torch.parallel.",
                            "cuda_flashattention_torch.models.transformer"))


@pytest.mark.parametrize("name", ["flash_fwd_bound.cu", "flash_fwd_kmajor.cu",
                                  "flash_fwd_bound_sm90.cuh", "flash_fwd.cu"])
def test_bound_forward_sources_are_hopper_kernels(name):
    """K1b and K5, and the body they share: each names the TPU kernel it
    replaces, and the products run on wgmma fed by TMA, not on wmma."""
    src = (_build.CSRC / name).read_text()
    assert "Replaces: cuda_flashattention_tpu/ops/flash_fwd.py::" in src
    assert "nvcuda" not in src and "wmma::" not in src
    if name.endswith(".cu"):
        assert _build.CSRC / name in _build.sources()
        assert '#include "flash_fwd_bound_sm90.cuh"' in src
    else:
        for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                       "setmaxnreg", "mbarrier.try_wait"):
            assert needle in src, needle


def test_online_forward_builds_no_bound_form():
    """flash_fwd.cu instantiates the online form (K1) only, on the shared
    Hopper body; the bound forms have entry points of their own."""
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    for needle in ("FORM", "kBound", "bound_step", "QQ", "store_rows<D>(",
                   "n_loose"):
        assert needle not in src, needle
    # the online step, and the epilogue without the loose-bound count
    assert "online_step<" in src and "store_rows<D, false>(" in src
    assert len(_build.SIGNATURES["cfa_flash_fwd"]) == 15
    assert len(_build.SIGNATURES["cfa_flash_fwd_bound"]) == 16
    assert len(_build.SIGNATURES["cfa_flash_fwd_kmajor"]) == 17


def test_fa1_source_is_a_hopper_kernel():
    """K8 names the TPU kernel it replaces and runs on the forward's wgmma
    + TMA body; no source includes the old wmma body."""
    src = (_build.CSRC / "fa1.cu").read_text()
    assert "Replaces: cuda_flashattention_tpu/ops/fa1.py::_fa1_kernel" in src
    assert "nvcuda" not in src and "wmma::" not in src
    assert '#include "flash_fwd_bound_sm90.cuh"' in src
    for needle in ("qk<D, false>", "pv<D>", "mbar_wait", "tma_load_4d"):
        assert needle in src, needle
    assert not (_build.CSRC / "flash_fwd_body.cuh").exists()
    assert len(_build.SIGNATURES["cfa_fa1"]) == 13


def test_key_parallel_backward_is_a_hopper_kernel():
    """K2 and K4 are one kernel on the forward's wgmma + TMA helpers, with
    its own arguments and its dQ added by TMA reduces; the wmma file keeps
    K3 alone."""
    src = (_build.CSRC / "flash_bwd_kv.cu").read_text()
    for tpu in ("_bwd_dkdv_kernel", "_bwd_fused_kernel"):
        assert tpu in src.split("Replaces:")[1][:200], tpu
    assert "nvcuda" not in src and "wmma::" not in src
    assert '#include "flash_fwd_bound_sm90.cuh"' in src
    for needle in ("struct BwdArgs", "qk_issue<D>", "pv_issue<D>",
                   "stmatrix", "cp.reduce.async.bulk.tensor", "setmaxnreg",
                   "extern \"C\" int cfa_flash_bwd_kv("):
        assert needle in src, needle
    wmma = (_build.CSRC / "flash_bwd.cu").read_text()
    assert "flash_bwd_q_kernel" in wmma and "cfa_flash_bwd_q(" in wmma
    assert "flash_bwd_kv_kernel" not in wmma
    assert "cfa_flash_bwd_kv" not in wmma
    assert len(_build.SIGNATURES["cfa_flash_bwd_kv"]) == 23


def test_device_ring_is_bound_with_its_signature():
    """K9's C entry points are declared for ctypes (a pointer passed
    without argtypes would be cut to 32 bits), and its source holds the
    kernel's own stores and system-scope flags."""
    assert len(_build.SIGNATURES["cfa_device_ring"]) == 13
    assert len(_build.SIGNATURES["cfa_enable_peer_access"]) == 2
    src = (_build.CSRC / "device_ring.cu").read_text()
    for needle in ("st.release.sys", "ld.acquire.sys",
                   "__threadfence_system", "cudaLaunchCooperativeKernel",
                   "__trap()", "wmma::mma_sync"):
        assert needle in src, needle


def test_build_dir_is_git_ignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert _build.BUILD_DIR.name + "/" in ignored


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
