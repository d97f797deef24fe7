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
    """One nvcc per source (started together), then one link: each
    wgmma source and its fp16 unit (`*_f16.cu`, the source included whole
    under CFA_F16), and the decode walks by q type (bf16, fp16, fp32),
    each in two units: the float and fp8 caches, and the int8-K ones
    (`*_i8.cu`, under CFA_DECODE_I8)."""
    srcs = _build.sources()
    wgmma = ("flash_fwd", "flash_fwd_bound", "flash_fwd_kmajor", "flash_bwd",
             "flash_bwd_kv", "fa1", "device_ring")
    assert {s.name for s in srcs} == {
        *(f"{n}{u}.cu" for n in wgmma for u in ("", "_f16")),
        *(f"{n}{u}{h}.cu" for n in ("decode", "paged")
          for u in ("", "_f16", "_f32") for h in ("", "_i8"))}
    for n in wgmma:
        unit = (_build.CSRC / f"{n}_f16.cu").read_text()
        assert "#define CFA_F16 1" in unit and f'#include "{n}.cu"' in unit
    for n in ("decode", "paged"):
        for u in ("", "_f16", "_f32"):
            unit = (_build.CSRC / f"{n}{u}_i8.cu").read_text()
            assert "#define CFA_DECODE_I8 1" in unit
            assert f'#include "{n}.cu"' in unit
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
    "param_shardings", "shard_param", "layer_weights",
    "ring_attention_local", "shard_model", "gather_model",
    "ShardedTransformer"])
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
    # each took the q type (q_f32) beside k_type and v_type, then K1 and
    # K1b the key tile (kn: 64, or the 128-key build)
    assert len(_build.SIGNATURES["cfa_flash_fwd"]) == 17
    assert len(_build.SIGNATURES["cfa_flash_fwd_bound"]) == 18
    assert len(_build.SIGNATURES["cfa_flash_fwd_kmajor"]) == 18


def test_fa1_source_is_a_hopper_kernel():
    """K8 names the TPU kernel it replaces and runs on the forward's wgmma
    + TMA body; no source includes the old wmma body."""
    src = (_build.CSRC / "fa1.cu").read_text()
    assert "Replaces: cuda_flashattention_tpu/ops/fa1.py::_fa1_kernel" in src
    assert "nvcuda" not in src and "wmma::" not in src
    assert '#include "flash_fwd_bound_sm90.cuh"' in src
    # its products and walk are the body's, in both builds (bf16, F32),
    # on its key tile (BN, or BN32 for the fp32 build at d = 256)
    for needle in ("qk<D, false, F32, false, KN>", "pv<D, F32, false, KN>",
                   "mbar_wait",
                   "tma_load_4d", "split_rows<D, 128>"):
        assert needle in src, needle
    assert not (_build.CSRC / "flash_fwd_body.cuh").exists()
    # the f32 flag joined it with K8's fp32 build
    assert len(_build.SIGNATURES["cfa_fa1"]) == 14


def test_key_parallel_backward_is_a_hopper_kernel():
    """K2 and K4 are one kernel on the forward's wgmma + TMA helpers, with
    its own arguments and its dQ added by TMA reduces; flash_bwd.cu keeps
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
    k3 = (_build.CSRC / "flash_bwd.cu").read_text()
    assert "flash_bwd_q_kernel" in k3 and "cfa_flash_bwd_q(" in k3
    assert "flash_bwd_kv_kernel" not in k3
    assert "cfa_flash_bwd_kv" not in k3
    assert len(_build.SIGNATURES["cfa_flash_bwd_kv"]) == 24


def test_dq_kernel_is_a_hopper_kernel():
    """K3 names the TPU kernel it replaces and is the forward's Q-major
    walk on its wgmma + TMA helpers, with its own arguments; no wmma is
    left in any source of the backward."""
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    assert "_bwd_dq_kernel" in src.split("Replaces:")[1][:200]
    assert '#include "flash_fwd_bound_sm90.cuh"' in src
    assert "nvcuda" not in src and "wmma::" not in src and "<mma.h>" not in src
    for needle in ("struct DqArgs", "qk_issue<D>(s_acc", "qk_issue<D>(dp_acc",
                   "pv_issue<D>(dq", "tma_load_4d", "mbar_wait",
                   "setmaxnreg", "extern \"C\" int cfa_flash_bwd_q("):
        assert needle in src, needle
    # the f32 flag joined it with K3's fp32 build
    assert len(_build.SIGNATURES["cfa_flash_bwd_q"]) == 22


def test_decode_walks_share_the_split_and_its_merge():
    """K6 and K7 take their split of the context, their one walk (a ring
    of stages filled by TMA, cp.async or element loads) and the splits'
    merge from the one body, and their wrappers the split size from the
    one host rule; each entry point takes the call's scratch."""
    body = (_build.CSRC / "decode_body.cuh").read_text()
    for needle in ("split_keys(", "prepare_split(", "atomicAdd(a.tickets",
                   "__ldcg(", "void copy_shifted(", "__funnelshift_r(",
                   "struct TileWalk", "cp.async.mbarrier.arrive.noinc",
                   "cp.async.bulk.tensor.4d", "inline bool encode_rows(",
                   "static __device__ __forceinline__ void merge(",
                   "inline int copy_granularity("):
        assert needle in body, needle
    for name in ("decode.cu", "paged.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "decode_body.cuh"' in src
        assert "split_keys(a, first, length, s, lo, hi" in src, name
        assert "prepare_split(&a, B, " in src and "allow_smem(" in src
        assert "Lane" not in src and "int walk" not in src, name
        assert "W::run(a, b, hk, tile, lo, hi" in src, name
        assert "W::copy_run(a, st, " in src and "W::boxes(&mk, &mv" in src
        assert "encode_rows(&mk, k, W::EK" in src, name
        assert "atomic" not in src, name
    import inspect
    from cuda_flashattention_torch.ops import decode, paged
    for fn in (decode._decode_cuda, paged._paged_cuda):
        src = inspect.getsource(fn)
        assert "split_scratch(" in src and "entry_point(" in src
    # part, tickets and the split size joined both C signatures, then the
    # q type (q_f32), then the pools' page count (it bounds K7's tensor
    # maps); every unit's entry point has its q type's signature
    assert len(_build.SIGNATURES["cfa_decode"]) == 25
    assert len(_build.SIGNATURES["cfa_paged_decode"]) == 28
    for name in ("cfa_decode", "cfa_paged_decode"):
        for unit in ("", "_f16", "_f32"):
            for half in ("", "_i8"):
                assert (_build.SIGNATURES[name + unit + half]
                        == _build.SIGNATURES[name])
    assert decode.entry_point("cfa_decode", "_f16", 1) == "cfa_decode_f16_i8"
    assert decode.entry_point("cfa_paged_decode", "", 2) == "cfa_paged_decode"


def test_device_ring_is_bound_with_its_signature():
    """K9's C entry points are declared for ctypes (a pointer passed
    without argtypes would be cut to 32 bits: the epoch, the scope and the
    common grid joined the launch's arguments), and its source holds the
    kernel's own bulk copies, wgmma products, and flags at both scopes;
    it uses no wmma and no thread fence on every thread."""
    # the f32 flag joined both with K9's fp32 build
    assert len(_build.SIGNATURES["cfa_device_ring"]) == 16
    assert len(_build.SIGNATURES["cfa_device_ring_resident"]) == 5
    assert len(_build.SIGNATURES["cfa_enable_peer_access"]) == 2
    src = (_build.CSRC / "device_ring.cu").read_text()
    assert "nvcuda" not in src and "wmma::" not in src and "<mma.h>" not in src
    assert "__threadfence_system" not in src
    assert '#include "flash_fwd_bound_sm90.cuh"' in src
    for needle in ("st.release.sys", "ld.acquire.sys", "st.release.gpu",
                   "ld.acquire.gpu", "template <int D, bool SYS, bool F32>",
                   "cp.async.bulk.shared::cluster.global.mbarrier",
                   "cp.async.bulk.global.shared::cta.bulk_group",
                   "cp.async.bulk.wait_group 0", "fence.proxy.async.global",
                   "wgmma.mma_async", "mbar_wait",
                   "cudaLaunchCooperativeKernel", "__trap()"):
        assert needle in src, needle


@pytest.mark.parametrize("name", ["as_is", "group1", "o_l2", "push_stores",
                                  "three_per_sm"])
def test_ring_variants_patch_the_kept_source(name):
    """K9's source ships one design, with no build switches; each variant
    that `utils/ring_variants.py` times is a text patch of a copy of it,
    and every text a patch needs is found exactly once."""
    from cuda_flashattention_torch.utils.bwd_variants import variant_source
    from cuda_flashattention_torch.utils.ring_variants import VARIANTS
    src = (_build.CSRC / "device_ring.cu").read_text()
    assert "#if" not in src and "CFA_RING" not in src
    assert sorted(VARIANTS) == sorted(
        ["as_is", "group1", "o_l2", "push_stores", "three_per_sm"])
    out = variant_source(src, name, VARIANTS)
    assert (out == src) == (name == "as_is")


@pytest.mark.parametrize("name", ["as_is", "red_v4", "no_reduce",
                                  "no_dq_add", "late_wait", "ascending",
                                  "stages3", "wide_v4", "wide_no_dq_add",
                                  "red_v4+stages3"])
def test_bwd_variants_patch_the_kept_source(name):
    """K2 / K4's source ships one design; each variant that
    `utils/bwd_variants.py` times (at d = 128, and `wide_*` at d = 256)
    is a text patch of a copy of it, and every text a patch needs is found
    exactly once."""
    from cuda_flashattention_torch.utils.bwd_variants import (
        DEFAULT, DEFAULT_WIDE, VARIANTS, variant_source)
    src = (_build.CSRC / "flash_bwd_kv.cu").read_text()
    assert set(DEFAULT + DEFAULT_WIDE) <= set(VARIANTS) | {"red_v4+stages3"}
    out = variant_source(src, name)
    assert (out == src) == (name == "as_is")


def test_build_dir_is_git_ignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert _build.BUILD_DIR.name + "/" in ignored


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_starts_the_longest_units_first():
    """At most one nvcc per CPU, the units over the decode body first
    (int8-K, then fp32-q, then the rest of them), then the others: every
    source once."""
    from cuda_flashattention_torch import _build
    srcs = _build.sources()
    order = [s.name for s in _build.build_order(srcs)]
    assert sorted(order) == sorted(s.name for s in srcs)
    decode = [n for n in order if n.startswith(("decode", "paged"))]
    assert order[:len(decode)] == decode and len(decode) == 12
    assert all(n.endswith("_i8.cu") for n in decode[:6])
    assert all("_f32" in n for n in decode[6:8])
    assert 1 <= _build.build_workers() <= (os.cpu_count() or 1)
    import sys
    import time
    sleep = [sys.executable, "-c", "import time; time.sleep(0.5)"]
    t0 = time.perf_counter()
    _build._run_all([sleep, sleep], workers=1)
    assert time.perf_counter() - t0 >= 0.9  # one after the other


def test_build_runs_the_commands_together_and_times_each(tmp_path):
    """`_build._run_all` starts every command at once and returns each
    one's seconds; a failing command raises with its output."""
    import sys
    import time

    from cuda_flashattention_torch import _build
    sleep = [sys.executable, "-c", "import time; time.sleep(0.5)"]
    t0 = time.perf_counter()
    secs = _build._run_all([sleep, sleep, sleep])
    assert len(secs) == 3 and all(0.4 < t < 5 for t in secs)
    assert time.perf_counter() - t0 < 1.4  # together, not one after another
    with pytest.raises(RuntimeError, match="boom"):
        _build._run_all([[sys.executable, "-c",
                          "import sys; print('boom'); sys.exit(3)"]])
