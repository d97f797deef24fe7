"""Guards of the torch port: it imports no JAX, its smoke script refuses
to run without a card, and its kernels are built for Hopper (sm_90a)."""

import os
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


def test_import_leaves_jax_out():
    proc = _python(["-c", "import sys, cuda_flashattention_torch; "
                    "import cuda_flashattention_torch.models.convert; "
                    "print('jax' in sys.modules)"], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


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
    assert {s.name for s in srcs} >= {"flash_fwd.cu", "flash_bwd.cu",
                                      "decode.cu"}
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


def test_build_dir_is_git_ignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert _build.BUILD_DIR.name + "/" in ignored


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
