"""The port's tuner (`utils/autotune.py`) on the CPU, mirroring
tests/test_autotune.py: the timer (`time_fn`, which needs a card) is
replaced by a fake that runs the candidate on CPU tensors (the plain
versions, which validate the tile) and returns a time from a table, so
that the sweep, its cache (in the process and on disk, under a key with
the device's name and the kernel library's hash), its failure policy
and the command line are held here; the measurements are the card's
(chip_smoke.py, the `cuda` tests)."""

import json

import pytest
import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import BlockSizes, auto_block_sizes
from cuda_flashattention_torch.ops.decode import default_decode_block_k
from cuda_flashattention_torch.utils import autotune


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """The tuner with its disk cache in tmp_path, an empty process cache,
    and `time_fn` replaced: each call runs fn once and returns
    `times[candidate]` (the candidate found by `pick` in the call's
    arguments), 1.0 by default."""
    path = tmp_path / "cache.json"
    monkeypatch.setenv("CFA_AUTOTUNE_CACHE", str(path))
    autotune._MEM_CACHE.clear()
    state = dict(times={}, calls=[], pick=lambda a, kw: None, fail=set())

    def fake_time_fn(fn, *args, iters=20, warmup=3, before=None, **kw):
        cand = state["pick"](args, kw)
        state["calls"].append(cand)
        if cand in state["fail"]:
            raise RuntimeError(f"launch refused: {cand}")
        fn(*args, **kw)
        return state["times"].get(cand, 1.0)

    monkeypatch.setattr(autotune, "time_fn", fake_time_fn)
    state["path"] = path
    return state


def _pick_tile(args, kw):
    return kw["block_sizes"].block_k


def _pick_bwd(args, kw):
    bs = kw["block_sizes"]
    return bs.block_q_bwd, bs.block_k_bwd


def test_candidates_are_the_routed_kernels_built_tiles():
    assert autotune.candidate_blocks(4096, 4096, 128, causal=True) == [
        (128, 64), (128, 128)]
    # past 5120 causal rows "auto" takes K5: under a bf16 Q K1b's tiles
    # (its Q-major walk), under an fp32 Q its spans
    assert autotune.candidate_blocks(8192, 8192, 128, causal=True) == [
        (128, 64), (128, 128)]
    assert autotune.candidate_blocks(8192, 8192, 64, causal=True,
                                     dtype=torch.float32) == [
        (128, 64), (128, 128), (128, 192), (128, 256)]
    assert autotune.candidate_blocks(512, 3584, 128) == [(128, 64),
                                                         (128, 128)]
    assert autotune.candidate_blocks(4096, 4096, 128, causal=True,
                                     dtype=torch.float32) == [(128, 64)]
    assert autotune.candidate_blocks(4096, 4096, 64, mode="bwd") == [
        (64, 128)]


def test_candidates_fit_the_problem():
    assert autotune.candidate_blocks(40, 40, 64) == [(128, 64)]
    assert autotune.candidate_blocks(8192, 100, 64, causal=True) == [
        (128, 64), (128, 128)]
    assert autotune.decode_candidates(4352) == [128, 256, 512, 1024, 2048,
                                                4096, 4352]
    assert autotune.decode_candidates(100) == [100]
    assert autotune.page_candidates(4352) == [16, 32, 64, 128, 256, 512,
                                              1024]
    assert autotune.page_candidates(100) == [16, 32, 64]
    assert autotune.page_candidates(8) == [16]


def test_autotune_measures_and_caches(tuner, monkeypatch):
    tuner["pick"] = _pick_tile
    tuner["times"] = {64: 2.0, 128: 1.5}
    kw = dict(nq=80, nk=80, d=64, heads=2, causal=True, iters=1,
              device="cpu")
    bs = autotune.autotune_block_sizes(**kw)
    assert bs == BlockSizes(block_k=128)
    assert tuner["calls"] == [64, 128]
    disk = json.loads(tuner["path"].read_text())
    (key, value), = disk.items()
    assert value == {"block_q": 128, "block_k": 128, "block_q_bwd": 64,
                     "block_k_bwd": 128}
    # the key names the device and the kernel library's hash
    lib = _build._library_path(_build.sources()).stem.rsplit("_", 1)[-1]
    assert json.loads(key)[1:3] == ["cpu", lib]
    assert [c for c, _ in autotune.sweeps[key]] == [BlockSizes(),
                                                    BlockSizes(block_k=128)]
    # the second call measures nothing: the timer raises
    monkeypatch.setattr(autotune, "time_fn",
                        lambda *a, **k: pytest.fail("cache miss"))
    assert autotune.autotune_block_sizes(**kw) == bs
    autotune._MEM_CACHE.clear()  # and from the disk
    assert autotune.autotune_block_sizes(**kw) == bs


def test_autotune_skips_failing_candidate(tuner, capsys):
    """A candidate the card refuses is logged and no winner; the sweep is
    kept in the process and not written to disk."""
    tuner["pick"] = _pick_tile
    tuner["times"] = {64: 2.0, 128: 1.0}
    tuner["fail"] = {128}
    bs = autotune.autotune_block_sizes(nq=80, nk=80, d=64, heads=2,
                                       iters=1, device="cpu")
    assert bs == BlockSizes(block_k=64)
    assert autotune._MEM_CACHE
    assert not tuner["path"].exists()
    assert "launch refused: 128" in capsys.readouterr().err


def test_autotune_all_candidates_fail(tuner, capsys):
    """Every candidate failing gives `auto_block_sizes` and a warning,
    memoised in the process and kept off the disk."""
    tuner["pick"] = _pick_tile
    tuner["fail"] = {64, 128}
    kw = dict(nq=80, nk=80, d=64, heads=2, iters=1, device="cpu")
    bs = autotune.autotune_block_sizes(**kw)
    assert bs == auto_block_sizes(80, 80, 64)
    assert "every candidate failed" in capsys.readouterr().err
    assert not tuner["path"].exists()
    n = len(tuner["calls"])
    assert autotune.autotune_block_sizes(**kw) == bs
    assert len(tuner["calls"]) == n


def test_autotune_bwd_mode(tuner):
    tuner["pick"] = _pick_bwd
    bs = autotune.autotune_block_sizes(nq=80, nk=80, d=64, heads=2,
                                       causal=True, mode="bwd", iters=1,
                                       device="cpu")
    assert (bs.block_q_bwd, bs.block_k_bwd) == (64, 128)
    assert tuner["calls"] == [(64, 128)]
    with pytest.raises(ValueError, match="mode"):
        autotune.autotune_block_sizes(nq=8, nk=8, d=64, mode="decode",
                                      device="cpu")


def test_autotune_decode_block_k(tuner, monkeypatch):
    tuner["pick"] = lambda args, kw: kw["block_k"]
    tuner["times"] = {128: 3.0, 256: 1.0, 300: 2.0}
    kw = dict(ctx=300, heads=4, kv_heads=2, d=32, batch=2, iters=1,
              live=260, device="cpu")
    assert autotune.autotune_decode_block_k(**kw) == 256
    assert tuner["calls"] == [128, 256, 300]
    assert autotune.autotune_decode_block_k(qtype="int8", **kw) == 256
    monkeypatch.setattr(autotune, "time_fn",
                        lambda *a, **k: pytest.fail("cache miss"))
    assert autotune.autotune_decode_block_k(**kw) == 256


def test_autotune_decode_failing_candidates(tuner, capsys):
    """The block-size tuner's policy: a failure keeps the sweep off the
    disk, and an all-fail sweep gives `default_decode_block_k`."""
    tuner["pick"] = lambda args, kw: kw["block_k"]
    tuner["fail"] = {128, 256, 300}
    bk = autotune.autotune_decode_block_k(ctx=300, heads=4, kv_heads=2,
                                          d=32, batch=2, iters=1,
                                          device="cpu")
    assert bk == default_decode_block_k(
        torch.bfloat16, torch.bfloat16, torch.bfloat16, False, 0, False,
        300, batch=2, kv_heads=2, rows=2, d=32)
    assert not tuner["path"].exists()
    assert "every candidate failed" in capsys.readouterr().err


def test_autotune_page_size(tuner):
    tuner["pick"] = lambda args, kw: args[1].shape[2]  # the pool's page
    tuner["times"] = {16: 2.0, 32: 0.5, 64: 1.0}
    ps = autotune.autotune_page_size(ctx=100, heads=4, kv_heads=2, d=32,
                                     batch=2, iters=1, live=90, device="cpu")
    assert ps == 32 and tuner["calls"] == [16, 32, 64]
    assert json.loads(tuner["path"].read_text())
    tuner["fail"] = {16, 32, 64}
    autotune._MEM_CACHE.clear()
    tuner["path"].unlink()
    assert autotune.autotune_page_size(ctx=100, heads=4, kv_heads=2, d=32,
                                       batch=2, iters=1,
                                       device="cpu") == 64


def test_the_card_is_the_default_device(monkeypatch, tmp_path):
    """Without a card the tuner raises (it never times the CPU unasked)."""
    monkeypatch.setenv("CFA_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.autotune_block_sizes(nq=8, nk=8, d=64)


def test_cli_parses_the_jax_arguments(monkeypatch):
    opts = autotune.build_parser().parse_args(
        ["--mode", "bwd", "--seq", "4096", "--d", "64", "--heads", "8",
         "--batch", "2", "--causal", "--window", "512", "--iters", "3"])
    assert (opts.mode, opts.seq, opts.d, opts.heads, opts.batch, opts.causal,
            opts.window, opts.iters) == ("bwd", 4096, 64, 8, 2, True, 512, 3)
    with pytest.raises(SystemExit):
        autotune.build_parser().parse_args(["--mode", "tpu"])
    seen = {}
    monkeypatch.setattr(autotune, "autotune_decode_block_k",
                        lambda **kw: seen.update(kw) or 256)
    autotune.main(["--mode", "decode", "--seq", "4352", "--kv-heads", "4",
                   "--batch", "8"])
    assert (seen["ctx"], seen["kv_heads"], seen["batch"]) == (4352, 4, 8)


def test_candidates_at_d256_are_its_builds():
    """At d = 256 the forward's builds have one key tile (K5 a span of one
    tile): 64, or 32 for an fp32 Q over fp32 K/V; the backward's bf16
    build the pair (64, 64) and its fp32 build (32, 64); past 256 no build
    takes the call, so there is nothing to tune."""
    assert autotune.candidate_blocks(4096, 4096, 256, causal=True) == [
        (128, 64)]
    assert autotune.candidate_blocks(8192, 8192, 256, causal=True) == [
        (128, 64)]
    assert autotune.candidate_blocks(512, 3584, 256) == [(128, 64)]
    # a d between builds runs on the next one up
    assert autotune.candidate_blocks(512, 3584, 200) == [(128, 64)]
    assert autotune.candidate_blocks(4096, 4096, 256, mode="bwd") == [
        (64, 64)]
    assert autotune.candidate_blocks(4096, 4096, 256, mode="bwd",
                                     dtype=torch.float32) == [(32, 64)]
    assert autotune.candidate_blocks(1000, 1000, 200, mode="bwd",
                                     dtype=torch.float32) == [(32, 64)]
    with pytest.raises(NotImplementedError, match="K4 takes fp32"):
        autotune.candidate_blocks(4096, 4096, 300, mode="bwd",
                                  dtype=torch.float32)
    assert autotune.candidate_blocks(4096, 4096, 256, causal=True,
                                     dtype=torch.float32) == [(128, 32)]
    assert autotune.candidate_blocks(512, 3584, 200,
                                     dtype=torch.float32) == [(128, 32)]


def test_autotune_at_d256(tuner):
    """The sweep at d = 256 times its one built tile and keeps it, the
    backward's sweep its one built pair (64, 64), and over fp32 its fp32
    build's (32, 64); a request past 256 raises before any timing."""
    tuner["pick"] = _pick_tile
    bs = autotune.autotune_block_sizes(nq=80, nk=80, d=256, heads=2,
                                       causal=True, iters=1, device="cpu")
    assert bs == BlockSizes(block_k=64)
    assert tuner["calls"] == [64]
    tuner["pick"] = _pick_bwd
    bs = autotune.autotune_block_sizes(nq=80, nk=80, d=256, heads=2,
                                       causal=True, mode="bwd", iters=1,
                                       device="cpu")
    assert (bs.block_q_bwd, bs.block_k_bwd) == (64, 64)
    assert tuner["calls"] == [64, (64, 64)]
    bs = autotune.autotune_block_sizes(nq=80, nk=80, d=256, heads=2,
                                       mode="bwd", dtype=torch.float32,
                                       iters=1, device="cpu")
    assert (bs.block_q_bwd, bs.block_k_bwd) == (32, 64)
    assert tuner["calls"] == [64, (64, 64), (32, 64)]
    with pytest.raises(NotImplementedError):
        autotune.autotune_block_sizes(nq=80, nk=80, d=300, heads=2,
                                      mode="bwd", dtype=torch.float32,
                                      iters=1, device="cpu")
    assert tuner["calls"] == [64, (64, 64), (32, 64)]
