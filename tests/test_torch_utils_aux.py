"""The port's checkpoint, profiling, timing and monitor utilities on the
CPU: `utils/checkpoint.py` (round trip, restore onto `like`'s dtypes,
train-resume equality as tests/test_utils_aux.py checks the JAX one, the
structure and shape errors, `force=False`); `kernel_report` against the
JAX function on the same inputs (keys, values, printed line);
`trace` / `annotate` over CPU work; `device_peaks`, `memory_stats` and
`save_device_memory_profile` without a card; the monitor's parser on a
recorded `nvidia-smi` line and its no-card path."""

import json
import math
import os

import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.utils import profiling as jprof
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.ops.kv_cache import append, init_cache
from cuda_flashattention_torch.utils import checkpoint as ckpt
from cuda_flashattention_torch.utils import monitor
from cuda_flashattention_torch.utils import profiling as tprof
from cuda_flashattention_torch.utils import timing


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.device == b.device and torch.equal(
            a, b)
    return a == b


def test_checkpoint_roundtrip_onto_likes_dtypes(tmp_path):
    """Nested dicts, lists and tuples of tensors and plain values (a KV
    cache's fields, its length and a None scale among them) come back in
    `like`'s structure, each tensor in `like`'s dtype."""
    cache = init_cache(2, 2, 8, 4, device="cpu")
    append(cache, torch.ones(2, 2, 3, 4), torch.full((2, 2, 3, 4), 2.0))
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "layers": [{"b": torch.ones(2, dtype=torch.bfloat16)},
                       {"b": torch.zeros(2, dtype=torch.bfloat16)}],
            "cache": (cache.k, cache.v, cache.k_scale, cache.length),
            "lr": 0.5}
    path = ckpt.save(str(tmp_path / "step1"), tree)
    assert os.path.isabs(path) and os.path.exists(path)
    like = {"w": torch.zeros(3, 4), "layers": [{"b": torch.zeros(2)},
                                               {"b": torch.zeros(2)}],
            "cache": (torch.zeros_like(cache.k), torch.zeros_like(cache.v),
                      None, 0), "lr": 0.0}
    back = ckpt.restore(path, like)
    assert back["layers"][0]["b"].dtype == torch.float32  # like's dtype
    assert torch.equal(back["layers"][0]["b"], torch.ones(2))
    assert _same(back["w"], tree["w"]) and back["lr"] == 0.5
    k, v, ks, n = back["cache"]
    assert isinstance(back["cache"], tuple)
    assert _same(k, cache.k) and _same(v, cache.v) and ks is None and n == 3


def test_checkpoint_train_resume(tmp_path):
    """Save after two Adam steps, restore into a fresh model and
    optimizer, and take one more step on each: the losses and every
    parameter and gradient equal the uninterrupted run's."""
    cfg = ttf.TransformerConfig(vocab_size=31, d_model=32, n_layers=1,
                                n_heads=2, n_kv_heads=2, d_head=16, d_ff=64,
                                max_seq=16, dtype=torch.float32)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 31, (2, 16)).astype(np.int64))

    def fresh(seed):
        gen = torch.Generator().manual_seed(seed)
        model = ttf.Transformer(cfg, generator=gen)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        return model, opt, ttf.make_train_step(model, opt)

    model, opt, step = fresh(0)
    for _ in range(2):
        step(tokens)
    path = ckpt.save(str(tmp_path / "mid"),
                     {"model": model.state_dict(), "opt": opt.state_dict()})
    loss_a = step(tokens).item()

    model2, opt2, step2 = fresh(1)  # other weights; its state is built
    step2(tokens)
    state = ckpt.restore(path, {"model": model2.state_dict(),
                                "opt": opt2.state_dict()})
    model2.load_state_dict(state["model"])
    opt2.load_state_dict(state["opt"])
    loss_b = step2(tokens).item()
    assert loss_a == loss_b
    for (n, a), b in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(a.grad, b.grad), n


def test_checkpoint_structure_and_shape_mismatch(tmp_path):
    """A `like` with another structure or shapes raises ValueError naming
    the problem instead of mis-assigning tensors; force=False over an
    existing checkpoint raises and leaves it."""
    tree = {"a": torch.ones(2, 3), "b": torch.zeros(4)}
    path = ckpt.save(str(tmp_path / "x"), tree)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(path, {"a": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="leaf 0: saved shape"):
        ckpt.restore(path, {"a": torch.ones(3, 2), "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaf 1: saved Tensor"):
        ckpt.restore(path, {"a": torch.ones(2, 3), "b": 0})
    with pytest.raises(FileExistsError):
        ckpt.save(path, {"a": torch.zeros(1)}, force=False)
    out = ckpt.restore(path, {"a": torch.zeros(2, 3), "b": torch.ones(4)})
    assert (out["a"] == 1).all() and (out["b"] == 0).all()


def test_kernel_report_matches_jax(capsys):
    """The JAX function's keys and values on the same inputs (peaks NaN
    off a card, in both), and its printed line."""
    args = dict(name="toy", seconds=0.001, flops=1e9, bytes_moved=1e6)
    want = jprof.kernel_report(**args)
    line_j = capsys.readouterr().out
    got = tprof.kernel_report(**args)
    line_t = capsys.readouterr().out
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert (g == w) if isinstance(w, str) else (
            math.isnan(g) and math.isnan(w) or abs(g - w) <= 1e-12)
    assert line_t == line_j and "[kernel_report] toy" in line_t


def test_kernel_report_at_the_cards_peaks(monkeypatch):
    """On a card of the table the shares are of its published peaks."""
    monkeypatch.setattr(timing, "device_peaks", lambda device=None: {
        "device_kind": "NVIDIA H100 80GB HBM3", "peak_tflops": 989.0,
        "peak_tf32_tflops": 495.0, "peak_hbm_gbps": 3350.0})
    out = tprof.kernel_report("k1", seconds=1e-3, flops=989e9,
                              bytes_moved=3.35e9)
    assert out["frac_peak_flops"] == pytest.approx(1.0)
    assert out["frac_peak_bw"] == pytest.approx(1.0)


def test_trace_and_annotate_on_the_cpu(tmp_path):
    """`trace` writes a Chrome trace of CPU work holding the annotated
    region and the operators under it."""
    x = torch.ones(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("region_under_test"):
            y = (x @ x).sum()
    assert y.item() == 64.0 ** 3
    path = tmp_path / tprof.TRACE_FILE
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "region_under_test" in names and "aten::mm" in names
    assert any(e.name == "region_under_test" for e in prof.events())
    with tprof.annotate("no trace active"):  # free without a trace
        pass


def test_peaks_and_memory_without_a_card(monkeypatch):
    """Off a card: the JAX function's NaN peaks (device_kind "cpu"), no
    memory counters, and no memory profile; the table holds the H100's
    published rates."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    peaks = timing.device_peaks()
    assert peaks["device_kind"] == "cpu"
    assert all(math.isnan(peaks[k]) for k in
               ("peak_tflops", "peak_tf32_tflops", "peak_hbm_gbps"))
    assert timing.memory_stats() == {}
    with pytest.raises(RuntimeError, match="CUDA device"):
        tprof.save_device_memory_profile("unused.pickle")
    h100 = "NVIDIA H100 80GB HBM3"
    assert (timing.PEAK_TFLOPS[h100], timing.PEAK_TF32_TFLOPS[h100],
            timing.PEAK_HBM_GBPS[h100]) == (989.0, 495.0, 3350.0)


def test_monitor_parses_nvidia_smi():
    recorded = ("0, NVIDIA H100 80GB HBM3, 71.86 W, 700.00 W\n"
                "1, NVIDIA H100 80GB HBM3, 69.50 W, 500.00 W\n"
                "garbage line\n")
    assert monitor.parse_smi(recorded) == {
        0: ("NVIDIA H100 80GB HBM3", "71.86 W", "700.00 W"),
        1: ("NVIDIA H100 80GB HBM3", "69.50 W", "500.00 W")}
    assert monitor.parse_smi("") == {}


def test_monitor_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert monitor.poll_once() == []
    assert capsys.readouterr().out == ""
    stop = monitor.start_monitor(interval_s=0.01)
    stop()


def test_ptxas_report_parses_verbose_output():
    """`utils/ptxas_report.parse` on a recorded `-Xptxas -v` excerpt: each
    entry's registers, spills and stack frame (the build itself needs
    nvcc, so it runs on the card's machine)."""
    from cuda_flashattention_torch.utils import ptxas_report
    text = (
        "ptxas info    : Compiling entry function '_Z1fILi256EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1fILi256EEvv\n"
        "    8 bytes stack frame, 16 bytes spill stores, 24 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 2 barriers\n"
        "ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 40 registers\n")
    assert ptxas_report.parse(text) == {
        "_Z1fILi256EEvv": dict(regs=168, stack=8, spill_stores=16,
                               spill_loads=24),
        "_Z1gv": dict(regs=40, stack=0, spill_stores=0, spill_loads=0)}
    assert ptxas_report.demangle(["_Z1gv"], "/nonexistent/nvcc") in (
        ["_Z1gv"], ["g()"])


def test_dtype_times_needs_a_card(monkeypatch):
    """`utils/dtype_times.py` (bf16 against fp16 builds on the card)
    parses its rounds and raises without a card instead of timing the
    CPU; each of its rows names a kernel its profiler filter knows."""
    from cuda_flashattention_torch.utils import dtype_times
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        dtype_times.main(["--rounds", "1"])
    assert set(dtype_times._NAMES) == {"K1", "K1b", "K5", "K6", "K7", "K4",
                                       "K2", "K3", "K8", "K9"}
