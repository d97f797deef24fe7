"""The bound forward's host part, on the CPU: the K5 span and grid choice,
the score bound c that K1b and K5 are given, and at d = 256 which calls
convert one-byte K/V before their walk, the bytes of the copies, and what
the entry points are handed (the kernels' library replaced by a recorder).

`_kmajor_span` is pure Python; `_score_bound` is held against the formula
it replaced (fp32 copies of K and Q, squared, summed): each norm is now one
fp32-accumulating reduction in another summation order, so c moves by a
few fp32 ulps (2 measured), and it must stay at or above every score the
kernels compute, the fp8 → int8 re-grid included."""

import contextlib
import dataclasses
import math
import types

import pytest
import torch

from cuda_flashattention_torch.ops import common
from cuda_flashattention_torch.ops import flash_fwd as ff
from cuda_flashattention_torch.ops.common import cdiv
from cuda_flashattention_torch.ops.quant import quantize_kv

SMS = 132  # an H100's streaming multiprocessors
ULPS = 4


@pytest.mark.parametrize("b,h_kv,nk,d", [
    (8, 4, 3584, 128),    # the chunked-prefill prefix
    (8, 4, 1024, 128),    # the windowed prefix's slice
    (1, 16, 16384, 128),  # the one-rank N=16384 call
    (1, 4, 16384, 128),   # a Ulysses rank's heads
    (1, 1, 1, 64),
    (2, 2, 257, 64),
    (1, 8, 100000, 64),
])
def test_kmajor_span_covers_the_keys(b, h_kv, nk, d):
    span = ff._kmajor_span(b, h_kv, nk, d, SMS)
    tiles = cdiv(nk, 64)
    assert 1 <= span <= ff._KMAJOR_MAX_SPAN[d]
    assert cdiv(tiles, span) * span >= tiles
    grid = cdiv(tiles, span) * h_kv * b
    # two waves, or the most CTAs the keys allow
    assert grid >= 2 * SMS or span == 1
    # and no longer span would still give two waves
    if span < ff._KMAJOR_MAX_SPAN[d]:
        assert cdiv(tiles, span + 1) * h_kv * b < 2 * SMS


def test_kmajor_span_fills_two_waves_at_the_prefix():
    """Q-major gives the prefix 8 x 4 x 4 = 128 tiles, under one wave; the
    key split gives at least two."""
    span = ff._kmajor_span(8, 4, 3584, 128, SMS)
    assert span == ff._KMAJOR_MAX_SPAN[128]
    assert cdiv(cdiv(3584, 64), span) * 4 * 8 >= 2 * SMS


def _old_score_bound(q_hat, k, k_scale, factor=None, regrid=False):
    group = q_hat.shape[1] // k.shape[1]
    kf = k.float()
    k_norms = torch.sqrt((kf * kf).sum(-1))
    if k_scale is not None:
        ks = k_scale.float()
        k_norms = k_norms * ks
        if regrid:
            k_norms = k_norms + ks * (math.sqrt(k.shape[-1]) * 224.0 / 127.0)
    kmax = k_norms.amax(dim=-1, keepdim=True)
    if group > 1:
        kmax = kmax.repeat_interleave(group, dim=1)
    qf = q_hat.float()
    qn = torch.sqrt((qf * qf).sum(-1))
    if factor is not None:
        qn = qn * factor
    return qn * kmax


def _ulps(a, ref):
    ulp = (torch.nextafter(ref, torch.full_like(ref, math.inf)) - ref).abs()
    return ((a - ref).abs() / ulp).max().item()


@pytest.mark.parametrize("qtype,quantize_q", [
    (None, False), ("int8", False), ("fp8", False), ("mixed", False),
    ("int8", True), ("fp8", True), ("mixed", True)])
@pytest.mark.parametrize("aligned", [False, True])
def test_score_bound_matches_the_old_formula(qtype, quantize_q, aligned):
    """c within a few ulps of the old formula and never below a score the
    kernels compute; `aligned` puts every key on its query's direction,
    where the bound is tight."""
    gen = torch.Generator().manual_seed(3)
    b, h, h_kv, nq, nk, d = 2, 8, 2, 40, 130, 128
    q = ((torch.rand((b, h, nq, d), generator=gen) - 0.5) * 8).to(
        torch.bfloat16)
    k = ((torch.rand((b, h_kv, nk, d), generator=gen) - 0.5) * 4).to(
        torch.bfloat16)
    if aligned:
        k = (q[:, ::h // h_kv, :1].float().expand(b, h_kv, nk, d) * 0.5 * (
            1 + torch.rand((b, h_kv, nk, 1), generator=gen))).to(
                torch.bfloat16)
    scales = {}
    kq = k
    if qtype is not None:
        kv = quantize_kv(k, k, qtype)
        kq, scales = kv.k_q, dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
    plan = ff._plan(q, kq, kq, None, False, 0, 0, None, scales.get("k_scale"),
                    scales.get("v_scale"), None, None, "bound", quantize_q)
    ks = scales.get("k_scale")
    group = h // h_kv
    if plan.qq:
        q8, factor, row_factor = ff._quantize_q(q, plan)
        c = ff._score_bound(q8, kq, ks, factor=factor, regrid=plan.regrid)
        c_old = _old_score_bound(q8, kq, ks, factor=factor,
                                 regrid=plan.regrid)
        kf = kq.float()
        if plan.regrid:
            kf = torch.clamp(torch.round(kf * (127.0 / 448.0)), -127, 127)
        rows = ks.float().repeat_interleave(group, dim=1) * row_factor
        s = torch.einsum("bhqd,bhkd->bhqk", q8.float(),
                         kf.repeat_interleave(group, dim=1))
        s = s * rows[:, :, None, :]
    else:
        q_hat = ff._prescale_q(q, plan.scale)
        c = ff._score_bound(q_hat, kq, ks)
        c_old = _old_score_bound(q_hat, kq, ks)
        s = torch.einsum("bhqd,bhkd->bhqk", q_hat.float(),
                         kq.float().repeat_interleave(group, dim=1))
        if ks is not None:
            s = s * ks.float().repeat_interleave(group, dim=1)[:, :, None]
    assert c.dtype == torch.float32 and c.shape == (b, h, nq)
    assert _ulps(c, c_old) <= ULPS
    assert bool((s.amax(dim=-1) <= c).all())


# ---------------------------------------------------------------------------
# One-byte K/V converted before the walk, and K5's Q-major walk at d = 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,q_f32,quantized,converted", [
    (256, False, True, True),     # a 2-byte (or quantize_q's int8) Q
    (256, True, True, False),     # the fp32-Q build converts in the walk
    (256, False, False, False),   # bf16 K/V: nothing to convert
    (128, False, True, False),    # d <= 128: converted in the walk
    (64, False, True, False)])
def test_which_calls_convert_kv(d, q_f32, quantized, converted):
    assert common.kv_converted(d, q_f32, quantized) is converted


@pytest.mark.parametrize("d,q_f32,q_walk", [
    (256, False, True), (256, True, False), (128, False, False),
    (64, False, False)])
def test_which_kmajor_builds_take_the_q_major_walk(d, q_f32, q_walk):
    assert common.kmajor_q_walk(d, q_f32) is q_walk


# (B, Hkv, cached tokens, d): the Gemma-width prefix, the same cache at
# 4096 and 16384 tokens
GEMMA_CACHES = [(8, 4, 3584, 256), (8, 4, 4096, 256), (8, 4, 16384, 256)]


@pytest.mark.parametrize("b,h_kv,nk,d", GEMMA_CACHES)
@pytest.mark.parametrize("qq,k_int8,k_per,v_per", [
    (False, True, 2, 2),   # int8 or mixed K/V: both 2-byte copies
    (False, False, 2, 2),  # fp8
    (True, True, 0, 2),    # quantize_q over int8 keys: V only
    (True, False, 1, 2)])  # quantize_q over fp8 keys: K re-gridded to int8
def test_kv_copy_bytes(b, h_kv, nk, d, qq, k_int8, k_per, v_per):
    """The scratch a converted call allocates: bytes per code of each copy
    (PERF.md states them at the Gemma-width prefix, 4096 and 16384 tokens:
    117,440,512 / 134,217,728 / 536,870,912 bytes for both 2-byte
    copies)."""
    n = b * h_kv * nk * d
    assert common.kv_copy_bytes(b, h_kv, nk, d, qq=qq, k_int8=k_int8) == (
        k_per * n, v_per * n)
    if not qq:
        total = {3584: 117_440_512, 4096: 134_217_728, 16384: 536_870_912}
        assert 2 * k_per * n == total[nk]


class _Recorder:
    """The kernels' library as `_fwd_cuda` sees it: each entry point
    records its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("cfa_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def lib(monkeypatch):
    fake = _Recorder()
    monkeypatch.setattr(ff._build, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *_: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *_: types.SimpleNamespace(
                            multi_processor_count=SMS))
    return fake


# pointer slots of the two bound entry points (csrc/flash_fwd_bound.cu,
# csrc/flash_fwd_kmajor.cu)
BOUND_PTRS = dict(n_loose=7, kc=10, vc=11)
KMAJOR_PTRS = dict(l_acc=7, o_acc=8, n_loose=9, kc=12, vc=13)


@pytest.mark.parametrize("shape", [
    (8, 8, 4, 512, 3584, 256),    # the Gemma-width prefix
    (8, 8, 4, 512, 1024, 256),    # its windowed slice
    (2, 8, 4, 300, 2999, 256),    # a ragged GQA prefix
    (8, 16, 4, 512, 3584, 128),   # the 246M model's prefix
    (1, 16, 4, 4096, 4096, 128)])  # a ring step's block
@pytest.mark.parametrize("qtype,quantize_q", [
    (None, False), ("int8", False), ("fp8", False), ("mixed", False),
    ("int8", True), ("fp8", True)])
@pytest.mark.parametrize("kmajor", [False, True])
def test_the_entry_points_get_the_copies_and_the_walk(lib, shape, qtype,
                                                      quantize_q, kmajor):
    """What `_fwd_cuda` hands K1b and K5 on a bf16 Q: at d = 256 over
    one-byte K/V the scratch of the copies (one buffer, K's copy first,
    V's at K's bytes; none for K under quantize_q over int8 keys) and,
    for K5, no partial-sum scratch and a span of 1; elsewhere no copies,
    and K5 its zeroed partial sums."""
    b, h, h_kv, nq, nk, d = shape
    q = torch.zeros(b, h, nq, d, dtype=torch.bfloat16)
    kw = {}
    if qtype is None:
        k = v = torch.zeros(b, h_kv, nk, d, dtype=torch.bfloat16)
    else:
        kt, vt = {"int8": (torch.int8,) * 2,
                  "fp8": (torch.float8_e4m3fn,) * 2,
                  "mixed": (torch.int8, torch.float8_e4m3fn)}[qtype]
        k = torch.zeros(b, h_kv, nk, d, dtype=torch.int8).view(kt)
        v = torch.zeros(b, h_kv, nk, d, dtype=torch.int8).view(vt)
        kw = dict(k_scale=torch.ones(b, h_kv, nk),
                  v_scale=torch.ones(b, h_kv, nk))
    plan = ff._plan(q, k, v, None, False, 0, 0, None, kw.get("k_scale"),
                    kw.get("v_scale"), None, None, "bound_unchecked",
                    quantize_q)
    plan = dataclasses.replace(plan, use_kmajor=kmajor)
    ff._fwd_cuda(q, k, v, plan, torch.float32, kw.get("k_scale"),
                 kw.get("v_scale"), None, None)
    (name, args), = lib.calls
    assert name == ("cfa_flash_fwd_kmajor" if kmajor else
                    "cfa_flash_fwd_bound")
    ptrs = args[0]
    slot = KMAJOR_PTRS if kmajor else BOUND_PTRS
    converted = common.kv_converted(d, False, qtype is not None)
    k_bytes, v_bytes = common.kv_copy_bytes(
        b, h_kv, nk, d, qq=plan.qq, k_int8=k.dtype == torch.int8)
    kc, vc = ptrs[slot["kc"]], ptrs[slot["vc"]]
    if converted:
        assert vc is not None and v_bytes > 0
        if k_bytes:
            assert kc is not None and vc - kc == k_bytes
        else:
            assert kc is None and plan.qq and k.dtype == torch.int8
    else:
        assert kc is None and vc is None
    assert ptrs[slot["n_loose"]] is not None
    if kmajor:
        q_walk = common.kmajor_q_walk(d, False)
        assert q_walk == (d == 256)
        accs = (ptrs[slot["l_acc"]], ptrs[slot["o_acc"]])
        assert (accs == (None, None)) == q_walk
        span = args[-2]
        if q_walk:
            assert span == 1
        else:
            assert span == ff._kmajor_span(b, h_kv, nk, d, SMS)
