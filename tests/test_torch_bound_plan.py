"""The bound forward's host part, on the CPU: the K5 span and grid choice,
which K5 calls take K1b's Q-major walk (the crossing rule on shapes), the
score bound c that K1b and K5 are given, and at d = 256 which calls
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
from cuda_flashattention_torch.ops.common import BlockSizes, cdiv
from cuda_flashattention_torch.ops.quant import quantize_kv

SMS = 132  # an H100's streaming multiprocessors
ULPS = 4


# (B, H, Hkv, Nq, Nk, d) of K5 calls that keep the key split: under a
# 2-byte Q over one-byte K/V where the Q-major grid is under three
# quarters of a wave, and under an fp32 Q
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,f32", [
    (1, 16, 4, 512, 16384, 128, False),  # one chunk over a long cache
    (2, 8, 8, 256, 16384, 128, False),
    (1, 16, 4, 512, 3584, 128, False),
    (8, 16, 4, 512, 3584, 128, True),    # the fp32 model's prefix read
    (8, 16, 4, 512, 1024, 128, True),    # its windowed slice
    (1, 16, 16, 4096, 4096, 128, True),
    (1, 4, 1, 40, 1, 64, False),
    (2, 4, 2, 100, 257, 64, False),
    (1, 8, 8, 64, 100000, 64, False),
])
def test_kmajor_span_covers_the_keys(b, h, h_kv, nq, nk, d, f32):
    assert not common.kmajor_q_walk(d, f32, b=b, h=h, h_kv=h_kv, nq=nq,
                                    sms=SMS, codes=True)
    span = ff._kmajor_span(b, h_kv, nk, d, SMS, f32)
    longest = (ff._KMAJOR_MAX_SPAN_F32 if f32 else ff._KMAJOR_MAX_SPAN)[d]
    tiles = cdiv(nk, 64)
    assert 1 <= span <= longest
    assert cdiv(tiles, span) * span >= tiles
    grid = cdiv(tiles, span) * h_kv * b
    # two waves, or the most CTAs the keys allow
    assert grid >= 2 * SMS or span == 1
    # and no longer span would still give two waves
    if span < longest:
        assert cdiv(tiles, span + 1) * h_kv * b < 2 * SMS


def test_kmajor_span_fills_two_waves_at_the_prefix():
    """The 246M prefix (B=8, H=16, Hkv=4, 512 rows) gives the Q-major walk
    8 x 4 x 16 = 512 packed tiles, 3.9 waves: K5 takes it under a 2-byte
    Q. One sequence's chunk over a 16384-token cache gives it 64, under
    half a wave: there the key split keeps a span that fills two."""
    assert common.q_major_grid(8, 16, 4, 512) == 512
    assert common.kmajor_q_walk(128, False, b=8, h=16, h_kv=4, nq=512,
                                sms=SMS, codes=True)
    assert common.q_major_grid(1, 16, 4, 512) == 64
    span = ff._kmajor_span(1, 4, 16384, 128, SMS)
    assert span == 3
    assert cdiv(cdiv(16384, 64), span) * 4 >= 2 * SMS
    # the fp32-Q prefix read keeps its span rule (the longest, exact K/V)
    assert ff._kmajor_span(8, 4, 3584, 128, SMS, True, True) == \
        ff._KMAJOR_MAX_SPAN_F32Q[128]


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
    (128, False, True, False),    # d <= 128: each tile converted in
    (64, False, True, False),     # the walk
    (128, True, True, False)])    # (an fp32 Q: the consumers)
def test_which_calls_convert_kv(d, q_f32, quantized, converted):
    """A pass of its own converts one-byte K/V before the walk only at d =
    256 under a 2-byte or int8 Q, whichever walk K5 then takes."""
    assert common.kv_converted(d, q_f32, quantized) is converted


# (B, H, Hkv, Nq, d, q_f32, one-byte K/V) -> whether K5 takes K1b's
# Q-major walk
@pytest.mark.parametrize("b,h,h_kv,nq,d,q_f32,codes,q_walk", [
    (8, 16, 4, 512, 128, False, True, True),    # the 246M prefix: 512 CTAs
    (8, 16, 4, 512, 128, False, False, True),
    (8, 16, 4, 512, 128, True, True, False),    # an fp32 Q keeps the split
    (1, 16, 4, 512, 128, False, True, False),   # one chunk over a cache: 64
    (2, 16, 4, 512, 128, False, True, True),    # 128: 3/4 of a wave
    (2, 16, 4, 512, 128, False, False, True),   # over 2-byte K/V: always
    (1, 16, 4, 512, 128, False, False, True),   # (one chunk: 64 CTAs)
    (1, 16, 16, 512, 128, False, False, True),
    (1, 16, 16, 512, 64, False, False, True),
    (1, 16, 4, 800, 128, False, True, True),    # 100 CTAs
    (1, 16, 4, 768, 128, False, True, False),   # 96
    (4, 16, 4, 512, 128, False, True, True),    # 256
    (4, 16, 4, 512, 128, False, False, True),   # over 2-byte K/V, a wave
    (1, 4, 1, 16384, 128, False, False, True),  # a Ulysses rank's heads
    (1, 8, 8, 8192, 128, False, False, True),   # a tp2·sp2 ring's block
    (1, 16, 16, 4000, 128, False, False, True),  # a ragged ring shard
    (1, 16, 16, 6144, 128, False, False, True),  # the long causal call
    (8, 8, 4, 512, 256, False, True, True),     # the Gemma prefix
    (1, 1, 1, 1, 256, False, True, True),       # d = 256: always
    (8, 8, 4, 512, 256, True, False, False),
    (8, 16, 4, 512, 64, False, True, True),
    (1, 4, 2, 100, 64, False, False, True),    # 2 CTAs, 2-byte K/V
    (1, 4, 2, 100, 64, False, True, False)])
def test_which_kmajor_builds_take_the_q_major_walk(b, h, h_kv, nq, d, q_f32,
                                                   codes, q_walk):
    assert common.kmajor_q_walk(d, q_f32, b=b, h=h, h_kv=h_kv, nq=nq,
                                sms=SMS, codes=codes) is q_walk
    if d < 256 and not q_f32:
        grid = common.q_major_grid(b, h, h_kv, nq)
        assert q_walk == (not codes
                          or grid >= common.KMAJOR_Q_WALK_MIN_WAVES * SMS)


@pytest.mark.parametrize("group,gp", [(1, 1), (2, 2), (4, 4), (8, 8),
                                      (16, 16), (32, 16), (6, 6), (24, 12),
                                      (7, 7), (17, 1)])
def test_packed_heads_mirror_the_kernels(group, gp):
    """`packed_heads` as csrc/flash_fwd_bound_sm90.cuh computes it: the
    largest divisor of the group up to 16."""
    assert common.packed_heads(group) == gp
    assert common.q_major_grid(1, group, 1, 128) == cdiv(
        128, 128 // gp) * (group // gp)


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
    (1, 16, 4, 4096, 4096, 128),  # a ring step's block
    (1, 16, 4, 512, 16384, 128),  # one chunk over a long cache
    (2, 8, 2, 300, 1000, 64)])    # a small GQA call
@pytest.mark.parametrize("qtype,quantize_q", [
    (None, False), ("int8", False), ("fp8", False), ("mixed", False),
    ("int8", True), ("fp8", True)])
@pytest.mark.parametrize("kmajor", [False, True])
@pytest.mark.parametrize("block_k", [None, 128])
def test_the_entry_points_get_the_copies_and_the_walk(lib, shape, qtype,
                                                      quantize_q, kmajor,
                                                      block_k):
    """What `_fwd_cuda` hands K1b and K5 on a bf16 Q: K5 goes to K1b's
    entry point over bf16 K/V, and over one-byte K/V wherever the Q-major
    grid fills the card (always at d = 256), counted as K5's, with K1b's
    key tile (`block_k` 128 over bf16 K/V at d <= 128, else 64) and no
    partial-sum scratch; elsewhere (one-byte K/V, whose one tile is 64
    keys) to its own with its zeroed partial sums and the rule's span. At d = 256 over one-byte K/V the scratch of the copies (one
    buffer, K's copy first, V's at K's bytes; none for K under quantize_q
    over int8 keys); none at d <= 128, where the walk's producer
    warpgroup converts."""
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
    plan = ff._plan(q, k, v, None, False, 0, 0,
                    None if block_k is None else BlockSizes(block_k=block_k),
                    kw.get("k_scale"), kw.get("v_scale"), None, None,
                    "bound_unchecked", quantize_q)
    plan = dataclasses.replace(plan, use_kmajor=kmajor)
    counts = dict(ff.flash_attention_forward.form_launches)
    key128 = dict(ff.flash_attention_forward.key128_launches)
    ff._fwd_cuda(q, k, v, plan, torch.float32, kw.get("k_scale"),
                 kw.get("v_scale"), None, None)
    (name, args), = lib.calls
    q_walk = common.kmajor_q_walk(d, False, b=b, h=h, h_kv=h_kv, nq=nq,
                                  sms=SMS, codes=qtype is not None)
    split = kmajor and not q_walk
    assert name == ("cfa_flash_fwd_kmajor" if split else
                    "cfa_flash_fwd_bound")
    grown = {f: ff.flash_attention_forward.form_launches[f] - counts[f]
             for f in counts}
    assert grown == dict(online=0, fallback=0, bound=int(not kmajor),
                         kmajor=int(kmajor))
    ptrs = args[0]
    slot = KMAJOR_PTRS if split else BOUND_PTRS
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
    wide = qtype is None and d < 256 and block_k == 128
    if split:
        accs = (ptrs[slot["l_acc"]], ptrs[slot["o_acc"]])
        assert None not in accs
        assert args[-2] == ff._kmajor_span(b, h_kv, nk, d, SMS)
    else:
        assert len(ptrs) == 12  # K1b's: no l_acc or o_acc
        assert args[-2] == (128 if wide else 64)
    grown128 = {f: ff.flash_attention_forward.key128_launches[f] - key128[f]
                for f in key128}
    assert grown128 == dict(online=0, fallback=0,
                            bound=int(wide and not kmajor),
                            kmajor=int(wide and kmajor and not split))
