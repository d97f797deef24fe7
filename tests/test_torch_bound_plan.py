"""The bound forward's host part, on the CPU: the K5 span and grid choice,
and the score bound c that K1b and K5 are given.

`_kmajor_span` is pure Python; `_score_bound` is held against the formula
it replaced (fp32 copies of K and Q, squared, summed): each norm is now one
fp32-accumulating reduction in another summation order, so c moves by a
few fp32 ulps (2 measured), and it must stay at or above every score the
kernels compute, the fp8 → int8 re-grid included."""

import math

import pytest
import torch

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
