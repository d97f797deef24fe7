"""The backward's walks on the CPU: which Q tiles each 128-key tile of the
key-parallel kernel (K2 and K4, csrc/flash_bwd_kv.cu; 64-key tiles in its
d = 256 build) visits, which key tiles each 128-row query tile of the dQ
kernel (K3, csrc/flash_bwd.cu; 64-key tiles, 32-key in its fp32 and d =
256 builds) visits, and the order of their CTAs. The walk tests run at d
= 128 and d = 256, each at its build's tiles.

`_bwd_q_tiles` / `_bwd_cta_order` and `_dq_key_tiles` / `_dq_cta_order`
state what the kernels' `q_tiles` / `key_tiles` and `cta_tile` compute.
They are held against a dense visibility mask built here (causal with
kv_offset, window, ragged tails, Nq != Nk), and a walk over only the
visited tile pairs must give the plain backward's gradients. The kernels
themselves are held to the plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from cuda_flashattention_torch.ops import flash_bwd as fb
from cuda_flashattention_torch.ops.common import cdiv
from cuda_flashattention_torch.ops.flash_fwd import (
    flash_attention_forward_plain)

BK, BQ = fb._BWD_BK, fb._BWD_BQ
# the head dims whose builds walk different tiles: 128-key K2/K4 CTAs and
# 64-key K3 tiles at d = 128, 64-key and 32-key ones at d = 256
WALK_DIMS = [128, 256]

# (nq, nk, causal, window, kv_offset)
CASES = [
    (4096, 4096, True, 0, 0),        # the training shape
    (4096, 4096, False, 0, 0),       # a ring step's full block
    (4096, 4096, True, 1024, 0),     # the windowed model
    (1000, 1000, True, 0, 0),        # ragged
    (300, 400, True, 0, -20),        # empty rows, unseen keys
    (70, 260, True, 0, -20),
    (300, 1000, True, 200, 700),     # a windowed prefix with kv_offset
    (130, 500, True, 70, 370),
    (200, 200, True, 64, -70),
    (64, 300, True, 0, 100),         # kv_offset crossing a key tile
    (64, 300, True, 0, 127),
    (64, 300, True, 0, 128),
    (100, 127, True, 0, 0),          # Nk = BK - 1
    (100, 128, False, 0, 0),         # Nk = BK
    (200, 129, True, 0, 0),          # Nk = BK + 1
    (300, 259, True, 0, 0),          # Nk = 2·BK + 3
    (300, 259, True, 100, 0),
    (37, 53, True, 0, 16),
    (1, 500, True, 0, 499),          # one decode-like row
    (500, 20, True, 0, -600),        # no query sees any key
]


def _visible(nq, nk, causal, window, kv_offset):
    rows = np.arange(nq)[:, None] + kv_offset
    cols = np.arange(nk)[None, :]
    vis = np.ones((nq, nk), bool)
    if causal:
        vis &= cols <= rows
        if window:
            vis &= cols > rows - window
    return vis


@pytest.mark.parametrize("d", WALK_DIMS)
@pytest.mark.parametrize("nq,nk,causal,window,kv_offset", CASES)
def test_walk_visits_exactly_the_tiles_with_a_visible_pair(
        nq, nk, causal, window, kv_offset, d):
    bk = fb._bwd_key_tile(d)
    vis = _visible(nq, nk, causal, window, kv_offset)
    for kt in range(cdiv(nk, bk)):
        c0 = kt * bk
        first, last = fb._bwd_q_tiles(c0, nq, nk, causal, window, kv_offset,
                                      bk)
        walked = set(range(first, last + 1))
        assert walked <= set(range(cdiv(nq, BQ)))
        seen = {qt for qt in range(cdiv(nq, BQ))
                if vis[qt * BQ:(qt + 1) * BQ, c0:c0 + bk].any()}
        assert walked == seen, (kt, first, last, sorted(seen))


@pytest.mark.parametrize("d", WALK_DIMS)
@pytest.mark.parametrize("nk,h_kv,b", [(4096, 16, 1), (1000, 4, 2),
                                       (127, 2, 3), (129, 1, 1),
                                       (16384, 4, 1)])
def test_cta_order_is_every_tile_once_heaviest_first(nk, h_kv, b, d):
    bk = fb._bwd_key_tile(d)
    order = fb._bwd_cta_order(nk, h_kv, b, bk)
    assert sorted(order) == sorted(
        (kt, hk, bb) for kt in range(cdiv(nk, bk)) for hk in range(h_kv)
        for bb in range(b))
    kts = [kt for kt, _, _ in order]
    assert kts == sorted(kts)
    # under causal the walks only shorten along the order
    nq = nk
    work = [max(0, last - first + 1) for first, last in (
        fb._bwd_q_tiles(kt * bk, nq, nk, True, 0, 0, bk) for kt in kts)]
    assert work == sorted(work, reverse=True)


def test_training_shape_fills_the_card():
    """B=1 H=16 N=4096: 512 CTAs of 1 per SM on 132 SMs (3.9 waves); the
    first wave holds the longest walks, 64 down to 48 Q tiles."""
    order = fb._bwd_cta_order(4096, 16, 1)
    assert len(order) == 512
    first_wave = [fb._bwd_q_tiles(kt * BK, 4096, 4096, True, 0, 0)
                  for kt, _, _ in order[:132]]
    assert [last - first + 1 for first, last in first_wave[::16]] == [
        64, 62, 60, 58, 56, 54, 52, 50, 48]


def test_gemma_training_shape_fills_the_card():
    """The Gemma-width model's layer at d = 256 (B=1, 4 KV heads, N=4096):
    64-key CTAs, 256 of them at 1 per SM on 132 SMs (1.9 waves); the first
    wave holds key tiles 0 to 32, whose walks (per query head) run 64 down
    to 32 Q tiles."""
    bk = fb._bwd_key_tile(256)
    assert bk == 64
    order = fb._bwd_cta_order(4096, 4, 1, bk)
    assert len(order) == 256
    first_wave = [fb._bwd_q_tiles(kt * bk, 4096, 4096, True, 0, 0, bk)
                  for kt, _, _ in order[:132]]
    assert [last - first + 1 for first, last in first_wave[::4]] == list(
        range(64, 31, -1))


@pytest.mark.parametrize("d", WALK_DIMS)
@pytest.mark.parametrize("nq,nk,causal,window,kv_offset,seg", [
    (150, 300, True, 0, 100, False),
    (200, 129, True, 0, 0, True),
    (259, 259, True, 90, 0, False),
    (100, 260, True, 0, -20, False),
    (130, 257, False, 0, 0, True),
])
def test_walk_over_visited_pairs_gives_the_plain_gradients(
        nq, nk, causal, window, kv_offset, seg, d):
    """dQ, dK, dV summed over the walk's (key tile, Q tile) pairs only (the
    tiles of head dim d's build, the arithmetic at width 64), in fp32,
    equal the dense plain backward: no pair the walk skips holds a
    visible entry."""
    bk = fb._bwd_key_tile(d)
    rng = np.random.default_rng(nq + nk)
    b, h, h_kv, d = 1, 4, 2, 64
    mk = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
    q, do = mk(b, h, nq, d), mk(b, h, nq, d)
    k, v = mk(b, h_kv, nk, d), mk(b, h_kv, nk, d)
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    if seg:
        qs = torch.from_numpy(rng.integers(0, 3, (b, nq)).astype(np.int32))
        ks = torch.from_numpy(rng.integers(0, 3, (b, nk)).astype(np.int32))
        kw.update(q_segment_ids=qs.sort(-1).values,
                  kv_segment_ids=ks.sort(-1).values)
    o, lse = flash_attention_forward_plain(q, k, v, **kw)
    want = fb.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for kt in range(cdiv(nk, bk)):
        c0, c1 = kt * bk, min(nk, kt * bk + bk)
        first, last = fb._bwd_q_tiles(c0, nq, nk, causal, window, kv_offset,
                                      bk)
        for qt in range(first, last + 1):
            r0, r1 = qt * BQ, min(nq, qt * BQ + BQ)
            sub = dict(kw, kv_offset=kv_offset + r0 - c0)
            if seg:
                sub.update(q_segment_ids=kw["q_segment_ids"][:, r0:r1],
                           kv_segment_ids=kw["kv_segment_ids"][:, c0:c1])
            g = fb.flash_attention_backward_plain(
                q[:, :, r0:r1], k[:, :, c0:c1], v[:, :, c0:c1],
                o[:, :, r0:r1], lse[:, :, r0:r1], do[:, :, r0:r1], **sub)
            dq[:, :, r0:r1] += g[0]
            dk[:, :, c0:c1] += g[1]
            dv[:, :, c0:c1] += g[2]
    for got, w, name in zip((dq, dk, dv), want, ("dQ", "dK", "dV")):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{name}: {m}")


# K3: 128 query rows of packed heads per CTA, 64-key tiles (32 at d = 256)
DQ_BM, DQ_BN = fb._DQ_BM, fb._DQ_BN

DQ_CASES = CASES + [
    (300, 100, True, 50, 150),       # every window starts past the keys
    (200, 300, True, 30, 280),       # some do
    (63, 64, True, 0, 0), (64, 65, True, 0, 1), (65, 63, False, 0, 0),
    (127, 200, True, 0, 63), (129, 129, True, 64, 0),
]


@pytest.mark.parametrize("d", WALK_DIMS)
@pytest.mark.parametrize("r", [128, 64, 32])
@pytest.mark.parametrize("nq,nk,causal,window,kv_offset", DQ_CASES)
def test_dq_walk_visits_exactly_the_tiles_with_a_visible_pair(
        nq, nk, causal, window, kv_offset, r, d):
    bn = fb._dq_key_tile(d)
    vis = _visible(nq, nk, causal, window, kv_offset)
    for qt in range(cdiv(nq, r)):
        q0 = qt * r
        begin, end = fb._dq_key_tiles(q0, r, nq, nk, causal, window,
                                      kv_offset, bn=bn)
        walked = set(range(begin, end))
        assert walked <= set(range(cdiv(nk, bn)))
        seen = {kt for kt in range(cdiv(nk, bn))
                if vis[q0:q0 + r, kt * bn:(kt + 1) * bn].any()}
        assert walked == seen, (qt, begin, end, sorted(seen))


@pytest.mark.parametrize("h,h_kv,gp", [(16, 16, 1), (16, 4, 4), (8, 2, 4),
                                       (12, 4, 3), (40, 2, 10), (32, 1, 16),
                                       (64, 2, 16)])
def test_dq_packs_the_heads_of_a_group_as_k1(h, h_kv, gp):
    assert fb._dq_packing(h, h_kv) == (gp, DQ_BM // gp)


@pytest.mark.parametrize("d", WALK_DIMS)
@pytest.mark.parametrize("nq,h,h_kv,b", [(4096, 16, 16, 1), (1000, 16, 4, 2),
                                         (127, 4, 2, 3), (129, 12, 4, 1),
                                         (4096, 8, 4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_cta_order_is_every_tile_once_heaviest_first(nq, h, h_kv, b,
                                                        causal, d):
    bn = fb._dq_key_tile(d)
    gp, r = fb._dq_packing(h, h_kv)
    order = fb._dq_cta_order(nq, h, h_kv, b, causal)
    assert sorted(order) == sorted(
        (qt, hg, bb) for qt in range(cdiv(nq, r)) for hg in range(h // gp)
        for bb in range(b))
    if causal:
        # under causal the walks only shorten along the order
        work = [(lambda t: t[1] - t[0])(fb._dq_key_tiles(
            qt * r, r, nq, nq, True, 0, 0, bn=bn)) for qt, _, _ in order]
        assert work == sorted(work, reverse=True)
    else:  # the grid's own order: Q tiles fastest, then head groups
        assert order == [(qt, hg, bb) for bb in range(b)
                         for hg in range(h // gp) for qt in range(cdiv(nq, r))]


@pytest.mark.parametrize("d", WALK_DIMS)
@pytest.mark.parametrize("nq,nk,h,h_kv,causal,window,kv_offset,seg", [
    (150, 300, 4, 2, True, 0, 100, False),
    (200, 129, 4, 4, True, 0, 0, True),
    (259, 259, 4, 2, True, 90, 0, False),
    (100, 260, 4, 1, True, 0, -20, False),
    (130, 257, 4, 2, False, 0, 0, True),
    (65, 300, 4, 4, True, 40, 250, False),
])
def test_dq_walk_over_visited_pairs_gives_the_plain_dq(
        nq, nk, h, h_kv, causal, window, kv_offset, seg, d):
    """dQ summed over K3's (Q tile, key tile) pairs only (the tiles of
    head dim d's build, the arithmetic at width 64), in fp32, equals the
    dense plain backward's: no pair the walk skips holds a visible entry.
    Each CTA's packed heads share its positions and its walk."""
    bn = fb._dq_key_tile(d)
    rng = np.random.default_rng(nq + 3 * nk)
    b, d = 1, 64
    mk = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
    q, do = mk(b, h, nq, d), mk(b, h, nq, d)
    k, v = mk(b, h_kv, nk, d), mk(b, h_kv, nk, d)
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    if seg:
        qs = torch.from_numpy(rng.integers(0, 3, (b, nq)).astype(np.int32))
        ks = torch.from_numpy(rng.integers(0, 3, (b, nk)).astype(np.int32))
        kw.update(q_segment_ids=qs.sort(-1).values,
                  kv_segment_ids=ks.sort(-1).values)
    o, lse = flash_attention_forward_plain(q, k, v, **kw)
    want = fb.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)[0]
    _, r = fb._dq_packing(h, h_kv)
    dq = torch.zeros_like(q)
    for qt in range(cdiv(nq, r)):
        r0, r1 = qt * r, min(nq, qt * r + r)
        begin, end = fb._dq_key_tiles(r0, r, nq, nk, causal, window,
                                      kv_offset, bn=bn)
        for kt in range(begin, end):
            c0, c1 = kt * bn, min(nk, kt * bn + bn)
            sub = dict(kw, kv_offset=kv_offset + r0 - c0)
            if seg:
                sub.update(q_segment_ids=kw["q_segment_ids"][:, r0:r1],
                           kv_segment_ids=kw["kv_segment_ids"][:, c0:c1])
            dq[:, :, r0:r1] += fb.flash_attention_backward_plain(
                q[:, :, r0:r1], k[:, :, c0:c1], v[:, :, c0:c1],
                o[:, :, r0:r1], lse[:, :, r0:r1], do[:, :, r0:r1], **sub)[0]
    torch.testing.assert_close(dq, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r", [128, 32])
@pytest.mark.parametrize("nq,nk,causal,window,kv_offset", DQ_CASES + [
    (31, 33, True, 0, 0), (32, 32, True, 0, 0), (33, 95, True, 0, 62),
    (300, 100, True, 40, 0), (65, 31, False, 0, 0)])
def test_dq_walk_of_the_f32_build_visits_exactly_the_32_key_tiles(
        nq, nk, causal, window, kv_offset, r):
    """K3's fp32 build walks 32-key tiles (`_DQ_BN_F32`): the same rule at
    that width visits exactly the tiles with a visible pair."""
    bn = fb._DQ_BN_F32
    vis = _visible(nq, nk, causal, window, kv_offset)
    for qt in range(cdiv(nq, r)):
        q0 = qt * r
        begin, end = fb._dq_key_tiles(q0, r, nq, nk, causal, window,
                                      kv_offset, bn=bn)
        walked = set(range(begin, end))
        seen = {kt for kt in range(cdiv(nk, bn))
                if vis[q0:q0 + r, kt * bn:(kt + 1) * bn].any()}
        assert walked == seen, (qt, begin, end, sorted(seen))


@pytest.mark.parametrize("nq,nk,causal,window,kv_offset", CASES + [
    (31, 65, True, 0, 0), (32, 64, True, 0, 31), (33, 95, True, 20, 62)])
def test_walk_of_the_f32_wide_build_visits_exactly_the_32_row_tiles(
        nq, nk, causal, window, kv_offset):
    """K2 / K4's fp32 d = 256 build: 64-key CTAs streaming 32-row Q tiles
    (`_bwd_q_tile(256, f32=True)`); the walk visits exactly the tiles with
    a visible pair."""
    bk, bq = fb._bwd_key_tile(256), fb._bwd_q_tile(256, f32=True)
    assert (bk, bq) == (64, 32) and fb._bwd_q_tile(200, f32=True) == 32
    assert fb._bwd_q_tile(256) == fb._bwd_q_tile(128, f32=True) == 64
    vis = _visible(nq, nk, causal, window, kv_offset)
    for kt in range(cdiv(nk, bk)):
        c0 = kt * bk
        first, last = fb._bwd_q_tiles(c0, nq, nk, causal, window, kv_offset,
                                      bk, bq)
        walked = set(range(first, last + 1))
        seen = {qt for qt in range(cdiv(nq, bq))
                if vis[qt * bq:(qt + 1) * bq, c0:c0 + bk].any()}
        assert walked == seen, (kt, first, last, sorted(seen))


@pytest.mark.parametrize("h,h_kv", [(8, 4), (16, 4), (16, 16), (32, 1)])
@pytest.mark.parametrize("nq,nk,causal,window,kv_offset", DQ_CASES[::3] + [
    (15, 17, True, 0, 0), (16, 16, True, 0, 0), (17, 47, True, 5, 30)])
def test_dq_walk_of_the_f32_wide_build_visits_exactly_the_16_key_tiles(
        nq, nk, causal, window, kv_offset, h, h_kv):
    """K3's fp32 d = 256 build: 64-row CTAs of packed heads (R = 64 / Gp)
    over 16-key tiles; the walk visits exactly the tiles with a visible
    pair, and its CTAs cover every (Q tile, head group, batch) once,
    heaviest first under causal."""
    bn, bm = fb._dq_key_tile(256, f32=True), fb._dq_rows(256, f32=True)
    assert (bn, bm) == (16, 64) and fb._dq_rows(256) == 128
    gp, r = fb._dq_packing(h, h_kv, bm)
    assert r == 64 // gp
    vis = _visible(nq, nk, causal, window, kv_offset)
    for qt in range(cdiv(nq, r)):
        q0 = qt * r
        begin, end = fb._dq_key_tiles(q0, r, nq, nk, causal, window,
                                      kv_offset, bn=bn)
        walked = set(range(begin, end))
        seen = {kt for kt in range(cdiv(nk, bn))
                if vis[q0:q0 + r, kt * bn:(kt + 1) * bn].any()}
        assert walked == seen, (qt, begin, end, sorted(seen))
    order = fb._dq_cta_order(nq, h, h_kv, 2, causal, bm)
    assert sorted(order) == sorted(
        (qt, hg, bb) for qt in range(cdiv(nq, r)) for hg in range(h // gp)
        for bb in range(2))
    if causal and not window and kv_offset == 0 and nq == nk:
        work = [(lambda t: t[1] - t[0])(fb._dq_key_tiles(
            qt * r, r, nq, nk, True, 0, 0, bn=bn)) for qt, _, _ in order]
        assert work == sorted(work, reverse=True)
