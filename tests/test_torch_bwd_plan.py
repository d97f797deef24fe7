"""The key-parallel backward's walk (K2 and K4, csrc/flash_bwd_kv.cu), on
the CPU: which Q tiles each 128-key tile visits and the order of the CTAs.

`_bwd_q_tiles` and `_bwd_cta_order` state what the kernel's `q_tiles` and
`cta_tile` compute. They are held against a dense visibility mask built
here (causal with kv_offset, window, ragged tails, Nq != Nk), and a walk
over only the visited tile pairs must give the plain backward's gradients.
The kernel itself is held to the plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from cuda_flashattention_torch.ops import flash_bwd as fb
from cuda_flashattention_torch.ops.common import cdiv
from cuda_flashattention_torch.ops.flash_fwd import (
    flash_attention_forward_plain)

BK, BQ = fb._BWD_BK, fb._BWD_BQ

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


@pytest.mark.parametrize("nq,nk,causal,window,kv_offset", CASES)
def test_walk_visits_exactly_the_tiles_with_a_visible_pair(
        nq, nk, causal, window, kv_offset):
    vis = _visible(nq, nk, causal, window, kv_offset)
    for kt in range(cdiv(nk, BK)):
        c0 = kt * BK
        first, last = fb._bwd_q_tiles(c0, nq, nk, causal, window, kv_offset)
        walked = set(range(first, last + 1))
        assert walked <= set(range(cdiv(nq, BQ)))
        seen = {qt for qt in range(cdiv(nq, BQ))
                if vis[qt * BQ:(qt + 1) * BQ, c0:c0 + BK].any()}
        assert walked == seen, (kt, first, last, sorted(seen))


@pytest.mark.parametrize("nk,h_kv,b", [(4096, 16, 1), (1000, 4, 2),
                                       (127, 2, 3), (129, 1, 1),
                                       (16384, 4, 1)])
def test_cta_order_is_every_tile_once_heaviest_first(nk, h_kv, b):
    order = fb._bwd_cta_order(nk, h_kv, b)
    assert sorted(order) == sorted(
        (kt, hk, bb) for kt in range(cdiv(nk, BK)) for hk in range(h_kv)
        for bb in range(b))
    kts = [kt for kt, _, _ in order]
    assert kts == sorted(kts)
    # under causal the walks only shorten along the order
    nq = nk
    work = [max(0, last - first + 1) for first, last in (
        fb._bwd_q_tiles(kt * BK, nq, nk, True, 0, 0) for kt in kts)]
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


@pytest.mark.parametrize("nq,nk,causal,window,kv_offset,seg", [
    (150, 300, True, 0, 100, False),
    (200, 129, True, 0, 0, True),
    (259, 259, True, 90, 0, False),
    (100, 260, True, 0, -20, False),
    (130, 257, False, 0, 0, True),
])
def test_walk_over_visited_pairs_gives_the_plain_gradients(
        nq, nk, causal, window, kv_offset, seg):
    """dQ, dK, dV summed over the walk's (key tile, Q tile) pairs only, in
    fp32, equal the dense plain backward: no pair the walk skips holds a
    visible entry."""
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
    for kt in range(cdiv(nk, BK)):
        c0, c1 = kt * BK, min(nk, kt * BK + BK)
        first, last = fb._bwd_q_tiles(c0, nq, nk, causal, window, kv_offset)
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
