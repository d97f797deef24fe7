"""The decode kernels' split of the context and their walk over it (K6,
csrc/decode.cu, and K7, csrc/paged.cu, over csrc/decode_body.cuh), on the
CPU.

`split_size`, `decode_splits`, `key_tile`, `tile_runs`, `slice_keys` and
`row_copy` (ops/decode.py) state the host's rule for the split size and
the kernels' partition of a walk over [first, length): split s covers
[s·C, (s+1)·C); a CTA walks its split in key tiles at multiples of T in
the key index, each copied into shared memory as one run of rows (the
contiguous cache) or one run per page it touches (the pools), key j of
the tile at t0 in slot j − t0 either way and whichever copy brings it;
P·V's key slices take the slots ≡ ks (mod `key_slices(d)`). The
partition must not depend on the cache's capacity (a contiguous cache of max_n keys against pools of page·max_pages), and
the two walks must put each key in the same slot of the same tile, which
is what makes K7 bit-equal to K6. The splits' merge (the last CTA of a row
tile weighs the partials in split order) is held here in fp32 against the
unsplit plain version; the kernels themselves are held to their plain
versions on the card (tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from cuda_flashattention_torch.ops import decode as dec
from cuda_flashattention_torch.ops.common import NEG_INF, cdiv
from cuda_flashattention_torch.ops.decode import decode_attention_plain

# (first, length)
WALKS = [(0, 0), (0, 1), (0, 127), (0, 128), (0, 129), (0, 640), (0, 4224),
         (5, 300), (127, 129), (128, 256), (4000, 4224), (600, 640),
         (639, 640), (300, 300)]


@pytest.mark.parametrize("split", [64, 128, 256])
@pytest.mark.parametrize("first,length", WALKS)
def test_partition_is_the_key_index_alone(first, length, split):
    """The live splits are the same for a contiguous cache of any
    capacity and for pools of 1-, 16- and 128-token pages; they tile
    [first, length) in order, each inside its [s·C, (s+1)·C)."""
    contiguous = [dec.decode_splits(first, length, split, cap)
                  for cap in (length, length + 5, 4224, 16384)]
    paged = [dec.decode_splits(first, length, split,
                               page * (cdiv(length, page) + 2))
             for page in (1, 16, 128)]
    want = contiguous[0]
    assert all(p == want for p in contiguous + paged)
    keys = [j for _, lo, hi in want for j in range(lo, hi)]
    assert keys == list(range(first, length))
    for s, lo, hi in want:
        assert s * split <= lo < hi <= (s + 1) * split


def _tile_keys(runs):
    return [j for j0, j1 in runs for j in range(j0, j1)]


@pytest.mark.parametrize("page", [1, 16, 128, 48])
@pytest.mark.parametrize("first,length", WALKS)
def test_both_walks_copy_each_key_into_the_same_slot(first, length, page):
    """Over every live split: the contiguous walk and the paged one visit
    the same key tiles (starts at multiples of T), copy the same keys into
    the same slots, in key order, each paged run inside one page; the
    tiles cover the split in order; P·V's key slices partition each
    tile's keys (the order in which the kernels add them)."""
    tile = dec.key_tile(128, 2)
    assert tile == 32
    for _, lo, hi in dec.decode_splits(first, length, 256, 16384):
        contiguous = dec.tile_runs(lo, hi, tile)
        paged = dec.tile_runs(lo, hi, tile, page=page)
        assert [t0 for t0, _ in contiguous] == [t0 for t0, _ in paged]
        keys = []
        for (t0, runs), (_, pruns) in zip(contiguous, paged):
            assert t0 % tile == 0 and len(runs) == 1
            want = _tile_keys(runs)
            assert want == list(range(max(lo, t0), min(hi, t0 + tile)))
            assert _tile_keys(pruns) == want
            for j0, j1 in pruns:
                assert j0 < j1 and j0 // page == (j1 - 1) // page
            n = dec.key_slices(128)
            assert n == 2 * dec.TILE_CONSUMERS // 128
            slices = [dec.slice_keys(want[0], want[-1] + 1, t0, 128, ks)
                      for ks in range(n)]
            assert sorted(j for sl in slices for j in sl) == want
            assert all((j - t0) % n == ks for ks in range(n)
                       for j in slices[ks])
            keys += want
        assert keys == list(range(lo, hi))


def test_host_rule_sizes_splits_from_the_shape_alone():
    """One rule for both kernels, from (B, Hkv, row tiles, d): the serving
    batch splits, a grid that fills the card (the paged prefix form's
    folded rows) does not, and a split reads the same bytes at d = 256 as
    at d = 128 (half the keys), with twice the keys at d <= 64."""
    assert dec.split_size(8, 4, 1, 128) == dec.SPLIT_KEYS
    assert dec.split_size(8, 4, 1, 256) == dec.SPLIT_KEYS // 2
    for d in (8, 16, 32, 64):
        assert dec.split_size(8, 4, 1, d) == 2 * dec.SPLIT_KEYS
    assert dec.split_size(1, 1, 1, 128) == dec.SPLIT_KEYS
    # a split is a whole number of the tile walk's tiles at the build widths
    for d, eb in ((64, 2), (128, 2), (256, 2), (128, 1), (256, 4), (16, 2)):
        assert dec.split_size(8, 4, 1, d) % dec.key_tile(d, eb) == 0
    # paged_prefix_attention: 16 heads x 512 rows over 4 KV heads
    tiles = cdiv(4 * 512, dec.tile_rows(4 * 512))
    assert dec.split_size(8, 4, tiles, 128) == dec.NO_SPLIT
    assert dec.split_size(8, 64, 1, 128) == dec.NO_SPLIT
    assert dec.split_size(8, 32, 1, 128) == dec.SPLIT_KEYS  # 256 CTAs
    assert [dec.tile_rows(r) for r in (1, 2, 4, 5, 8, 16)] == [1, 4, 4, 8,
                                                              8, 8]


@pytest.mark.parametrize("rows,capacity,n", [(4, 640, 3), (4, 256, 0),
                                             (1, 16384, 64), (2048, 4224, 0),
                                             (3, 1025, 5)])
def test_scratch_follows_the_grid(rows, capacity, n):
    """Partials for every (row tile, split, row), tickets per row tile;
    none when the grid has one split per tile."""
    b, h_kv, d = 8, 4, 128
    split, part, tickets = dec.split_scratch(b, h_kv, rows, d, capacity,
                                             "cpu")
    r = dec.tile_rows(rows)
    tiles = cdiv(rows, r)
    assert split == dec.split_size(b, h_kv, tiles, d)
    if n == 0:
        assert part is None and tickets is None
    else:
        assert cdiv(capacity, split) == n
        assert part.numel() == b * h_kv * tiles * n * r * (d + 2)
        assert part.dtype == torch.float32
        assert tickets.shape == (b * h_kv * tiles,)
        assert tickets.dtype == torch.int32


def _split_plain(q, k, v, lengths, split, window=0, windows=None):
    """decode_attention_plain over each split's keys, the partials merged
    in split order in fp32 with the kernels' weights: M = max of the
    splits' maxima, O = Σ l_s·e^(m_s − M)·o_s / Σ l_s·e^(m_s − M)."""
    b = q.shape[0]
    win = dec.effective_windows(b, window, windows, q.device)
    lens = lengths.long()
    first = (lens - (win.clamp(min=0) if win is not None else lens)).clamp(
        min=0)
    firsts = [max(0, int(f)) for f in first]
    n = cdiv(k.shape[2], split)
    parts = []
    for s in range(n):
        lo = torch.tensor([max(f, s * split) for f in firsts])
        hi = torch.tensor([min(int(n_), (s + 1) * split) for n_ in lens])
        o, lse = decode_attention_plain(q, k, v, hi, windows=(hi - lo).clamp(
            min=0))
        parts.append((o.float(), lse))
    m = torch.stack([lse for _, lse in parts]).amax(0)
    w = [torch.where(lse > NEG_INF * 0.5, torch.exp(lse - m),
                     torch.zeros(())) for _, lse in parts]
    den = sum(w)
    num = sum(wi[..., None] * o for wi, (o, _) in zip(w, parts))
    empty = den == 0
    o = torch.where(empty[..., None], torch.zeros(()),
                    num / torch.where(empty, torch.ones(()), den)[..., None])
    lse = torch.where(empty, torch.full((), NEG_INF),
                      m + torch.log(torch.where(empty, torch.ones(()), den)))
    return o, lse


@pytest.mark.parametrize("split", [64, 128, 256])
@pytest.mark.parametrize("kw", [
    dict(), dict(window=100), dict(window=129),
    dict(windows=[5, 300, 64, 1, 0, 129, 700, 128]),
    dict(window=70, windows=[5, 300, 64, 1, 0, 129, 700, 128]),
])
def test_split_merge_meets_the_unsplit_plain_version(split, kw):
    """Lengths 0, 1, C − 1, C, C + 1 and longer, windows that start
    inside a split: merged in split order, the splits give the unsplit
    result within 1e-5 in fp32."""
    rng = np.random.default_rng(split)
    b, h, h_kv, max_n, d = 8, 8, 2, 300, 64
    mk = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
    q = mk(b, h, d) * 4
    k, v = mk(b, h_kv, max_n, d), mk(b, h_kv, max_n, d)
    lengths = torch.tensor([0, 1, split - 1, split, split + 1, 300, 257, 77],
                           dtype=torch.int32).clamp(max=max_n)
    kw = dict(kw)
    if "windows" in kw:
        kw["windows"] = torch.tensor(kw["windows"], dtype=torch.int32)
    o, lse = _split_plain(q, k, v, lengths, split, **kw)
    o_ref, lse_ref = decode_attention_plain(q, k, v, lengths, **kw)
    torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    assert torch.all(o[0] == 0) and torch.all(lse[0] == NEG_INF)


@pytest.mark.parametrize("d,elem_bytes,tile", [
    (128, 2, 32), (256, 2, 16), (64, 2, 64), (32, 2, 128), (16, 2, 128),
    (8, 2, 128), (90, 2, 32), (200, 2, 16), (128, 1, 64), (256, 1, 32),
    (128, 4, 16), (256, 4, 8), (32, 4, 64), (1, 1, 128),
])
def test_key_tile_follows_the_build(d, elem_bytes, tile):
    """T: 128 keys while a row of the build D holds at most 64 bytes, else
    8 KB of K (`geom` in csrc/decode_body.cuh): a tile is at most 16 KB of
    K and V."""
    assert dec.key_tile(d, elem_bytes) == tile
    slot = {1: 16, 8: 16, 16: 16, 32: 32, 64: 64, 90: 128, 128: 128,
            200: 256, 256: 256}[d] * elem_bytes
    assert tile * slot <= dec.TILE_BYTES


@pytest.mark.parametrize("page", [16, 48, 100])
def test_a_tile_straddling_a_page_a_split_and_the_window(page):
    """Split size 100 (not a multiple of T = 64) and a window whose first
    key, 90, falls inside the tile [64, 128): split 0 holds keys [90, 100)
    of that tile, split 1 keys [100, 128) then the next tiles; a page
    boundary (at 96 or 100) cuts the paged walk's copy of the tile into
    runs that put every key in the contiguous walk's slot."""
    first, length, split = 90, 300, 100
    splits = dec.decode_splits(first, length, split, 400)
    assert splits == [(0, 90, 100), (1, 100, 200), (2, 200, 300)]
    t0, runs = dec.tile_runs(90, 100, 64, page=page)[0]
    assert t0 == 64 and _tile_keys(runs) == list(range(90, 100))
    t0, runs = dec.tile_runs(100, 200, 64, page=page)[0]
    assert t0 == 64 and _tile_keys(runs) == list(range(100, 128))
    whole = dec.tile_runs(90, 300, 64, page=page)
    assert [t for t, _ in whole] == [64, 128, 192, 256]
    cut = [r for t, runs in whole for r in runs if t == 64]
    if page < 128:
        # the tile [64, 128) spans a page boundary: two runs or more
        assert len(cut) >= 2 and cut[0][0] == 90
    for _, runs in whole:
        for j0, j1 in runs:
            assert j0 // page == (j1 - 1) // page


@pytest.mark.parametrize("dtype,d,gran", [
    (torch.bfloat16, 128, 16), (torch.bfloat16, 256, 16),
    (torch.bfloat16, 64, 16), (torch.int8, 128, 16),
    (torch.float8_e4m3fn, 256, 16), (torch.float32, 7, 4),
    (torch.bfloat16, 8, 16), (torch.int8, 8, 8),
    (torch.bfloat16, 90, 4), (torch.bfloat16, 100, 8),
    (torch.bfloat16, 7, 0), (torch.float16, 91, 0),
    (torch.int8, 90, 0), (torch.float8_e4m3fn, 6, 0),
])
def test_walk_rule_is_the_rows_bytes(dtype, d, gran):
    """One walk for every shape; how the producer warp copies the rows is
    the rows' bytes and the bases' alignment (`row_copy`, the kernels'
    `copy_granularity`): cp.async (TMA boxes at 16) of the largest of 16,
    8 and 4 bytes dividing both, every serving form at 16; shifted loads
    (0) where none does: an odd d over a 2-byte cache, d not a multiple
    of 4 over a one-byte one, and a cache view whose base is off 4
    bytes."""
    k = torch.zeros(2, 3, 5, d, dtype=dtype)
    assert dec.row_copy(d, k, k) == gran
    if k.element_size() < 4:
        flat = torch.zeros(k.numel() + 1, dtype=dtype)
        view = flat[1:].view(k.shape)
        assert dec.row_copy(d, view, k) == 0
        assert dec.row_copy(d, k, view) == 0
