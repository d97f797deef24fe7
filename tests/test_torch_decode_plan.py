"""The decode kernels' split of the context (K6, csrc/decode.cu, and K7,
csrc/paged.cu, over csrc/decode_body.cuh), on the CPU.

`split_size`, `decode_splits` and `warp_keys` (ops/decode.py) state the
host's rule for the split size and the kernels' partition of a walk over
[first, length): split s covers [s·C, (s+1)·C), key j of a split starting
at lo goes to warp (j − lo) mod 4. The partition must not depend on the
cache's capacity (a contiguous cache of max_n keys against pools of
page·max_pages), and the two walks must hand each warp the same keys in
the same order, which is what makes K7 bit-equal to K6. The splits' merge
(the last CTA of a row tile weighs the partials in split order) is held
here in fp32 against the unsplit plain version; the kernels themselves
are held to their plain versions on the card
(tests/test_torch_kernels_cuda.py)."""

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


@pytest.mark.parametrize("page", [1, 16, 128, 48])
@pytest.mark.parametrize("first,length", WALKS)
def test_both_walks_hand_each_warp_the_same_keys(first, length, page):
    for _, lo, hi in dec.decode_splits(first, length, 128, 16384):
        for warp in range(dec.DECODE_WARPS):
            want = dec.warp_keys(lo, hi, warp)
            assert want == [j for j in range(lo, hi)
                            if (j - lo) % dec.DECODE_WARPS == warp]
            assert dec.warp_keys(lo, hi, warp, page=page) == want


def test_host_rule_sizes_splits_from_the_shape_alone():
    """One rule for both kernels, from (B, Hkv, row tiles, d): the serving
    batch splits, a grid that fills the card (the paged prefix form's
    folded rows) does not, and a split reads the same bytes at d = 64."""
    assert dec.split_size(8, 4, 1, 128) == dec.SPLIT_KEYS
    assert dec.split_size(8, 4, 1, 64) == 2 * dec.SPLIT_KEYS
    assert dec.split_size(1, 1, 1, 128) == dec.SPLIT_KEYS
    # paged_prefix_attention: 16 heads x 512 rows over 4 KV heads
    tiles = cdiv(4 * 512, dec.tile_rows(4 * 512))
    assert dec.split_size(8, 4, tiles, 128) == dec.NO_SPLIT
    assert dec.split_size(8, 64, 1, 128) == dec.NO_SPLIT
    assert [dec.tile_rows(r) for r in (1, 2, 4, 5, 8, 16)] == [1, 4, 4, 8,
                                                              8, 8]


@pytest.mark.parametrize("rows,capacity,n", [(4, 640, 5), (4, 128, 0),
                                             (1, 16384, 128), (2048, 4224, 0),
                                             (3, 129, 2)])
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
