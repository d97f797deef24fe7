"""The torch port's paged serving (`ops/paged.py`) against the JAX
package's (Pallas kernel in interpret mode on the CPU) and against the
port's own contiguous decode.

`paged_decode_attention` runs over a shuffled page table whose entries
past each sequence's live pages are out of range (they must never be
dereferenced), with quantized pools, windows and `quantize_q`;
`paged_prefix_attention` folds a chunk into the rows; the lifecycle of
examples/06_paged_serving.py runs step by step on both sides (tables,
lengths, pools, outputs); the allocator's guards mirror
tests/test_paged.py. Gates on O and LSE: 1e-4 where the compute dtype is
fp32 and 5e-3 where it is bf16 (a bf16 q, or `quantize_q` on an int8-K
cache, which rounds P to bf16 whatever q's dtype)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops import paged as jpg
from cuda_flashattention_tpu.ops.quant import quantize_kv as jax_quantize_kv
from cuda_flashattention_torch.models.convert import paged_cache_from_numpy
from cuda_flashattention_torch.ops import paged as tpg
from cuda_flashattention_torch.ops.decode import decode_attention
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_torch.ops.quant import quantize_kv
from cuda_flashattention_torch.parallel.ring import combine_partials

GATES = {"float32": 1e-4, "bfloat16": 5e-3}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
GARBAGE_ID = 10 ** 6  # far outside any pool


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _paginate(arrays, lengths, page, max_pages, rng, fill):
    """Scatter the live prefix of contiguous [B,Hkv,N,...] arrays into
    shuffled page pools that share one table. Everything else (spare
    pages, the tail of each last live page) holds noise (`fill`-scaled
    for floating arrays, random codes for byte arrays).
    Returns (pools, table, valid_table): `table` holds GARBAGE_ID past
    each sequence's live pages, `valid_table` repeats a live id there
    (for the JAX side, whose index maps clamp but still read the
    entry)."""
    b, hkv = arrays[0].shape[:2]
    total = b * max_pages + 3
    order = rng.permutation(total)
    def noise(a):
        shape = (total, hkv, page, *a.shape[3:])
        if a.dtype == np.uint8:
            # any byte but the two e4m3 NaN codes, which the JAX kernel
            # would multiply by its zero probabilities
            return (rng.integers(0, 256, shape) & 0xFE).astype(np.uint8)
        return (fill * rng.uniform(-1, 1, shape)).astype(a.dtype)

    pools = [noise(a) for a in arrays]
    table = np.full((b, max_pages), GARBAGE_ID, np.int32)
    valid = np.zeros((b, max_pages), np.int32)
    slot = 0
    for i in range(b):
        live = -(-int(lengths[i]) // page)
        for p in range(live):
            pid = int(order[slot])
            slot += 1
            table[i, p] = pid
            lo, hi = p * page, min(int(lengths[i]), (p + 1) * page)
            for pool, a in zip(pools, arrays):
                pool[pid, :, :hi - lo] = a[i, :, lo:hi]
        valid[i] = np.where(np.arange(max_pages) < live, table[i],
                            table[i, 0] if live else 0)
    return pools, table, valid


def _err(a_jax, b_torch):
    return float(np.max(np.abs(np.asarray(a_jax, np.float32)
                               - b_torch.float().numpy())))


# (page, max_pages, lengths, dtype)
PAGED_CASES = [
    (16, 6, [64, 37], "float32"),
    (8, 9, [0, 61], "float32"),
    (4, 16, [64, 13], "bfloat16"),
    (2, 40, [1, 64], "float32"),
    (64, 2, [64, 65], "bfloat16"),
]


@pytest.mark.parametrize("page,max_pages,lengths,dtype", PAGED_CASES)
def test_paged_decode_matches_jax_and_contiguous(page, max_pages, lengths,
                                                 dtype):
    b, h, h_kv, n, d = 2, 4, 2, 80, 32
    q, k, v = (_uniform(1, (b, h, d)), _uniform(2, (b, h_kv, n, d)),
               _uniform(3, (b, h_kv, n, d)))
    (k_pool, v_pool), table, valid = _paginate(
        (k, v), lengths, page, max_pages, np.random.default_rng(7), 9.0)
    o_j, lse_j = jpg.paged_decode_attention(
        jnp.asarray(q, JAX_DT[dtype]), jnp.asarray(k_pool, JAX_DT[dtype]),
        jnp.asarray(v_pool, JAX_DT[dtype]), jnp.asarray(valid),
        jnp.asarray(lengths, jnp.int32))
    tq, tk, tv = (torch.from_numpy(a).to(TORCH_DT[dtype])
                  for a in (q, k_pool, v_pool))
    lens = torch.tensor(lengths, dtype=torch.int32)
    o_t, lse_t = tpg.paged_decode_attention(tq, tk, tv,
                                            torch.from_numpy(table), lens)
    assert o_t.dtype == TORCH_DT[dtype] and tuple(o_t.shape) == (b, h, d)
    assert _err(o_j, o_t) <= GATES[dtype]
    assert _err(lse_j, lse_t) <= GATES[dtype]
    # the same keys through the contiguous decode
    o_c, lse_c = decode_attention(
        tq, *(torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (k, v)), lens)
    assert torch.max(torch.abs(o_t.float() - o_c.float())) <= 1e-6
    assert torch.max(torch.abs(lse_t - lse_c)) <= 1e-6
    empty = [i for i, ln in enumerate(lengths) if ln == 0]
    assert torch.all(o_t[empty] == 0) and torch.all(lse_t[empty] == -1e30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize_q", [False, True])
@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_paged_quantized_matches_jax(qtype, quantize_q, dtype):
    b, h, h_kv, n, d, page, max_pages = 2, 8, 2, 64, 32, 16, 5
    lengths = [64, 53]
    q, k, v = (_uniform(4, (b, h, d)), _uniform(5, (b, h_kv, n, d)),
               _uniform(6, (b, h_kv, n, d)))
    kv = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qtype)
    kv_j = jax_quantize_kv(jnp.asarray(k), jnp.asarray(v), qtype)
    arrays = (kv.k_q.view(torch.uint8).numpy(),
              kv.v_q.view(torch.uint8).numpy(),
              kv.k_scale.numpy(), kv.v_scale.numpy())
    (k_pool, v_pool, ks_pool, vs_pool), table, valid = _paginate(
        arrays, lengths, page, max_pages, np.random.default_rng(8), 100.0)
    o_j, lse_j = jpg.paged_decode_attention(
        jnp.asarray(q, JAX_DT[dtype]),
        jnp.asarray(k_pool.view(np.asarray(kv_j.k_q).dtype)),
        jnp.asarray(v_pool.view(np.asarray(kv_j.v_q).dtype)),
        jnp.asarray(valid), jnp.asarray(lengths, jnp.int32),
        k_scale=jnp.asarray(ks_pool), v_scale=jnp.asarray(vs_pool),
        quantize_q=quantize_q)
    o_t, lse_t = tpg.paged_decode_attention(
        torch.from_numpy(q).to(TORCH_DT[dtype]),
        torch.from_numpy(k_pool).view(kv.k_q.dtype),
        torch.from_numpy(v_pool).view(kv.v_q.dtype),
        torch.from_numpy(table), torch.tensor(lengths, dtype=torch.int32),
        k_scale=torch.from_numpy(ks_pool), v_scale=torch.from_numpy(vs_pool),
        quantize_q=quantize_q)
    # under quantize_q an int8-K cache computes in bf16 whatever q's
    # dtype: P is rounded to bf16 against the running maximum, page by
    # page there and once over all keys in the port's plain version
    bf16_compute = dtype == "bfloat16" or (quantize_q and qtype != "fp8")
    gate = GATES["bfloat16" if bf16_compute else "float32"]
    assert _err(o_j, o_t) <= gate and _err(lse_j, lse_t) <= gate


@pytest.mark.parametrize("kw", [
    dict(window=32),
    dict(windows=[20, 64]),
    dict(window=32, windows=[50, 5]),
    dict(window=7),
])
def test_paged_window_matches_jax(kw):
    b, h, h_kv, n, d, page, max_pages = 2, 4, 2, 64, 32, 16, 6
    lengths = [64, 53]
    q, k, v = (_uniform(7, (b, h, d)), _uniform(8, (b, h_kv, n, d)),
               _uniform(9, (b, h_kv, n, d)))
    (k_pool, v_pool), table, valid = _paginate(
        (k, v), lengths, page, max_pages, np.random.default_rng(9), 9.0)
    jkw = {n_: (jnp.asarray(x, jnp.int32) if n_ == "windows" else x)
           for n_, x in kw.items()}
    tkw = {n_: (torch.tensor(x, dtype=torch.int32) if n_ == "windows" else x)
           for n_, x in kw.items()}
    o_j, lse_j = jpg.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(valid), jnp.asarray(lengths, jnp.int32), **jkw)
    lens = torch.tensor(lengths, dtype=torch.int32)
    o_t, lse_t = tpg.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(table), lens, **tkw)
    assert _err(o_j, o_t) <= 1e-4 and _err(lse_j, lse_t) <= 1e-4
    o_c, _ = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), lens, **tkw)
    assert torch.max(torch.abs(o_t - o_c)) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefix_attention_matches_jax(dtype):
    """A chunk of C queries folded into the rows: group·C = 2·5 rows per
    KV head, more than one 8-row tile."""
    b, h, h_kv, c, d, page, max_pages = 2, 4, 2, 5, 32, 8, 4
    lengths = [24, 16]
    q = _uniform(10, (b, h, c, d))
    k, v = _uniform(11, (b, h_kv, 32, d)), _uniform(12, (b, h_kv, 32, d))
    (k_pool, v_pool), table, valid = _paginate(
        (k, v), lengths, page, max_pages, np.random.default_rng(10), 9.0)

    def cache(mod, conv, tab):
        return mod.PagedKVCache(conv(k_pool), conv(v_pool), None, None,
                                tab, conv(np.asarray(lengths, np.int32)))

    jc = cache(jpg, lambda a: jnp.asarray(
        a, JAX_DT[dtype] if a.dtype == np.float32 else None),
        jnp.asarray(valid))
    tc = cache(tpg, lambda a: torch.from_numpy(a).to(
        TORCH_DT[dtype] if a.dtype == np.float32 else torch.int32),
        torch.from_numpy(table))
    o_j, lse_j = jpg.paged_prefix_attention(jnp.asarray(q, JAX_DT[dtype]), jc)
    o_t, lse_t = tpg.paged_prefix_attention(
        torch.from_numpy(q).to(TORCH_DT[dtype]), tc)
    assert tuple(o_t.shape) == (b, h, c, d) and tuple(lse_t.shape) == (b, h, c)
    assert _err(o_j, o_t) <= GATES[dtype]
    assert _err(lse_j, lse_t) <= GATES[dtype]


def _same_state(jc, tc, live_only=True):
    """Tables, lengths and pools agree. The tables are compared on each
    sequence's assigned slots, the pools on every page."""
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    ps = tc.page_size
    for i, n in enumerate(tc.lengths.tolist()):
        live = -(-n // ps)
        np.testing.assert_array_equal(np.asarray(jc.page_table)[i, :live],
                                      tc.page_table[i, :live].numpy())
    for a, b_ in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages)):
        np.testing.assert_array_equal(
            np.asarray(a).view(np.uint8) if b_.element_size() == 1
            else np.asarray(a),
            b_.view(torch.uint8).numpy() if b_.element_size() == 1
            else b_.numpy())
    if tc.quantized:
        for a, b_ in ((jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)):
            np.testing.assert_allclose(b_.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("qtype", [None, "int8", "mixed"])
def test_serving_lifecycle_matches_jax_step_by_step(qtype):
    """examples/06_paged_serving.py on both sides: a page-aligned
    prefill chunk, ten decode steps checked against the JAX cache and a
    contiguous shadow, then retirement and page reuse."""
    b, hkv, h, page, maxp, d = 2, 2, 4, 16, 6, 32
    rng = np.random.default_rng(11)
    jc = jpg.init_paged_cache(n_pages=16, batch=b, max_pages=maxp,
                              heads_kv=hkv, page_size=page, d=d,
                              qtype=qtype, dtype=jnp.float32)
    tc = tpg.init_paged_cache(n_pages=16, batch=b, max_pages=maxp,
                              heads_kv=hkv, page_size=page, d=d,
                              qtype=qtype, dtype=torch.float32, device="cpu")
    ja, ta = jpg.PageAllocator(16), tpg.PageAllocator(16)

    k_prompt = _uniform(20, (b, hkv, 32, d))
    v_prompt = _uniform(21, (b, hkv, 32, d))
    for i in range(b):
        jc = ja.reserve_for(jc, i, 32)
        assert ta.reserve_for(tc, i, 32) is tc  # in place
    jc = jpg.paged_bulk_append(jc, jnp.asarray(k_prompt),
                               jnp.asarray(v_prompt))
    tpg.paged_bulk_append(tc, torch.from_numpy(k_prompt),
                          torch.from_numpy(v_prompt))
    _same_state(jc, tc)

    # the contiguous shadow is the same storage type as the pools
    from cuda_flashattention_torch.ops import kv_cache as tkv
    shadow = tkv.init_cache(b, hkv, 96, d, qtype=qtype, dtype=torch.float32,
                            device="cpu")
    tkv.append(shadow, torch.from_numpy(k_prompt),
               torch.from_numpy(v_prompt))
    gate = 1e-4
    for t in range(10):
        k_new = rng.uniform(-1, 1, (b, hkv, d)).astype(np.float32)
        v_new = rng.uniform(-1, 1, (b, hkv, d)).astype(np.float32)
        for i in range(b):
            jc = ja.reserve_for(jc, i, 1)
            ta.reserve_for(tc, i, 1)
        jc = jpg.paged_append(jc, jnp.asarray(k_new), jnp.asarray(v_new))
        tpg.paged_append(tc, torch.from_numpy(k_new),
                         torch.from_numpy(v_new))
        tkv.append(shadow, torch.from_numpy(k_new)[:, :, None],
                   torch.from_numpy(v_new)[:, :, None])
        q = rng.uniform(-1, 1, (b, h, d)).astype(np.float32)
        o_j, lse_j = jpg.paged_decode_step(jnp.asarray(q), jc)
        o_t, lse_t = tpg.paged_decode_step(torch.from_numpy(q), tc)
        assert _err(o_j, o_t) <= gate and _err(lse_j, lse_t) <= gate
        o_s, lse_s = tkv.decode_step(torch.from_numpy(q), shadow)
        assert torch.max(torch.abs(o_t - o_s)) <= 1e-6
        assert torch.max(torch.abs(lse_t - lse_s)) <= 1e-6
    _same_state(jc, tc)
    assert ta.free == ja.free

    # retire sequence 0, reuse its pages
    free_before = len(ta.free)
    jc = ja.release_sequence(jc, 0)
    ta.release_sequence(tc, 0)
    assert len(ta.free) - free_before == 3  # ceil(42 / 16)
    assert tc.lengths.tolist() == [0, 42] and ta.free == ja.free
    jc = ja.reserve_for(jc, 0, 16)
    ta.reserve_for(tc, 0, 16)
    assert len(ta.free) == free_before + 2 and ta.free == ja.free
    np.testing.assert_array_equal(np.asarray(jc.page_table)[0, :1],
                                  tc.page_table[0, :1].numpy())


def test_quantized_lifecycle_against_the_oracle():
    """A mixed pool comes up int8-K / fp8-V and appends quantize each
    array onto its own grid: against the fp32 oracle within the JAX
    suite's 2e-2 (a V pool written through the wrong grid shows ≥ 6e-2)."""
    from cuda_flashattention_torch.ops.naive import naive_attention
    b, hkv, h, page, maxp, d = 1, 2, 4, 8, 3, 16
    cache = tpg.init_paged_cache(n_pages=6, batch=b, max_pages=maxp,
                                 heads_kv=hkv, page_size=page, d=d,
                                 qtype="mixed", device="cpu")
    assert cache.k_pages.dtype == torch.int8
    assert cache.v_pages.dtype == torch.float8_e4m3fn
    alloc = tpg.PageAllocator(6)
    rng = np.random.default_rng(6)
    ks, vs = [], []
    for _ in range(11):
        k_new = torch.from_numpy(_uniform(rng.integers(1 << 30), (b, hkv, d)))
        v_new = torch.from_numpy(_uniform(rng.integers(1 << 30), (b, hkv, d)))
        alloc.reserve_for(cache, 0, 1)
        tpg.paged_append(cache, k_new, v_new)
        ks.append(k_new)
        vs.append(v_new)
    q = torch.from_numpy(_uniform(3, (b, h, d)))
    o, _ = tpg.paged_decode_step(q, cache)
    kf = torch.stack(ks, 2).repeat_interleave(h // hkv, 1)
    vf = torch.stack(vs, 2).repeat_interleave(h // hkv, 1)
    ref, _ = naive_attention(q[:, :, None], kf, vf)
    assert torch.max(torch.abs(o - ref[:, :, 0])) <= 2e-2


def test_paged_prefill_flow_matches_contiguous_causal():
    """Page-aligned bulk appends of prompt chunks; each chunk attends the
    paged prefix and itself causally, merged in log space: equal to
    causal attention over the whole prompt."""
    b, hkv, h, page, maxp, d, chunk = 2, 2, 4, 16, 4, 16, 32
    n = 2 * chunk
    q_all, k_all, v_all = (torch.from_numpy(_uniform(s, shape)) for s, shape
                           in ((30, (b, h, n, d)), (31, (b, hkv, n, d)),
                               (32, (b, hkv, n, d))))
    cache = tpg.init_paged_cache(n_pages=12, batch=b, max_pages=maxp,
                                 heads_kv=hkv, page_size=page, d=d,
                                 dtype=torch.float32, device="cpu")
    alloc = tpg.PageAllocator(12)
    outs = []
    for s in range(0, n, chunk):
        qc, kc, vc = (x[:, :, s:s + chunk] for x in (q_all, k_all, v_all))
        o_new, lse_new = flash_attention_forward(qc, kc, vc, causal=True,
                                                 out_dtype=torch.float32)
        if s > 0:
            o_old, lse_old = tpg.paged_prefix_attention(qc, cache)
            o_new, _ = combine_partials(o_old.float(), lse_old, o_new,
                                        lse_new)
        outs.append(o_new)
        for i in range(b):
            alloc.reserve_for(cache, i, chunk)
        tpg.paged_bulk_append(cache, kc, vc)
    o_ref, _ = flash_attention_forward(q_all, k_all, v_all, causal=True,
                                       out_dtype=torch.float32)
    assert torch.max(torch.abs(torch.cat(outs, 2) - o_ref)) <= 1e-4


def test_allocator_capacity_and_leak_guard():
    b, hkv, page, maxp, d = 1, 1, 4, 2, 8  # capacity: 8 tokens
    cache = tpg.init_paged_cache(n_pages=8, batch=b, max_pages=maxp,
                                 heads_kv=hkv, page_size=page, d=d,
                                 dtype=torch.float32, device="cpu")
    alloc = tpg.PageAllocator(8)
    zero = torch.zeros(b, hkv, d)
    for _ in range(3):
        alloc.reserve_for(cache, 0, 1)
        tpg.paged_append(cache, zero, zero)
    free0 = len(alloc.free)
    alloc.reserve_for(cache, 0, 2)  # crosses into page 1
    assert len(alloc.free) == free0 - 1
    tpg.paged_append(cache, zero, zero)  # only 1 of the 2
    alloc.reserve_for(cache, 0, 1)  # must reuse slot 1
    assert len(alloc.free) == free0 - 1, "page leaked on re-reserve"
    for _ in range(4):
        alloc.reserve_for(cache, 0, 1)
        tpg.paged_append(cache, zero, zero)
    assert int(cache.lengths[0]) == 8
    table_before = cache.page_table.clone()
    with pytest.raises(ValueError, match="capacity"):
        alloc.reserve_for(cache, 0, 1)
    assert torch.equal(cache.page_table, table_before)
    n_free_before = len(alloc.free)
    alloc.release_sequence(cache, 0)
    assert len(alloc.free) == n_free_before + 2


def test_allocator_pool_exhaustion_no_leak():
    cache = tpg.init_paged_cache(n_pages=2, batch=1, max_pages=8, heads_kv=1,
                                 page_size=2, d=8, dtype=torch.float32,
                                 device="cpu")
    alloc = tpg.PageAllocator(2)
    n_free = len(alloc.free)
    with pytest.raises(RuntimeError, match="exhausted"):
        alloc.reserve_for(cache, 0, 6)  # needs 3 pages, the pool has 2
    assert len(alloc.free) == n_free, "pages leaked by a failed reserve"
    with pytest.raises(RuntimeError, match="exhausted"):
        tpg.PageAllocator(0).alloc()


def test_release_and_reuse_hands_back_the_same_pages():
    cache = tpg.init_paged_cache(n_pages=4, batch=2, max_pages=2, heads_kv=1,
                                 page_size=2, d=8, dtype=torch.float32,
                                 device="cpu")
    alloc = tpg.PageAllocator(4)
    alloc.reserve_for(cache, 0, 4)
    alloc.reserve_for(cache, 1, 3)
    assert alloc.free == []
    held = cache.page_table[0].tolist()
    alloc.release_sequence(cache, 0)
    assert sorted(alloc.free) == sorted(held)
    alloc.reserve_for(cache, 0, 3)
    assert sorted(cache.page_table[0].tolist()) == sorted(held)


def test_bulk_append_alignment_guard():
    b, hkv, page, d = 1, 1, 4, 8
    cache = tpg.init_paged_cache(n_pages=8, batch=b, max_pages=4,
                                 heads_kv=hkv, page_size=page, d=d,
                                 dtype=torch.float32, device="cpu")
    alloc = tpg.PageAllocator(8)
    alloc.reserve_for(cache, 0, 1)
    tpg.paged_append(cache, torch.zeros(b, hkv, d), torch.zeros(b, hkv, d))
    chunk = torch.zeros(b, hkv, page, d)
    with pytest.raises(ValueError, match="page-aligned"):
        tpg.paged_bulk_append(cache, chunk, chunk)
    assert cache.lengths.tolist() == [1]


def test_paged_cache_carried_across_from_numpy():
    jc = jpg.init_paged_cache(n_pages=6, batch=2, max_pages=3, heads_kv=2,
                              page_size=4, d=16, qtype="fp8")
    ja = jpg.PageAllocator(6)
    for i, n in enumerate((4, 8)):
        jc = ja.reserve_for(jc, i, n)
    jc = jpg.paged_bulk_append(jc, jnp.asarray(_uniform(1, (2, 2, 4, 16))),
                               jnp.asarray(_uniform(2, (2, 2, 4, 16))))
    tc = paged_cache_from_numpy(
        np.asarray(jc.k_pages).view(np.uint8),
        np.asarray(jc.v_pages).view(np.uint8), np.asarray(jc.k_scale),
        np.asarray(jc.v_scale), np.asarray(jc.page_table),
        np.asarray(jc.lengths), device="cpu")
    assert tc.k_pages.dtype == torch.float8_e4m3fn and tc.quantized
    assert tc.page_table.dtype == tc.lengths.dtype == torch.int32
    q = _uniform(3, (2, 4, 16))
    o_j, _ = jpg.paged_decode_step(jnp.asarray(q), jc)
    o_t, _ = tpg.paged_decode_step(torch.from_numpy(q), tc)
    assert _err(o_j, o_t) <= 1e-4


def test_shape_errors_and_no_plain_fallback_off_the_cpu():
    q = torch.zeros(1, 4, 16)
    pool = torch.zeros(3, 2, 4, 16)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="scale pool shape"):
        tpg.paged_decode_attention(q, pool, pool, table, lens,
                                   k_scale=torch.ones(3, 2),
                                   v_scale=torch.ones(3, 2, 4))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tpg.paged_decode_attention(torch.zeros(1, 3, 16), pool, pool, table,
                                   lens)
    meta = [x.to("meta") for x in (q, pool, pool, table, lens)]
    with pytest.raises(ValueError, match="unsupported device"):
        tpg.paged_decode_attention(*meta)
    before = tpg.paged_decode_attention.launches
    tpg.paged_decode_attention(q, pool, pool, table, lens)
    assert tpg.paged_decode_attention.launches == before  # CPU: no kernel


@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("d", [16, 32])
def test_paged_f32_narrow_heads_match_jax(d, qtype):
    """`paged_decode_attention` on an fp32 q over fp32 or quantized pools
    of 16-token pages at d = 16 and 32, against the JAX function (1e-4:
    the compute dtype is fp32) and the port's contiguous decode on the
    same keys (1e-6)."""
    b, h, h_kv, n, page, max_pages = 2, 4, 2, 64, 16, 5
    lengths = [64, 37]
    q, k, v = (_uniform(40 + d, (b, h, d)), _uniform(41, (b, h_kv, n, d)),
               _uniform(42, (b, h_kv, n, d)))
    lens = torch.tensor(lengths, dtype=torch.int32)
    rng = np.random.default_rng(9)
    if qtype is None:
        (k_pool, v_pool), table, valid = _paginate(
            (k, v), lengths, page, max_pages, rng, 9.0)
        jargs, tkw, jkw = (jnp.asarray(k_pool), jnp.asarray(v_pool)), {}, {}
        tpools = (torch.from_numpy(k_pool), torch.from_numpy(v_pool))
        contiguous = (torch.from_numpy(k), torch.from_numpy(v))
    else:
        kv = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qtype)
        kv_j = jax_quantize_kv(jnp.asarray(k), jnp.asarray(v), qtype)
        arrays = (kv.k_q.view(torch.uint8).numpy(),
                  kv.v_q.view(torch.uint8).numpy(),
                  kv.k_scale.numpy(), kv.v_scale.numpy())
        (k_pool, v_pool, ks_pool, vs_pool), table, valid = _paginate(
            arrays, lengths, page, max_pages, rng, 100.0)
        jargs = (jnp.asarray(k_pool.view(np.asarray(kv_j.k_q).dtype)),
                 jnp.asarray(v_pool.view(np.asarray(kv_j.v_q).dtype)))
        jkw = dict(k_scale=jnp.asarray(ks_pool), v_scale=jnp.asarray(vs_pool))
        tpools = (torch.from_numpy(k_pool).view(kv.k_q.dtype),
                  torch.from_numpy(v_pool).view(kv.v_q.dtype))
        tkw = dict(k_scale=torch.from_numpy(ks_pool),
                   v_scale=torch.from_numpy(vs_pool))
        contiguous = (kv.k_q, kv.v_q)
    o_j, lse_j = jpg.paged_decode_attention(
        jnp.asarray(q), *jargs, jnp.asarray(valid),
        jnp.asarray(lengths, jnp.int32), **jkw)
    o_t, lse_t = tpg.paged_decode_attention(
        torch.from_numpy(q), *tpools, torch.from_numpy(table), lens, **tkw)
    assert o_t.dtype == torch.float32 and tuple(o_t.shape) == (b, h, d)
    assert _err(o_j, o_t) <= GATES["float32"]
    assert _err(lse_j, lse_t) <= GATES["float32"]
    ckw = {} if qtype is None else dict(k_scale=kv.k_scale,
                                        v_scale=kv.v_scale)
    o_c, lse_c = decode_attention(torch.from_numpy(q), *contiguous, lens,
                                  **ckw)
    assert torch.max(torch.abs(o_t - o_c)) <= 1e-6
    assert torch.max(torch.abs(lse_t - lse_c)) <= 1e-6
