"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and skip without one. The file
imports no JAX, so on a machine without it they run with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Gates (bf16 inputs): 5e-3 on O and LSE of the forward, the decode (every
storage type, window and `quantize_q` form), the paged decode and FA1;
for the backward, per gradient, max |diff| <= 2e-2 · max |plain| (an
absolute gate near the gradients' own size would pass all-zero dK)."""

import pytest
import torch

from cuda_flashattention_torch.ops.attention import flash_attention
from cuda_flashattention_torch.ops.decode import (
    decode_attention,
    decode_attention_plain,
)
from cuda_flashattention_torch.ops.fa1 import (
    fa1_attention,
    fa1_attention_plain,
)
from cuda_flashattention_torch.ops.flash_bwd import (
    flash_attention_backward,
    flash_attention_backward_plain,
)
from cuda_flashattention_torch.ops.flash_fwd import (
    flash_attention_forward,
    flash_attention_forward_plain,
)
from cuda_flashattention_torch.ops.kv_cache import init_cache
from cuda_flashattention_torch.ops.paged import (
    PageAllocator,
    init_paged_cache,
    paged_append,
    paged_bulk_append,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_step,
    paged_prefix_attention,
)
from cuda_flashattention_torch.ops.quant import quantize_kv

GATE = 5e-3
BWD_GATE = 2e-2
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _rand(gen, dev, *shape):
    return (torch.rand(shape, generator=gen, device=dev) - 0.5).to(
        torch.bfloat16)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,causal,kv_offset,out_dtype", [
    (2, 16, 4, 512, 512, 128, True, 0, torch.float32),
    (1, 4, 2, 37, 53, 64, True, 16, torch.bfloat16),
    (2, 8, 8, 100, 300, 128, False, 0, torch.float32),
    (1, 2, 2, 70, 70, 64, True, -20, torch.float32),
])
def test_forward_kernel(dev, b, h, h_kv, nq, nk, d, causal, kv_offset,
                        out_dtype):
    gen = torch.Generator(device=dev).manual_seed(nq + nk)
    q = _rand(gen, dev, b, h, nq, d)
    k, v = _rand(gen, dev, b, h_kv, nk, d), _rand(gen, dev, b, h_kv, nk, d)
    kw = dict(causal=causal, kv_offset=kv_offset, out_dtype=out_dtype)
    before = flash_attention_forward.launches
    o, lse = flash_attention_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_forward.launches == before + 1
    o_p, lse_p = flash_attention_forward_plain(q, k, v, **kw)
    assert o.dtype == out_dtype
    assert _err(o, o_p) <= GATE and _err(lse, lse_p) <= GATE


def test_forward_kernel_strided_views(dev):
    """q/k/v as [B,N,H,d] buffers viewed as [B,H,N,d], as prefill passes
    them."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _rand(gen, dev, 2, 96, 8, 128).transpose(1, 2)
    k = _rand(gen, dev, 2, 96, 2, 128).transpose(1, 2)
    v = _rand(gen, dev, 2, 96, 2, 128).transpose(1, 2)
    o, lse = flash_attention_forward(q, k, v, causal=True)
    o_p, lse_p = flash_attention_forward_plain(q, k, v, causal=True)
    assert _err(o, o_p) <= GATE and _err(lse, lse_p) <= GATE


@pytest.mark.parametrize("b,h,h_kv,max_n,d,lengths", [
    (8, 16, 4, 640, 128, [1, 63, 64, 513, 640, 0, 200, 577]),
    (3, 4, 2, 100, 64, [100, 1, 37]),
    (2, 8, 8, 50, 128, [50, 49]),
])
def test_decode_kernel(dev, b, h, h_kv, max_n, d, lengths):
    gen = torch.Generator(device=dev).manual_seed(max_n)
    q = _rand(gen, dev, b, h, d)
    k = _rand(gen, dev, b, h_kv, max_n, d)
    v = _rand(gen, dev, b, h_kv, max_n, d)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = decode_attention.launches
    o, lse = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    o_p, lse_p = decode_attention_plain(q, k, v, lens)
    assert _err(o, o_p) <= GATE and _err(lse, lse_p) <= GATE


def _nan_fill_allocator(dev):
    """Leave NaN in the caching allocator's small blocks, which the next
    small outputs reuse: an output element left unwritten then shows."""
    junk = [torch.full((1 << 18,), float("nan"), device=dev)
            for _ in range(16)]
    del junk


@pytest.mark.parametrize("kw", [
    dict(), dict(window=256), dict(windows=[5, 640, 64, 1, 0, 300, 700, 9]),
    dict(window=100, windows=[5, 640, 64, 1, 0, 300, 700, 9]),
    dict(quantize_q=True), dict(quantize_q=True, window=256),
])
@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
def test_decode_kernel_forms(dev, qtype, kw):
    """Every storage type with every window form and `quantize_q`, at the
    serving shape, with NaN past each live context."""
    b, h, h_kv, max_n, d = 8, 16, 4, 640, 128
    lengths = [1, 63, 64, 513, 640, 0, 200, 577]
    gen = torch.Generator(device=dev).manual_seed(7)
    q = _rand(gen, dev, b, h, d)
    k = _rand(gen, dev, b, h_kv, max_n, d)
    v = _rand(gen, dev, b, h_kv, max_n, d)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(kw)
    if "windows" in kw:
        kw["windows"] = torch.tensor(kw["windows"], dtype=torch.int32,
                                     device=dev)
    if qtype is None:
        for i, n in enumerate(lengths):
            k[i, :, n:] = float("nan")
            v[i, :, n:] = float("nan")
    else:
        kv = quantize_kv(k, v, qtype)
        k, v = kv.k_q, kv.v_q
        kw.update(k_scale=kv.k_scale, v_scale=kv.v_scale)
        for i, n in enumerate(lengths):
            kv.k_scale[i, :, n:] = float("nan")
            kv.v_scale[i, :, n:] = float("nan")
    _nan_fill_allocator(dev)
    before = decode_attention.launches
    o, lse = decode_attention(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    o_p, lse_p = decode_attention_plain(q, k, v, lens, **kw)
    assert _err(o, o_p) <= GATE and _err(lse, lse_p) <= GATE
    assert torch.all(o[5] == 0) and torch.all(lse[5] == -1e30)


@pytest.mark.parametrize("group,d", [(1, 64), (3, 128), (16, 64), (20, 128)])
def test_decode_kernel_any_group_size(dev, group, d):
    b, h_kv, max_n = 2, 2, 300
    gen = torch.Generator(device=dev).manual_seed(group)
    q = _rand(gen, dev, b, h_kv * group, d)
    k, v = _rand(gen, dev, b, h_kv, max_n, d), _rand(gen, dev, b, h_kv,
                                                     max_n, d)
    lens = torch.tensor([300, 77], dtype=torch.int32, device=dev)
    _nan_fill_allocator(dev)
    o, lse = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    o_p, lse_p = decode_attention_plain(q, k, v, lens)
    assert _err(o, o_p) <= GATE and _err(lse, lse_p) <= GATE


def _paged_copy(dev, k, v, lengths, page, max_pages, qtype, gen):
    """Pools holding the live prefix of contiguous k/v behind a shuffled
    table whose dead entries are out of range; the rest of the pools and
    the dead tail of each last page are NaN (scales) or noise (codes)."""
    b, h_kv, _, d = k.shape
    n_pages = b * max_pages + 5
    order = torch.randperm(n_pages, generator=gen, device=dev)
    cache = init_paged_cache(n_pages, b, max_pages, h_kv, page, d,
                             qtype=qtype, device=dev)
    if qtype is None:
        cache.k_pages.fill_(float("nan"))
        cache.v_pages.fill_(float("nan"))
        kq, vq, ks, vs = k, v, None, None
    else:
        cache.k_scale.fill_(float("nan"))
        cache.v_scale.fill_(float("nan"))
        kv = quantize_kv(k, v, qtype)
        kq, vq, ks, vs = kv.k_q, kv.v_q, kv.k_scale, kv.v_scale
    cache.page_table.fill_(10 ** 6)
    slot = 0
    for i, n in enumerate(lengths):
        for p in range(-(-n // page)):
            pid = int(order[slot])
            slot += 1
            cache.page_table[i, p] = pid
            lo, hi = p * page, min(n, (p + 1) * page)
            cache.k_pages[pid, :, :hi - lo] = kq[i, :, lo:hi]
            cache.v_pages[pid, :, :hi - lo] = vq[i, :, lo:hi]
            if qtype is not None:
                cache.k_scale[pid, :, :hi - lo] = ks[i, :, lo:hi]
                cache.v_scale[pid, :, :hi - lo] = vs[i, :, lo:hi]
        cache.lengths[i] = n
    return cache, (kq, vq, ks, vs)


@pytest.mark.parametrize("kw", [dict(), dict(window=100),
                                dict(quantize_q=True)])
@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("page", [1, 16, 128])
def test_paged_kernel(dev, page, qtype, kw):
    """The paged walk against its plain version and, on the same keys,
    bit for bit against the contiguous kernel."""
    b, h, h_kv, d = 4, 16, 4, 128
    lengths = [300, 0, 129, 1]
    max_pages = -(-300 // page) + 2
    gen = torch.Generator(device=dev).manual_seed(page)
    q = _rand(gen, dev, b, h, d)
    k, v = _rand(gen, dev, b, h_kv, 300, d), _rand(gen, dev, b, h_kv, 300, d)
    cache, (kq, vq, ks, vs) = _paged_copy(dev, k, v, lengths, page,
                                          max_pages, qtype, gen)
    _nan_fill_allocator(dev)
    before = paged_decode_attention.launches
    o, lse = paged_decode_step(q, cache, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    o_p, lse_p = paged_decode_attention_plain(
        q, cache.k_pages, cache.v_pages, cache.page_table, cache.lengths,
        k_scale=cache.k_scale, v_scale=cache.v_scale, **kw)
    assert _err(o, o_p) <= GATE and _err(lse, lse_p) <= GATE
    o_c, lse_c = decode_attention(q, kq, vq, cache.lengths, k_scale=ks,
                                  v_scale=vs, **kw)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    assert torch.all(o[1] == 0) and torch.all(lse[1] == -1e30)


def test_paged_lifecycle_on_the_card(dev):
    """Bulk prefill, appends through the allocator, decode against a
    contiguous shadow, prefix attention over more rows than one tile."""
    b, h, h_kv, page, max_pages, d = 2, 8, 2, 16, 8, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    cache = init_paged_cache(24, b, max_pages, h_kv, page, d, device=dev)
    shadow = init_cache(b, h_kv, page * max_pages, d, device=dev)
    assert cache.k_pages.device == dev and shadow.k.device == dev
    alloc = PageAllocator(24)
    k0, v0 = _rand(gen, dev, b, h_kv, 32, d), _rand(gen, dev, b, h_kv, 32, d)
    for i in range(b):
        alloc.reserve_for(cache, i, 32)
    paged_bulk_append(cache, k0, v0)
    shadow.k[:, :, :32], shadow.v[:, :, :32] = k0, v0
    for t in range(20):
        k1, v1 = _rand(gen, dev, b, h_kv, d), _rand(gen, dev, b, h_kv, d)
        for i in range(b):
            alloc.reserve_for(cache, i, 1)
        paged_append(cache, k1, v1)
        shadow.k[:, :, 32 + t], shadow.v[:, :, 32 + t] = k1, v1
    assert cache.lengths.tolist() == [52, 52]
    q = _rand(gen, dev, b, h, d)
    o, lse = paged_decode_step(q, cache)
    o_c, lse_c = decode_attention(q, shadow.k, shadow.v, cache.lengths)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    qc = _rand(gen, dev, b, h, 24, d)  # 4 x 24 = 96 rows per KV head
    o_x, lse_x = paged_prefix_attention(qc, cache)
    torch.cuda.synchronize()
    o_p, lse_p = paged_decode_attention_plain(
        qc.reshape(b, h * 24, d), cache.k_pages, cache.v_pages,
        cache.page_table, cache.lengths)
    assert _err(o_x.reshape(b, h * 24, d), o_p) <= GATE
    assert _err(lse_x.reshape(b, h * 24), lse_p) <= GATE
    free = len(alloc.free)
    alloc.release_sequence(cache, 0)
    assert len(alloc.free) == free + 4 and cache.lengths.tolist() == [0, 52]


@pytest.mark.parametrize("b,h,nq,nk,d,causal,block_q,block_k", [
    (1, 4, 512, 512, 128, True, 256, 256),
    (2, 2, 300, 300, 64, True, 64, 64),
    (1, 2, 100, 333, 128, False, 128, 192),
    (1, 2, 70, 40, 64, True, 256, 256),
    (2, 3, 37, 200, 128, False, 256, 256),
])
def test_fa1_kernel(dev, b, h, nq, nk, d, causal, block_q, block_k):
    gen = torch.Generator(device=dev).manual_seed(nq + nk)
    q = _rand(gen, dev, b, h, nq, d)
    k, v = _rand(gen, dev, b, h, nk, d), _rand(gen, dev, b, h, nk, d)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    _nan_fill_allocator(dev)
    before = fa1_attention.launches
    o = fa1_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa1_attention.launches == before + 1
    assert o.dtype == torch.bfloat16 and torch.isfinite(o).all()
    o_p = fa1_attention_plain(q, k, v, causal=causal,
                              block_q=max(8, min(block_q, -(-nq // 8) * 8)),
                              block_k=max(8, min(block_k, -(-nk // 8) * 8)))
    assert _err(o, o_p) <= GATE
    o_fa2, _ = flash_attention_forward_plain(q, k, v, causal=causal)
    assert _err(o, o_fa2) <= GATE


def test_fa1_kernel_strided_views_and_refusals(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_rand(gen, dev, 2, 96, 4, 128).transpose(1, 2)
               for _ in range(3))
    o = fa1_attention(q, k, v, causal=True)
    assert _err(o, fa1_attention_plain(q, k, v, causal=True, block_q=96,
                                       block_k=96)) <= GATE
    big = _rand(gen, dev, 1, 2, 512, 128)
    with pytest.raises(ValueError, match="the CUDA FA1 takes block_k"):
        fa1_attention(big, big, big, block_k=96)
    with pytest.raises(ValueError, match="the CUDA FA1 takes block_q"):
        fa1_attention(big, big, big, block_q=96)
    with pytest.raises(NotImplementedError, match="bf16"):
        fa1_attention(big.float(), big.float(), big.float())


def test_entry_points_allocate_on_the_card_by_default(dev):
    from cuda_flashattention_torch.models import transformer as tfm
    assert init_cache(1, 1, 4, 64).k.device.type == "cuda"
    assert init_paged_cache(2, 1, 2, 1, 4, 64).k_pages.device.type == "cuda"
    cfg = tfm.TransformerConfig(vocab_size=8, d_model=64, n_layers=1,
                                n_heads=1, n_kv_heads=1, d_head=64, d_ff=64)
    assert tfm.init_caches(cfg, 1, 4)[0].v.device.type == "cuda"


def _bwd_inputs(dev, b, h, h_kv, nq, nk, d, causal, kv_offset, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = _rand(gen, dev, b, h, nq, d), _rand(gen, dev, b, h, nq, d)
    k, v = _rand(gen, dev, b, h_kv, nk, d), _rand(gen, dev, b, h_kv, nk, d)
    o, lse = flash_attention_forward(q, k, v, causal=causal,
                                     kv_offset=kv_offset)
    return q, k, v, o, lse, do


def _assert_rel(got, want, name):
    scale = want.float().abs().max().item()
    assert scale > 0, f"{name}: the plain gradient is all zero"
    assert _err(got, want) <= BWD_GATE * scale, name


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,causal,kv_offset", [
    (1, 16, 16, 1024, 1024, 128, True, 0),
    (2, 16, 4, 1000, 1000, 128, True, 0),
    (1, 4, 2, 70, 70, 64, True, -20),
    (2, 8, 8, 100, 300, 128, False, 0),
    (1, 4, 2, 37, 53, 64, True, 16),
])
def test_backward_kernels(dev, b, h, h_kv, nq, nk, d, causal, kv_offset,
                          fused):
    args = _bwd_inputs(dev, b, h, h_kv, nq, nk, d, causal, kv_offset,
                       seed=nq + nk)
    kw = dict(causal=causal, kv_offset=kv_offset)
    before = dict(flash_attention_backward.launches)
    got = flash_attention_backward(*args, fused=fused, **kw)
    torch.cuda.synchronize()
    after = flash_attention_backward.launches
    grown = {n: after[n] - before[n] for n in after}
    assert grown == ({"fused": 1, "dkdv": 0, "dq": 0} if fused
                     else {"fused": 0, "dkdv": 1, "dq": 1})
    want = flash_attention_backward_plain(*args, **kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_rel(g, w, name)


def test_fused_matches_split(dev):
    args = _bwd_inputs(dev, 2, 16, 4, 1000, 1000, 128, True, 0, seed=1)
    fus = flash_attention_backward(*args, causal=True, fused=True)
    split = flash_attention_backward(*args, causal=True, fused=False)
    for a, b_, name in zip(fus, split, ("dQ", "dK", "dV")):
        _assert_rel(a, b_, name)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_writes_zeros_where_nothing_is_seen(dev, fused):
    """kv_offset = -20 with Nk > Nq: query rows 0..19 see no key and keys
    past Nq - 21 are seen by no query, whole 64-key tiles among them. The
    outputs land in memory first filled with NaN, so a tile left
    unwritten shows."""
    b, h, h_kv, nq, nk, d = 1, 4, 2, 70, 260, 128
    args = _bwd_inputs(dev, b, h, h_kv, nq, nk, d, True, -20, seed=5)
    # 1 MB blocks come from the caching allocator's small-block pool, as
    # the outputs here do: it hands these bytes out again
    junk = [torch.full((1 << 18,), float("nan"), device=dev)
            for _ in range(16)]
    del junk
    dq, dk, dv = flash_attention_backward(*args, causal=True, kv_offset=-20,
                                          fused=fused)
    torch.cuda.synchronize()
    assert torch.all(dq[:, :, :20] == 0) and torch.isfinite(dq).all()
    assert torch.all(dk[:, :, 50:] == 0) and torch.all(dv[:, :, 50:] == 0)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    want = flash_attention_backward_plain(*args, causal=True, kv_offset=-20)
    for g, w, name in zip((dq, dk, dv), want, ("dQ", "dK", "dV")):
        _assert_rel(g, w, name)


def test_autograd_through_the_kernels(dev):
    """flash_attention's backward on strided [B,N,H,d] views goes through
    K1 once and K4 once, and agrees with the plain backward."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _rand(gen, dev, 2, 300, 8, 128).transpose(1, 2).requires_grad_(True)
    k = _rand(gen, dev, 2, 300, 2, 128).transpose(1, 2).requires_grad_(True)
    v = _rand(gen, dev, 2, 300, 2, 128).transpose(1, 2).requires_grad_(True)
    do = _rand(gen, dev, 2, 300, 8, 128).transpose(1, 2)
    fwd0 = flash_attention_forward.launches
    bwd0 = flash_attention_backward.launches["fused"]
    o = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), grad_outputs=do)
    torch.cuda.synchronize()
    assert flash_attention_forward.launches == fwd0 + 1
    assert flash_attention_backward.launches["fused"] == bwd0 + 1
    _, lse = flash_attention_forward_plain(q.detach(), k.detach(),
                                           v.detach(), causal=True)
    want = flash_attention_backward_plain(q.detach(), k.detach(), v.detach(),
                                          o.detach(), lse, do, causal=True)
    for g, w, name in zip(grads, want, ("dQ", "dK", "dV")):
        _assert_rel(g, w, name)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 2, 8, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d in"):
        flash_attention_forward(q, q, q)
    q32 = torch.zeros(1, 2, 8, 64, device=dev)
    with pytest.raises(NotImplementedError, match="bf16"):
        flash_attention_forward(q32, q32, q32)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="bf16 q"):
        decode_attention(q32[:, :, 0], q32, q32, lens)
    qd, kd = q[:, :, 0, :64].contiguous(), q[..., :64].contiguous()
    with pytest.raises(NotImplementedError, match="cache"):  # int8 V alone
        decode_attention(qd, kd, kd.to(torch.int8), lens)
    with pytest.raises(NotImplementedError, match="cache"):  # no scales
        decode_attention(qd, kd.to(torch.int8), kd.to(torch.int8), lens)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(NotImplementedError, match="bf16"):
        flash_attention_backward(q32, q32, q32, q32, lse, q32)
    with pytest.raises(ValueError, match="d in"):
        flash_attention_backward(q, q, q, q, lse, q)
