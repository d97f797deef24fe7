"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and skip without one. The file
imports no JAX, so on a machine without it they run with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Gates (bf16 inputs): 5e-3 on O and LSE of the forward (every softmax
form, mask, storage type and `quantize_q`; on peaked inputs O is also held
to 2e-2 of the plain version's largest |O|), the decode (every storage
type, window and `quantize_q` form), the paged decode and FA1;
for the backward, per gradient, max |diff| <= 2e-2 · max |plain| (an
absolute gate near the gradients' own size would pass all-zero dK). The
fp32 builds (the `test_f32_*` tests): 1e-4 on O and LSE, 1e-4 · max(1,
max |plain|) per gradient. The fp16 builds (`test_f16_*`) take the bf16
gates; mixed float types (`test_mixed_*`) the fp32 gate plus one ulp of
the output's and of the rounded operand's types (`_assert_mixed`)."""

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
    kw = dict(causal=causal, kv_offset=kv_offset, out_dtype=out_dtype,
              softmax="online")
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
                             qtype=qtype, dtype=k.dtype, device=dev)
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
    # fp32 has a build since K8's F32 one, fp16 the fp16 unit's, and
    # mixed types run the fp32 build (P rounded to v's type, O in q's)
    o = fa1_attention(big.float(), big, big)
    assert o.dtype == torch.float32
    _assert_mixed(o, fa1_attention_plain(big.float(), big, big), big,
                  torch.bfloat16)
    h = big.half()
    assert _err(fa1_attention(h, h, h), fa1_attention_plain(h, h, h)) <= GATE
    with pytest.raises(NotImplementedError, match="bf16, fp16 or fp32"):
        fa1_attention(big.to(torch.int8), big, big)


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
    assert grown == ({"fused": 1, "dkdv": 0, "dq": 0, "delta": 1} if fused
                     else {"fused": 0, "dkdv": 1, "dq": 1, "delta": 1})
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
    # d = 300: past every build of the forward (256)
    q = torch.zeros(1, 2, 8, 300, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="forward takes d from 1 to 256"):
        flash_attention_forward(q, q, q)
    gen = torch.Generator(device=dev).manual_seed(0)
    q32 = _u(gen, dev, 1, 2, 8, 64)
    q16 = q32.half()
    # fp16 has the fp16 unit's builds, and an fp32 Q over fp16 K/V the
    # fp32 builds on the K/V upcast: both run now
    for args in ((q16, q16, q16), (q32, q16, q16)):
        o, _ = flash_attention_forward(*args)
        o_p, _ = flash_attention_forward_plain(*args)
        assert o.dtype == args[0].dtype and _err(o, o_p) <= GATE
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    for qd, kd in ((q16, q16), (q32, q16)):
        o, _ = decode_attention(qd[:, :, 0], kd, kd, lens)
        o_p, _ = decode_attention_plain(qd[:, :, 0], kd, kd, lens)
        assert o.dtype == qd.dtype and _err(o, o_p) <= GATE
    with pytest.raises(ValueError, match="d from 1 to 256"):  # no build
        decode_attention(q[:, :, 0], q, q, lens)
    qd, kd = q[:, :, 0, :64].contiguous(), q[..., :64].contiguous()
    with pytest.raises(NotImplementedError, match="cache"):  # int8 V alone
        decode_attention(qd, kd, kd.to(torch.int8), lens)
    with pytest.raises(NotImplementedError, match="cache"):  # no scales
        decode_attention(qd, kd.to(torch.int8), kd.to(torch.int8), lens)
    lse = torch.zeros(1, 2, 8, device=dev)
    # fp16 has its own builds, mixed types the fp32 ones: both run now
    for args in ((q16, q16, q16, q16, lse, q16),
                 (q32, q32, q32, q32, lse, q32.bfloat16())):
        got = flash_attention_backward(*args)
        want = flash_attention_backward_plain(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and _err(g, w) <= GATE
    with pytest.raises(NotImplementedError, match="bf16, fp16 or fp32"):
        flash_attention_backward(q32, q32, q32, q32, lse,
                                 q32.to(torch.int8))
    # the backward's builds stop at d = 256, in bf16 and fp32 alike
    q300 = torch.zeros(1, 2, 8, 300, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="backward takes d from 1 to 256"):
        flash_attention_backward(q300, q300, q300, q300, lse, q300)
    with pytest.raises(ValueError, match="backward takes d from 1 to 256"):
        flash_attention_backward(q300.float(), q300.float(), q300.float(),
                                 q300.float(), lse, q300.float())


# ---------------------------------------------------------------------------
# The forward's other forms: masks, quantized K/V, bound softmax (K1b), the
# K-major walk (K5), quantize_q; the backward's masks
# ---------------------------------------------------------------------------

REL_GATE = 2e-2


def _fwd_inputs(dev, b, h, h_kv, nq, nk, d, qtype, seed):
    """Peaked Q (x8) and K (x4), so that |O| stays well above the gate
    over hundreds of keys; K/V quantized to `qtype` (None: bf16)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (_rand(gen, dev, b, h, nq, d).float() * 8).to(torch.bfloat16)
    k = (_rand(gen, dev, b, h_kv, nk, d).float() * 4).to(torch.bfloat16)
    v = _rand(gen, dev, b, h_kv, nk, d)
    if qtype is None:
        return (q, k, v), {}
    kv = quantize_kv(k, v, qtype)
    return (q, kv.k_q, kv.v_q), dict(k_scale=kv.k_scale, v_scale=kv.v_scale)


def _form_counts():
    return dict(flash_attention_forward.form_launches)


def _assert_fwd_close(got, want):
    (o, lse), (o_p, lse_p) = got, want
    ref = o_p.float().abs().max().item()
    assert ref > 0, "the plain O is all zero"
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert _err(o, o_p) <= min(GATE, REL_GATE * ref)
    assert _err(lse, lse_p) <= GATE


@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", [
    (2, 8, 2, 300, 300, 128, dict(causal=True, window=100)),
    (1, 4, 2, 130, 500, 64, dict(causal=True, window=70, kv_offset=370)),
    (1, 4, 4, 200, 200, 128, dict(causal=True, window=64, kv_offset=-70)),
    (2, 8, 2, 128, 384, 128, dict(causal=False)),
    (1, 4, 2, 100, 257, 64, dict(causal=True, kv_offset=157)),
])
def test_forward_online_masks_and_storage(dev, qtype, b, h, h_kv, nq, nk, d,
                                          kw):
    args, scales = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, qtype, nq + nk)
    kw = dict(kw, softmax="online", out_dtype=torch.float32, **scales)
    _nan_fill_allocator(dev)
    before = _form_counts()
    got = flash_attention_forward(*args, **kw)
    torch.cuda.synchronize()
    after = _form_counts()
    assert after["online"] == before["online"] + 1
    assert {n: after[n] - before[n] for n in after if n != "online"} == {
        "bound": 0, "kmajor": 0, "fallback": 0}
    _assert_fwd_close(got, flash_attention_forward_plain(*args, **kw))


def _segments(dev, b, n, lengths):
    ids = torch.repeat_interleave(
        torch.arange(len(lengths), device=dev),
        torch.tensor(lengths, device=dev))[:n]
    return ids[None].expand(b, n).contiguous()


@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_backward_segments(dev, causal):
    b, h, h_kv, n, d = 2, 8, 2, 300, 128
    (q, k, v), _ = _fwd_inputs(dev, b, h, h_kv, n, n, d, None, 11)
    seg = _segments(dev, b, n, [70, 1, 129, 100])
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    got = flash_attention_forward(q, k, v, **kw)
    _assert_fwd_close(got, flash_attention_forward_plain(q, k, v, **kw))
    o, lse = got
    gen = torch.Generator(device=dev).manual_seed(2)
    do = _rand(gen, dev, b, h, n, d)
    want = flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    for fused in (True, False):
        grads = flash_attention_backward(q, k, v, o, lse, do, fused=fused,
                                         **kw)
        for g, w, name in zip(grads, want, ("dQ", "dK", "dV")):
            _assert_rel(g, w, f"{name} fused={fused}")


def test_forward_segments_leave_empty_rows(dev):
    """A query segment that no key carries: O = 0, LSE = NEG_INF."""
    (q, k, v), _ = _fwd_inputs(dev, 1, 4, 2, 100, 100, 64, None, 3)
    qseg = _segments(dev, 1, 100, [40, 60])
    kseg = torch.zeros_like(qseg)
    o, lse = flash_attention_forward(q, k, v, q_segment_ids=qseg,
                                     kv_segment_ids=kseg)
    torch.cuda.synchronize()
    assert torch.all(o[:, :, 40:] == 0) and torch.all(lse[:, :, 40:] == -1e30)
    _assert_fwd_close((o, lse), flash_attention_forward_plain(
        q, k, v, q_segment_ids=qseg, kv_segment_ids=kseg))


# what each (storage, mask) routes to under a pinned bound softmax
@pytest.mark.parametrize("softmax", ["bound", "bound_unchecked"])
@pytest.mark.parametrize("qtype,quantize_q", [
    (None, False), ("int8", False), ("fp8", False), ("mixed", False),
    ("int8", True), ("fp8", True), ("mixed", True)])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", [
    (2, 8, 2, 128, 384, 128, dict(causal=False)),
    (1, 4, 2, 100, 257, 64, dict(causal=False)),
    (2, 8, 2, 300, 300, 128, dict(causal=True)),
    (1, 8, 2, 130, 500, 128, dict(causal=True, window=70, kv_offset=370)),
    (1, 4, 4, 200, 200, 64, dict(causal=True, window=64, kv_offset=-70)),
    (1, 4, 2, 100, 257, 128, dict(causal=True, kv_offset=157)),
])
def test_forward_bound_forms(dev, softmax, qtype, quantize_q, b, h, h_kv, nq,
                             nk, d, kw):
    args, scales = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, qtype, nq + nk)
    kw = dict(kw, softmax=softmax, quantize_q=quantize_q,
              out_dtype=torch.float32, **scales)
    _nan_fill_allocator(dev)
    before = _form_counts()
    got = flash_attention_forward(*args, **kw)
    torch.cuda.synchronize()
    after = _form_counts()
    kmajor = kw["causal"] or qtype == "fp8"
    checked = softmax == "bound" and not quantize_q
    assert {n: after[n] - before[n] for n in after} == {
        "online": 0, "bound": int(not kmajor), "kmajor": int(kmajor),
        "fallback": int(checked)}
    _assert_fwd_close(got, flash_attention_forward_plain(*args, **kw))


@pytest.mark.parametrize("qtype,quantize_q", [
    (None, False), ("int8", False), ("mixed", False), ("int8", True)])
def test_kmajor_matches_qmajor(dev, qtype, quantize_q):
    """K5 and K1b compute one function: a causal call whose kv_offset makes
    every key visible (K-major) against the non-causal call (Q-major)."""
    b, h, h_kv, nq, nk, d = 2, 8, 2, 128, 384, 128
    args, scales = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, qtype, 5)
    kw = dict(softmax="bound_unchecked", quantize_q=quantize_q,
              out_dtype=torch.float32, **scales)
    before = _form_counts()
    o_q, lse_q = flash_attention_forward(*args, causal=False, **kw)
    o_k, lse_k = flash_attention_forward(*args, causal=True, kv_offset=nk,
                                         **kw)
    torch.cuda.synchronize()
    after = _form_counts()
    assert (after["bound"], after["kmajor"]) == (before["bound"] + 1,
                                                 before["kmajor"] + 1)
    # the same products and roundings; only fp32 summation order differs
    assert _err(o_k, o_q) <= 1e-4 and _err(lse_k, lse_q) <= 1e-4


def _pinned(form, q, k, v, quantize_q=False, out_dtype=torch.float32,
            **kw):
    """One bound kernel pinned, whatever "auto" would route to: "bound"
    (K1b, Q-major) or "kmajor" (K5, key split), without the guarded
    fallback launch."""
    import dataclasses
    from cuda_flashattention_torch.ops import flash_fwd as ff
    plan = ff._plan(q, k, v, kw.get("scale"), kw.get("causal", False),
                    kw.get("window", 0), kw.get("kv_offset", 0), None,
                    kw.get("k_scale"), kw.get("v_scale"), None, None,
                    "bound_unchecked", quantize_q)
    plan = dataclasses.replace(plan, use_kmajor=form == "kmajor")
    return ff._fwd_cuda(q, k, v, plan, out_dtype, kw.get("k_scale"),
                        kw.get("v_scale"), None, None)


_STORAGE_FORMS = [(None, False), ("int8", False), ("fp8", False),
                  ("mixed", False), ("int8", True), ("fp8", True),
                  ("mixed", True)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype,quantize_q", _STORAGE_FORMS)
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", [
    (1, 4, 4, 37, 1, 128, dict()),                      # Nk = 1, G = 1
    (2, 16, 4, 100, 300, 64, dict(causal=True, kv_offset=200)),  # G = 4
    (1, 16, 1, 77, 300, 128, dict(causal=True, window=100,
                                  kv_offset=223)),      # G = 16
    (2, 8, 8, 130, 500, 128, dict()),
    (1, 8, 2, 200, 333, 64, dict(causal=True, window=90, kv_offset=133)),
])
def test_bound_kernels_pinned(dev, out_dtype, qtype, quantize_q, b, h, h_kv,
                              nq, nk, d, kw):
    """K1b and K5, each pinned, against the plain version: ragged Nq and
    Nk, windows that start inside a key tile, kv_offset, GQA groups of 1,
    4 and 16, d 64 and 128, every storage pair with and without
    quantize_q, fp32 and bf16 O; K5 within 1e-4 of K1b; one launch each."""
    args, scales = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, qtype, nq + nk)
    kw = dict(kw, **scales)
    want = flash_attention_forward_plain(
        *args, softmax="bound_unchecked", quantize_q=quantize_q,
        out_dtype=out_dtype, **kw)
    _nan_fill_allocator(dev)
    got = {}
    for form in ("bound", "kmajor"):
        before = _form_counts()
        got[form] = _pinned(form, *args, quantize_q=quantize_q,
                            out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        after = _form_counts()
        assert {n: after[n] - before[n] for n in after} == {
            "online": 0, "bound": int(form == "bound"),
            "kmajor": int(form == "kmajor"), "fallback": 0}
        assert got[form][0].dtype == out_dtype
        _assert_fwd_close(got[form], want)
    if out_dtype == torch.float32:
        assert _err(got["kmajor"][0], got["bound"][0]) <= 1e-4
    assert _err(got["kmajor"][1], got["bound"][1]) <= 1e-4


@pytest.mark.parametrize("qtype", [None, "int8", "mixed"])
def test_bound_kernels_read_a_view_of_a_longer_cache(dev, qtype):
    """K/V sliced to the live 300 keys of a 1000-key cache whose tail is
    NaN: the TMA descriptors stop at the live length."""
    b, h, h_kv, nq, d, n_live = 2, 8, 2, 96, 128, 300
    (q, k, v), _ = _fwd_inputs(dev, b, h, h_kv, nq, 1000, d, None, 7)
    scales = {}
    if qtype is not None:
        kv = quantize_kv(k, v, qtype)
        k, v = kv.k_q, kv.v_q
        scales = dict(k_scale=kv.k_scale[:, :, :n_live],
                      v_scale=kv.v_scale[:, :, :n_live])
    if qtype is None:
        k[:, :, n_live:] = float("nan")
        v[:, :, n_live:] = float("nan")
    else:
        k.view(torch.uint8)[:, :, n_live:] = 0x7F  # e4m3 NaN, int8 127
        v.view(torch.uint8)[:, :, n_live:] = 0x7F
    k, v = k[:, :, :n_live], v[:, :, :n_live]
    assert not k.is_contiguous()
    kw = dict(causal=True, kv_offset=n_live - nq, **scales)
    want = flash_attention_forward_plain(q, k, v, softmax="bound_unchecked",
                                         out_dtype=torch.float32, **kw)
    for form in ("bound", "kmajor"):
        got = _pinned(form, q, k, v, **kw)
        torch.cuda.synchronize()
        _assert_fwd_close(got, want)


@pytest.mark.parametrize("d", [64, 128])
def test_kmajor_takes_its_longest_span(dev, d):
    """The host's longest span (`_KMAJOR_MAX_SPAN`) is one the kernel
    takes: enough keys for two waves of 132 CTAs get it, and K5 matches
    the plain version there."""
    from cuda_flashattention_torch.ops import flash_fwd as ff
    span = ff._KMAJOR_MAX_SPAN[d]
    b, h, h_kv, nq = 2, 8, 4, 64
    nk = 64 * span * -(-2 * 132 // (b * h_kv))
    assert ff._kmajor_span(b, h_kv, nk, d, 132) == span
    args, _ = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, None, d)
    want = flash_attention_forward_plain(*args, softmax="bound_unchecked",
                                         out_dtype=torch.float32)
    got = _pinned("kmajor", *args)
    torch.cuda.synchronize()
    _assert_fwd_close(got, want)


def _loose_inputs(dev):
    """Anti-aligned Q and K of large norm: every score sits ~2·10³ log2
    units under the Cauchy–Schwarz bound, so the bound softmax underflows
    to l = 0 in every row."""
    b, h, n, d = 1, 2, 128, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.ones(d, device=dev) / d ** 0.5
    noise = (torch.rand((b, h, n, d), generator=gen, device=dev) - 0.5) * 0.1
    q = (40.0 * u + noise).to(torch.bfloat16)
    k = (-40.0 * u + noise.flip(2)).to(torch.bfloat16)
    v = _rand(gen, dev, b, h, n, d)
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
def test_loose_bound_falls_back_to_online(dev, causal):
    q, k, v = _loose_inputs(dev)
    kw = dict(causal=causal, out_dtype=torch.float32)
    o_on, lse_on = flash_attention_forward(q, k, v, softmax="online", **kw)
    before = _form_counts()
    o_b, lse_b = flash_attention_forward(q, k, v, softmax="bound", **kw)
    o_u, lse_u = flash_attention_forward(q, k, v, softmax="bound_unchecked",
                                         **kw)
    torch.cuda.synchronize()
    after = _form_counts()
    assert after["fallback"] == before["fallback"] + 1
    # the guarded online kernel ran and overwrote the bound result
    assert torch.equal(o_b, o_on) and torch.equal(lse_b, lse_on)
    # unchecked: the rows underflowed (O = 0, LSE = NEG_INF)
    assert torch.all(lse_u == -1e30) and torch.all(o_u == 0)
    assert lse_on.abs().max().item() < 1e5
    o_p, lse_p = flash_attention_forward_plain(q, k, v, softmax="bound", **kw)
    assert _err(o_b, o_p) <= GATE
    assert _err(lse_b, lse_p) <= 2e-3 * lse_p.abs().max().item()


def test_tight_bound_leaves_the_bound_result(dev):
    """With a tight bound the guarded online launch exits at once: the
    checked and the unchecked calls give the same bits (Q-major)."""
    args, _ = _fwd_inputs(dev, 2, 8, 2, 128, 384, 128, None, 9)
    kw = dict(causal=False, out_dtype=torch.float32)
    o_b, lse_b = flash_attention_forward(*args, softmax="bound", **kw)
    o_u, lse_u = flash_attention_forward(*args, softmax="bound_unchecked",
                                         **kw)
    torch.cuda.synchronize()
    assert torch.equal(o_b, o_u) and torch.equal(lse_b, lse_u)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,window,kv_offset", [
    (1, 16, 16, 1024, 1024, 128, 256, 0),
    (2, 8, 2, 300, 300, 128, 100, 0),
    (1, 4, 2, 130, 500, 64, 70, 370),
    (1, 4, 4, 200, 200, 64, 64, -70),
])
def test_backward_kernels_window(dev, b, h, h_kv, nq, nk, d, window,
                                 kv_offset, fused):
    gen = torch.Generator(device=dev).manual_seed(nq + nk)
    q, do = _rand(gen, dev, b, h, nq, d), _rand(gen, dev, b, h, nq, d)
    k, v = _rand(gen, dev, b, h_kv, nk, d), _rand(gen, dev, b, h_kv, nk, d)
    kw = dict(causal=True, window=window, kv_offset=kv_offset)
    o, lse = flash_attention_forward(q, k, v, **kw)
    _nan_fill_allocator(dev)
    got = flash_attention_backward(q, k, v, o, lse, do, fused=fused, **kw)
    torch.cuda.synchronize()
    want = flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert torch.isfinite(g.float()).all()
        _assert_rel(g, w, name)


def test_autograd_window_and_segments(dev):
    """flash_attention under a window and segment ids: K1 + K4 once each,
    gradients as the plain backward's."""
    gen = torch.Generator(device=dev).manual_seed(4)
    q = _rand(gen, dev, 2, 300, 8, 128).transpose(1, 2).requires_grad_(True)
    k = _rand(gen, dev, 2, 300, 2, 128).transpose(1, 2).requires_grad_(True)
    v = _rand(gen, dev, 2, 300, 2, 128).transpose(1, 2).requires_grad_(True)
    do = _rand(gen, dev, 2, 300, 8, 128).transpose(1, 2)
    seg = _segments(dev, 2, 300, [120, 180])
    kw = dict(causal=True, window=90, q_segment_ids=seg, kv_segment_ids=seg)
    fwd0, bwd0 = _form_counts(), flash_attention_backward.launches["fused"]
    o = flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(o, (q, k, v), grad_outputs=do)
    torch.cuda.synchronize()
    assert _form_counts()["online"] == fwd0["online"] + 1
    assert flash_attention_backward.launches["fused"] == bwd0 + 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    _, lse = flash_attention_forward_plain(qd, kd, vd, **kw)
    want = flash_attention_backward_plain(qd, kd, vd, o.detach(), lse, do,
                                          **kw)
    for g, w, name in zip(grads, want, ("dQ", "dK", "dV")):
        _assert_rel(g, w, name)


# K2/K4 walk 128-key tiles (csrc/flash_bwd_kv.cu): Nk at BK - 1, BK,
# BK + 1 and 2·BK + 3 with Nq != Nk; kv_offset crossing a key tile
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,causal,kv_offset", [
    (1, 4, 2, 100, 127, 128, True, 0),
    (1, 4, 2, 100, 127, 128, False, 0),
    (2, 4, 4, 200, 128, 128, True, 30),
    (2, 4, 4, 200, 128, 128, False, 0),
    (1, 8, 2, 64, 129, 128, True, 65),
    (1, 8, 2, 64, 129, 128, False, 0),
    (1, 4, 1, 300, 259, 64, True, 0),
    (1, 4, 1, 300, 259, 64, False, 0),
    (1, 4, 2, 64, 300, 128, True, 100),
    (1, 4, 2, 64, 300, 128, True, 127),
    (1, 4, 2, 64, 300, 128, True, 128),
    (1, 4, 2, 190, 300, 64, True, -70),
    (1, 16, 4, 1000, 1000, 64, True, 0),
])
def test_backward_kernels_key_tile_edges(dev, b, h, h_kv, nq, nk, d, causal,
                                         kv_offset, fused):
    args = _bwd_inputs(dev, b, h, h_kv, nq, nk, d, causal, kv_offset,
                       seed=3 * nq + nk)
    kw = dict(causal=causal, kv_offset=kv_offset)
    _nan_fill_allocator(dev)
    got = flash_attention_backward(*args, fused=fused, **kw)
    torch.cuda.synchronize()
    want = flash_attention_backward_plain(*args, **kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert torch.isfinite(g.float()).all(), name
        _assert_rel(g, w, name)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_kernels_gqa_training_shape(dev, fused):
    """B=1, 16 query heads over 4 KV heads, N=4096 causal: each CTA walks
    four query heads into one dK/dV."""
    args = _bwd_inputs(dev, 1, 16, 4, 4096, 4096, 128, True, 0, seed=16)
    got = flash_attention_backward(*args, causal=True, fused=fused)
    torch.cuda.synchronize()
    want = flash_attention_backward_plain(*args, causal=True)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        _assert_rel(g, w, name)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("nq,nk,d,window,kv_offset,lengths", [
    (100, 127, 128, 50, 27, None),
    (200, 129, 128, 64, 0, [64, 1, 64]),
    (300, 259, 64, 100, 0, [128, 2, 129]),
    (64, 300, 128, 90, 128, None),
    (259, 259, 128, 0, 0, [127, 1, 129, 2]),
])
def test_backward_kernels_window_and_segments_at_key_tile_edges(
        dev, nq, nk, d, window, kv_offset, lengths, fused):
    b, h, h_kv = 2, 4, 2
    gen = torch.Generator(device=dev).manual_seed(nq + 7 * nk)
    q, do = _rand(gen, dev, b, h, nq, d), _rand(gen, dev, b, h, nq, d)
    k, v = _rand(gen, dev, b, h_kv, nk, d), _rand(gen, dev, b, h_kv, nk, d)
    kw = dict(causal=True, window=window, kv_offset=kv_offset)
    if lengths is not None:
        kw.update(q_segment_ids=_segments(dev, b, nq, lengths + [nq]),
                  kv_segment_ids=_segments(dev, b, nk, lengths + [nk]))
    o, lse = flash_attention_forward(q, k, v, **kw)
    _nan_fill_allocator(dev)
    got = flash_attention_backward(q, k, v, o, lse, do, fused=fused, **kw)
    torch.cuda.synchronize()
    want = flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert torch.isfinite(g.float()).all(), name
        _assert_rel(g, w, name)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_without_queries_gives_zero_dk_dv(dev, fused):
    """Nq = 0: no Q tile to walk; dK and dV are zeros, written over NaN."""
    gen = torch.Generator(device=dev).manual_seed(8)
    q = _rand(gen, dev, 1, 4, 0, 128)
    k, v = _rand(gen, dev, 1, 2, 200, 128), _rand(gen, dev, 1, 2, 200, 128)
    o, do = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros((1, 4, 0), device=dev)
    _nan_fill_allocator(dev)
    dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                          fused=fused)
    torch.cuda.synchronize()
    assert dq.shape == q.shape
    assert torch.all(dk == 0) and torch.all(dv == 0)


def test_fused_backward_repeats(dev):
    """Two K4 runs on the same inputs: dK and dV bit for bit (each CTA sums
    its keys in a fixed order), dQ within one bf16 step of its largest
    value: its fp32 atomics add the key tiles' parts in the order they
    land, and a sum in another order can round to the neighbouring bf16
    (8 significant bits: 2^-7 of the largest |dQ| covers it)."""
    args = _bwd_inputs(dev, 1, 16, 4, 2048, 2048, 128, True, 0, seed=21)
    a = flash_attention_backward(*args, causal=True, fused=True)
    b_ = flash_attention_backward(*args, causal=True, fused=True)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b_[1]) and torch.equal(a[2], b_[2])
    top = a[0].float().abs().max().item()
    assert _err(a[0], b_[0]) <= 2.0 ** -7 * top


def test_forward_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    k8 = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.int8)
    sc = torch.ones(1, 2, 8, device=dev)
    with pytest.raises(NotImplementedError, match="stored as"):  # fp8 K
        flash_attention_forward(q, k8.to(torch.float8_e4m3fn), k8,
                                k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="need k_scale"):
        flash_attention_forward(q, k8, k8)
    with pytest.raises(TypeError, match="BlockSizes"):
        flash_attention_forward(q, q, q, block_sizes=object())
    # a tile no build has runs at the nearest built one (128 keys here)
    from cuda_flashattention_torch.ops.common import BlockSizes
    got = flash_attention_forward(q, q, q, block_sizes=BlockSizes(
        block_q=2048, block_k=2048))
    want = flash_attention_forward(q, q, q, block_sizes=BlockSizes(
        block_k=128))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The distributed layer on the card: the ranks of a mesh share card 0 (its
# entries repeat), each with its own streams.
# ---------------------------------------------------------------------------

def _ring_mesh(dev, n, axis="sp"):
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    return make_mesh((n,), (axis,), [dev] * n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("rows,d", [(1024, 128), (192, 64), (8192, 128)])
def test_device_ring_kernel(dev, n, rows, d):
    """K9 against its plain version and against (Σ x_i) @ W in fp32; the
    grid is capped at what is resident and walks the tiles."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    gen = torch.Generator(device=dev).manual_seed(n * rows + d)
    x, w = _rand(gen, dev, n * rows, d), _rand(gen, dev, d, d)
    mesh = _ring_mesh(dev, n)
    before = device_ring_matmul.launches
    o = device_ring_matmul(x, w, mesh)
    torch.cuda.synchronize()
    assert device_ring_matmul.launches == before + 1
    grid, ranks = device_ring_matmul.last_grid
    assert ranks == n and 1 <= grid <= rows // 64
    ref = (x.float().view(n, rows, d).sum(0) @ w.float()).repeat(n, 1)
    top = ref.abs().max().item()
    assert o.dtype == torch.float32 and top > 0
    assert _err(o, ref) <= min(1e-2, 2e-2 * top)
    assert _err(o, ring_matmul_plain(x, w, mesh)) <= min(1e-2, 2e-2 * top)


def test_device_ring_repeats_bit_for_bit(dev):
    """A race between a push and a read would show as a flake: 50 calls
    at 8 ranks must return the same bits."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    gen = torch.Generator(device=dev).manual_seed(0)
    x, w = _rand(gen, dev, 8 * 1024, 128), _rand(gen, dev, 128, 128)
    mesh = _ring_mesh(dev, 8)
    first = device_ring_matmul(x, w, mesh)
    for _ in range(50):
        assert torch.equal(device_ring_matmul(x, w, mesh), first)


def _ring_ref(x, w, n):
    rows, d = x.shape[0] // n, x.shape[1]
    return (x.float().view(n, rows, d).sum(0) @ w.float()).repeat(n, 1)


def test_device_ring_epochs_bit_for_bit(dev):
    """1000 back-to-back calls at 8 ranks on one workspace, whose flag
    words are never zeroed again (epochs 2 to 1001), return the first
    call's bits."""
    from cuda_flashattention_torch.parallel import device_ring
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    gen = torch.Generator(device=dev).manual_seed(1)
    x, w = _rand(gen, dev, 8 * 1024, 128), _rand(gen, dev, 128, 128)
    mesh = _ring_mesh(dev, 8)
    first = device_ring_matmul(x, w, mesh)
    (ws,) = [v for k, v in device_ring._workspaces.items()
             if k[:3] == ((dev,) * 8, 1024, 128)
             and k[3] == (torch.cuda.current_stream(dev).cuda_stream,)]
    epoch = ws.epoch
    same = sum(torch.equal(device_ring_matmul(x, w, mesh), first)
               for _ in range(1000))
    assert same == 1000 and ws.epoch == epoch + 1000
    assert _err(first, _ring_ref(x, w, 8)) <= 1e-2


def test_device_ring_alternating_shapes_and_streams(dev):
    """Calls that alternate shapes each keep their own workspace; calls
    that alternate two streams each keep theirs; every call returns its
    shape's first bits."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for n, rows, d in ((4, 1024, 128), (8, 192, 128), (2, 8192, 64),
                       (3, 640, 128)):
        x, w = _rand(gen, dev, n * rows, d), _rand(gen, dev, d, d)
        mesh = _ring_mesh(dev, n)
        first = device_ring_matmul(x, w, mesh)
        torch.cuda.synchronize()
        top = _ring_ref(x, w, n).abs().max().item()
        assert _err(first, _ring_ref(x, w, n)) <= min(1e-2, 2e-2 * top)
        cases.append((x, w, mesh, first))
    side = torch.cuda.Stream(device=dev)
    main = torch.cuda.current_stream(dev)
    outs = []
    for i in range(40):
        x, w, mesh, first = cases[i % len(cases)]
        stream = side if (i // len(cases)) % 2 else main
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            outs.append((device_ring_matmul(x, w, mesh), first))
        main.wait_stream(stream)
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o, first in outs)


def test_device_ring_two_streams_in_flight(dev):
    """Calls enqueued on two streams with no wait between them, so that
    kernels of both are in flight at once, each on its stream's
    workspace: every call returns its shape's first bits."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for n, rows in ((4, 1024), (8, 192)):
        x, w = _rand(gen, dev, n * rows, 128), _rand(gen, dev, 128, 128)
        mesh = _ring_mesh(dev, n)
        first = device_ring_matmul(x, w, mesh)
        cases.append((x, w, mesh, first))
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(main)  # the inputs and first calls, once
    outs = []
    for i in range(80):
        x, w, mesh, first = cases[(i // 2) % len(cases)]
        with torch.cuda.stream(side if i % 2 else main):
            outs.append((device_ring_matmul(x, w, mesh), first))
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o, first in outs)
    for (x, w, _, first), n in zip(cases, (4, 8)):
        ref = _ring_ref(x, w, n)
        assert _err(first, ref) <= min(1e-2, 2e-2 * ref.abs().max().item())


def test_device_ring_two_threads_share_a_stream(dev):
    """Two host threads call the ring on one stream at once: each call
    draws its epoch and launches under its workspace's lock, so the
    kernels run in the order of their epochs and every call returns the
    first call's bits."""
    import threading
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    gen = torch.Generator(device=dev).manual_seed(4)
    x, w = _rand(gen, dev, 8 * 1024, 128), _rand(gen, dev, 128, 128)
    mesh = _ring_mesh(dev, 8)
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        first = device_ring_matmul(x, w, mesh)
    start = threading.Barrier(2)
    outs, errors = [[], []], []

    def calls(k):
        try:
            with torch.cuda.stream(stream):
                start.wait()
                for _ in range(300):
                    outs[k].append(device_ring_matmul(x, w, mesh))
        except Exception as e:  # reported by the main thread below
            errors.append(e)

    threads = [threading.Thread(target=calls, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    torch.cuda.synchronize()
    assert len(outs[0]) == len(outs[1]) == 300
    assert all(torch.equal(o, first) for o in outs[0] + outs[1])
    ref = _ring_ref(x, w, 8)
    assert _err(first, ref) <= min(1e-2, 2e-2 * ref.abs().max().item())


@pytest.mark.parametrize("n,rows", [(8, 6400), (4, 8320), (3, 64 * 301)])
def test_device_ring_spans_that_do_not_divide_the_grid(dev, n, rows):
    """More tiles than CTAs per rank, not a multiple of them: the first
    spans are one tile longer, and some take two rounds."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    gen = torch.Generator(device=dev).manual_seed(n + rows)
    x, w = _rand(gen, dev, n * rows, 128), _rand(gen, dev, 128, 128)
    o = device_ring_matmul(x, w, _ring_mesh(dev, n))
    torch.cuda.synchronize()
    grid, ranks = device_ring_matmul.last_grid
    assert ranks == n and (rows // 64) % grid != 0 and grid < rows // 64
    ref = _ring_ref(x, w, n)
    assert _err(o, ref) <= min(1e-2, 2e-2 * ref.abs().max().item())


@pytest.mark.parametrize("n,rows,d", [(1, 8192, 64), (1, 64, 128),
                                      (8, 8192, 64), (1, 8192, 128)])
def test_device_ring_one_rank_and_narrow_width(dev, n, rows, d):
    """n = 1 (no hop, no flag) and d = 64 (one 64-column slab, four tiles
    per round) at the long shard."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    gen = torch.Generator(device=dev).manual_seed(n * d + rows)
    x, w = _rand(gen, dev, n * rows, d), _rand(gen, dev, d, d)
    mesh = _ring_mesh(dev, n)
    o = device_ring_matmul(x, w, mesh)
    torch.cuda.synchronize()
    assert device_ring_matmul.last_scope == "gpu"
    ref = _ring_ref(x, w, n)
    gate = min(1e-2, 2e-2 * ref.abs().max().item())
    assert _err(o, ref) <= gate
    assert _err(o, ring_matmul_plain(x, w, mesh)) <= gate


@pytest.mark.parametrize("n", [4, 8])
def test_device_ring_across_cards(dev, n):
    """With two or more cards visible: the ring over distinct cards (rank
    i on card i % cards, so n = 8 puts several ranks on a card), the .sys
    build, against the reference and the plain ring; 50 calls return the
    first call's bits."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    gen = torch.Generator(device=dev).manual_seed(n)
    x, w = _rand(gen, dev, n * 1024, 128), _rand(gen, dev, 128, 128)
    mesh = make_mesh((n,), ("sp",),
                     [torch.device("cuda", i % cards) for i in range(n)])
    first = device_ring_matmul(x, w, mesh)
    torch.cuda.synchronize()
    assert device_ring_matmul.last_scope == "sys"
    ref = _ring_ref(x, w, n)
    gate = min(1e-2, 2e-2 * ref.abs().max().item())
    assert _err(first, ref) <= gate
    assert _err(first, ring_matmul_plain(x, w, mesh)) <= gate
    for _ in range(50):
        assert torch.equal(device_ring_matmul(x, w, mesh), first)


@pytest.mark.parametrize("shape,axes", [
    ((4,), ("sp",)), ((2, 2), ("tp", "sp"))])
def test_model_parallel_across_cards(dev, shape, axes):
    """With two or more cards visible: a small bf16 model placed over
    distinct cards (rank i on card i % cards) by `shard_model` takes one
    train step with every layer on its rank; each rank's parameters sit
    on its card; loss and gradients against the same weights without a
    mesh (2e-2, 5e-2 relative L2), and every replica equal after the
    step."""
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    n = 1
    for s_ in shape:
        n *= s_
    mesh = make_mesh(shape, axes,
                     [torch.device("cuda", i % cards) for i in range(n)])
    kw = dict(seq_axis="sp", head_axis="tp" if "tp" in axes else None)
    cfg = tfm.TransformerConfig(vocab_size=1024, d_model=512, n_layers=2,
                                n_heads=8, n_kv_heads=4, d_head=64,
                                d_ff=1024, max_seq=2048)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tfm.Transformer(cfg, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device=dev)
    placed = tfm.shard_model(model, mesh, **kw)
    for r, tree in placed.weights().items():
        assert tree["embed"].device == mesh.device(r)
        assert tree["layers"][0]["wq"].device == mesh.device(r)
    loss = tfm.loss_fn(placed, tokens)
    loss.backward()
    placed.sync_grads()
    whole = tfm.gather_model(placed, dev)
    got = {name: p.grad.float() for name, p in whole.named_parameters()}
    whole.zero_grad(set_to_none=True)
    ref = tfm.loss_fn(whole, tokens)
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 2e-2
    for name, p in whole.named_parameters():
        want = p.grad.float()
        err = ((got[name] - want).norm() / want.norm()).item()
        assert err <= 5e-2, f"{name}: relative L2 {err:.3e}"
    tfm.make_train_step(placed, torch.optim.SGD(placed.parameters(),
                                                lr=1e-2))(tokens)
    torch.cuda.synchronize()
    w = placed.weights()
    for r in w:
        assert torch.equal(w[r]["embed"].cpu(), w[0]["embed"].cpu())
        assert torch.equal(w[r]["layers"][1]["mlp_norm"].cpu(),
                           w[0]["layers"][1]["mlp_norm"].cpu())


def test_device_ring_refuses_what_it_does_not_take(dev):
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    gen = torch.Generator(device=dev).manual_seed(0)
    x, w = _rand(gen, dev, 4 * 64, 128), _rand(gen, dev, 128, 128)
    mesh = _ring_mesh(dev, 4)
    # fp32 x and w have a build since K9's F32 one, fp16 the fp16 unit's,
    # and mixed types run the fp32 build on x and w upcast
    ref = _ring_ref(x, w, 4)
    for xx, ww in ((x.float(), w), (x.half(), w.half())):
        assert _err(device_ring_matmul(xx, ww, mesh), ref) <= 1e-3
    with pytest.raises(NotImplementedError, match="bf16, fp16 or fp32"):
        device_ring_matmul(x.to(torch.int8), w, mesh)
    with pytest.raises(ValueError, match="multiple of 64"):
        device_ring_matmul(x[:4 * 40], w, mesh)
    # any d up to 256 runs (padded to the next build); past it, no build
    x300 = _rand(gen, dev, 4 * 64, 300)
    with pytest.raises(ValueError, match="ring takes d from 1 to 256"):
        device_ring_matmul(x300, _rand(gen, dev, 300, 300), mesh)
    with pytest.raises(ValueError, match="every rank on a card"):
        device_ring_matmul(x, w, make_mesh((4,), ("sp",), ["cpu"] * 4))


@pytest.mark.parametrize("causal,window,n,h_kv", [
    (True, 0, 2048, 8), (False, 0, 2000, 2), (True, 512, 2048, 2),
    (True, 3000, 2048, 8)])
def test_ring_attention_on_the_card(dev, causal, window, n, h_kv):
    """The ring over 4 ranks against one call on the whole sequence,
    forward and gradients; the launch counts show what each step ran."""
    from cuda_flashattention_torch.parallel.ring import ring_attention
    gen = torch.Generator(device=dev).manual_seed(n + window)
    q = _rand(gen, dev, 1, 8, n, 128).requires_grad_()
    k = _rand(gen, dev, 1, h_kv, n, 128).requires_grad_()
    v = _rand(gen, dev, 1, h_kv, n, 128).requires_grad_()
    do = _rand(gen, dev, 1, 8, n, 128)
    forms = flash_attention_forward.form_launches
    before = sum(forms[f] for f in ("online", "bound", "kmajor"))
    before_bwd = flash_attention_backward.launches["fused"]
    o = ring_attention(q, k, v, _ring_mesh(dev, 4), causal=causal,
                       window=window)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    if not causal:
        steps = 16
    elif window:
        steps = {2: 7, 4: 10}[min(4, -(-window // 512) + 1)]
    else:
        steps = 10
    assert sum(forms[f] for f in ("online", "bound", "kmajor")
               ) == before + steps
    assert flash_attention_backward.launches["fused"] == before_bwd + steps
    ref = flash_attention(q, k, v, causal=causal, window=window)
    grads_ref = torch.autograd.grad(ref, (q, k, v), do)
    assert _err(o, ref) <= GATE
    for g, want in zip(grads, grads_ref):
        top = want.float().abs().max().item()
        assert top > 0 and _err(g, want) <= BWD_GATE * top


@pytest.mark.parametrize("qtype", [None, "int8", "mixed"])
@pytest.mark.parametrize("window", [0, 700])
def test_ring_decode_on_the_card(dev, qtype, window):
    """K6 on each rank's resident shard, reduced once, against K6 on the
    whole cache; one launch per rank."""
    from cuda_flashattention_torch.parallel.mesh import shard_on_axis
    from cuda_flashattention_torch.parallel.ring import ring_decode
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _rand(gen, dev, 4, 16, 128) * 8
    k, v = _rand(gen, dev, 4, 4, 2048, 128) * 4, _rand(gen, dev, 4, 4, 2048,
                                                       128)
    lengths = torch.tensor([1, 900, 1537, 2048], dtype=torch.int32,
                           device=dev)
    mesh = _ring_mesh(dev, 4)
    scales = {}
    if qtype:
        kv = quantize_kv(k, v, qtype)
        k, v = kv.k_q, kv.v_q
        scales = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
    cut = lambda x: shard_on_axis(mesh, x, 2, "sp")
    before = decode_attention.launches
    o, lse = ring_decode(q, cut(k), cut(v), lengths, mesh, window=window,
                         **{n: cut(s) for n, s in scales.items()})
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 4
    o_w, lse_w = decode_attention(q, k, v, lengths, window=window, **scales)
    top = o_w.float().abs().max().item()
    assert top > 0 and _err(o, o_w) <= min(GATE, 2e-2 * top)
    assert _err(lse, lse_w) <= GATE
    o_g, lse_g = ring_decode(q, k, v, lengths, mesh, window=window, **scales)
    assert torch.equal(o_g, o) and torch.equal(lse_g, lse)


def test_ulysses_and_gpipe_on_the_card(dev):
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.parallel.ulysses import ulysses_attention
    gen = torch.Generator(device=dev).manual_seed(5)
    q = _rand(gen, dev, 1, 8, 2048, 128).requires_grad_()
    k = _rand(gen, dev, 1, 2, 2048, 128).requires_grad_()
    v = _rand(gen, dev, 1, 2, 2048, 128).requires_grad_()
    do = _rand(gen, dev, 1, 8, 2048, 128)
    o = ulysses_attention(q, k, v, _ring_mesh(dev, 4), causal=True)
    grads = torch.autograd.grad(o, (q, k, v), do)
    ref = flash_attention(q, k, v, causal=True)
    grads_ref = torch.autograd.grad(ref, (q, k, v), do)
    assert _err(o, ref) <= GATE
    for g, want in zip(grads, grads_ref):
        top = want.float().abs().max().item()
        assert top > 0 and _err(g, want) <= BWD_GATE * top

    cfg = tfm.TransformerConfig(vocab_size=512, d_model=256, n_layers=4,
                                n_heads=4, n_kv_heads=2, d_head=64, d_ff=512,
                                max_seq=512)
    model = tfm.Transformer(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, 512, (4, 512), generator=gen, device=dev)
    with torch.no_grad():
        want = tfm.forward(model, tokens)
        got = tfm.pipeline_forward(model, tokens, _ring_mesh(dev, 2, "pp"),
                                   n_micro=2)
    assert _err(got, want) <= 0.125


# ---------------------------------------------------------------------------
# The online forward (K1) and FA1 (K8) on the Hopper body: the edges of the
# packed 128-row walk
# ---------------------------------------------------------------------------

def _online(args, **kw):
    """One K1 launch (softmax pinned online), checked for its count."""
    before = _form_counts()
    got = flash_attention_forward(*args, softmax="online", **kw)
    torch.cuda.synchronize()
    after = _form_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "online": 1, "bound": 0, "kmajor": 0, "fallback": 0}
    return got


# group sizes 1, 2, 4, 8, 16 pack 1..16 heads into a tile of R = 128 / Gp
# positions; Nq = 203 is a multiple of none of the R
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, kv_offset=-37),
    dict(causal=True, kv_offset=90, window=77),
    dict(causal=False),
])
def test_forward_online_every_packing(dev, group, kw):
    args, _ = _fwd_inputs(dev, 2, 16, 16 // group, 203, 293, 128, None,
                          group)
    _nan_fill_allocator(dev)
    kw = dict(kw, out_dtype=torch.float32)
    _assert_fwd_close(_online(args, **kw),
                      flash_attention_forward_plain(*args, softmax="online",
                                                    **kw))


# kv_offset below and above 0, and windows whose edge falls inside a tile,
# at d = 64 and 128, fp32 and bf16 O, over bf16 and one-byte K/V
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype", [None, "int8", "mixed"])
@pytest.mark.parametrize("d,kw", [
    (64, dict(causal=True, kv_offset=-150)),
    (128, dict(causal=True, kv_offset=333)),
    (64, dict(causal=True, window=45, kv_offset=19)),
    (128, dict(causal=True, window=100, kv_offset=-31)),
])
def test_forward_online_offsets_and_window_edges(dev, out_dtype, qtype, d,
                                                 kw):
    args, scales = _fwd_inputs(dev, 1, 8, 2, 250, 400, d, qtype, d + 7)
    _nan_fill_allocator(dev)
    kw = dict(kw, out_dtype=out_dtype, **scales)
    got = _online(args, **kw)
    assert got[0].dtype == out_dtype
    _assert_fwd_close(got, flash_attention_forward_plain(
        *args, softmax="online", **kw))


@pytest.mark.parametrize("qtype", [None, "int8"])
@pytest.mark.parametrize("group,causal", [(4, True), (8, False), (16, True)])
def test_forward_online_segments_packed(dev, qtype, group, causal):
    """Segment ids with Gp > 1 heads in a tile, and a query segment that
    no key carries: its rows stay empty (O = 0, LSE = NEG_INF)."""
    n = 300
    args, scales = _fwd_inputs(dev, 2, 16, 16 // group, n, n, 64, qtype, 3)
    qseg = _segments(dev, 2, n, [70, 1, 129, 100])
    kseg = qseg.clone()
    kseg[kseg == 2] = 7  # no key of segment 2: rows 71..199 see nothing
    kw = dict(causal=causal, q_segment_ids=qseg, kv_segment_ids=kseg,
              out_dtype=torch.float32, **scales)
    _nan_fill_allocator(dev)
    o, lse = _online(args, **kw)
    assert torch.all(o[:, :, 71:200] == 0)
    assert torch.all(lse[:, :, 71:200] == -1e30)
    _assert_fwd_close((o, lse), flash_attention_forward_plain(
        *args, softmax="online", **kw))


@pytest.mark.parametrize("d", [64, 128])
def test_forward_online_guard(dev, d):
    """The guarded launch writes nothing while the guard is 0 and the
    unguarded launch's bits when it is 1, at 64 and 128 keys a tile."""
    import ctypes
    from cuda_flashattention_torch import _build
    from cuda_flashattention_torch.ops import flash_fwd as ff
    (q, k, v), _ = _fwd_inputs(dev, 1, 8, 2, 150, 220, d, None, 4)
    q_hat = ff._prescale_q(q, ff.resolve_scale(None, d))
    strides = (ctypes.c_longlong * 9)(*q_hat.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    for flag, kn in ((0, 64), (1, 64), (0, 128), (1, 128)):
        want = flash_attention_forward(q, k, v, causal=True,
                                       softmax="online",
                                       out_dtype=torch.float32,
                                       block_sizes=_tiles(kn))
        guard = torch.tensor([flag], dtype=torch.int32, device=dev)
        o = torch.full_like(want[0], 7.0)
        lse = torch.full_like(want[1], 7.0)
        err = _build.library().cfa_flash_fwd(
            ff._ptrs(q_hat, k, v, None, None, None, None, guard, o, lse),
            1, 8, 2, 150, 220, d, strides, 0, 0, 0, 1, 0, 0, 1, kn,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        if flag:
            assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
        else:
            assert torch.all(o == 7.0) and torch.all(lse == 7.0)


@pytest.mark.parametrize("group,qtype", [(4, None), (1, "int8")])
def test_forward_online_tile_order_changes_no_bit(dev, group, qtype):
    """A causal call whose kv_offset lets every query see every key takes
    the non-causal call's tiles and masks, but issues its Q tiles heaviest
    first where the other issues them in order: both give the same bits
    (each CTA computes its tile alone, and the reordered grid still covers
    every tile of every head group and batch once)."""
    nk = 1100
    args, scales = _fwd_inputs(dev, 2, 8, 8 // group, 1000, nk, 128, qtype,
                               6)
    kw = dict(out_dtype=torch.bfloat16, **scales)
    causal = _online(args, causal=True, kv_offset=nk, **kw)
    plain = _online(args, causal=False, **kw)
    assert torch.equal(causal[0], plain[0])
    assert torch.equal(causal[1], plain[1])


# every renormalising block the kernel takes, a block over all keys of a
# short Nk, ragged N; peaked inputs so that a wrong renormalisation shows
@pytest.mark.parametrize("block_k", [64, 128, 192, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nq,nk,d", [(1000, 1000, 128), (333, 250, 64),
                                     (70, 777, 128)])
def test_fa1_kernel_block_plans(dev, block_k, causal, nq, nk, d):
    args, _ = _fwd_inputs(dev, 1, 4, 4, nq, nk, d, None, block_k + nq)
    _nan_fill_allocator(dev)
    before = fa1_attention.launches
    o = fa1_attention(*args, causal=causal, block_k=block_k)
    torch.cuda.synchronize()
    assert fa1_attention.launches == before + 1
    o_p = fa1_attention_plain(*args, causal=causal, block_q=256,
                              block_k=max(8, min(block_k, -(-nk // 8) * 8)))
    ref = o_p.float().abs().max().item()
    assert ref > 0 and torch.isfinite(o.float()).all()
    assert _err(o, o_p) <= min(GATE, REL_GATE * ref)


# ---------------------------------------------------------------------------
# K3 (the split backward's dQ, a Q-major wgmma + TMA walk) at its tile
# edges, and K6 / K7 split over the context
# ---------------------------------------------------------------------------


def _split_backward(dev, b, h, h_kv, nq, nk, d, seed, **kw):
    """K2 + K3 (fused=False) into NaN-filled memory against the plain
    backward; dQ must be finite, and all three gradients within the gate,
    or all zero where the plain ones are (no row sees a key). Returns
    dQ."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = _rand(gen, dev, b, h, nq, d), _rand(gen, dev, b, h, nq, d)
    k, v = _rand(gen, dev, b, h_kv, nk, d), _rand(gen, dev, b, h_kv, nk, d)
    o, lse = flash_attention_forward(q, k, v, **kw)
    args = (q, k, v, o, lse, do)
    _nan_fill_allocator(dev)
    before = flash_attention_backward.launches["dq"]
    got = flash_attention_backward(*args, fused=False, **kw)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches["dq"] == before + 1
    assert torch.isfinite(got[0]).all()
    want = flash_attention_backward_plain(*args, **kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert g.dtype == w.dtype and g.shape == w.shape
        if torch.all(w == 0):
            assert torch.all(g == 0), name
        else:
            _assert_rel(g, w, name)
    return got[0]


@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,causal,kv_offset", [
    (1, 4, 4, 63, 100, 128, True, 37),
    (1, 4, 4, 64, 64, 128, False, 0),
    (2, 4, 4, 65, 130, 128, True, 65),     # kv_offset crossing a key tile
    (1, 4, 2, 127, 300, 128, True, 173),
    (1, 4, 4, 129, 129, 128, True, 0),
    (1, 8, 8, 129, 1000, 128, False, 0),
    (1, 16, 4, 129, 200, 64, True, 71),    # GQA 16:4, d = 64
    (2, 16, 4, 1000, 777, 64, False, 0),
    (1, 12, 4, 100, 300, 128, True, -30),  # three heads packed per tile
])
def test_dq_kernel_tile_edges(dev, b, h, h_kv, nq, nk, d, causal, kv_offset):
    _split_backward(dev, b, h, h_kv, nq, nk, d, seed=nq + nk + d,
                    causal=causal, kv_offset=kv_offset)


@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,window,kv_offset", [
    (1, 4, 4, 129, 300, 128, 64, 171),     # windows ending inside tiles
    (1, 16, 4, 65, 700, 64, 63, 600),
    (2, 8, 2, 300, 300, 128, 129, 0),
    (1, 4, 4, 100, 100, 128, 30, 150),     # windows starting past the keys
])
def test_dq_kernel_window(dev, b, h, h_kv, nq, nk, d, window, kv_offset):
    dq = _split_backward(dev, b, h, h_kv, nq, nk, d, seed=window + nq,
                         causal=True, window=window, kv_offset=kv_offset)
    # where no row sees a key, K3 walks no tile and writes its zeros
    assert torch.all(dq == 0) == (kv_offset - window + 1 >= nk)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,h_kv,d", [(4, 4, 128), (16, 4, 64)])
def test_dq_kernel_segments_at_tile_edges(dev, causal, h, h_kv, d):
    """Segments ending one key before, at, and one key after 64-key tile
    edges, and one of a single token."""
    n = 300
    seg = torch.repeat_interleave(
        torch.arange(5, device=dev),
        torch.tensor([63, 1, 65, 128, 43], device=dev))[None].expand(2, n)
    _split_backward(dev, 2, h, h_kv, n, n, d, seed=d, causal=causal,
                    q_segment_ids=seg, kv_segment_ids=seg)


def _split_keys(dev, b, h, h_kv, d):
    from cuda_flashattention_torch.ops.decode import split_size, tile_rows
    rows = h // h_kv
    return split_size(b, h_kv, -(-rows // tile_rows(rows)), d)


@pytest.mark.parametrize("kw", [
    dict(), dict(window="C+3"), dict(windows=[0, 1, 5, 130, 4224, 200]),
    dict(quantize_q=True), dict(quantize_q=True, window="C+3"),
])
@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
def test_decode_split_edges(dev, qtype, kw):
    """Lengths 0, 1, C − 1, C, C + 1 and 4224 (C: the split size the host
    rule gives this shape), windows that start inside a split, on peaked
    inputs: K6 against its plain version, two calls bit-identical, and K7
    over pools of 16- and 128-token pages bit-equal to K6 on the same
    keys."""
    b, h, h_kv, d, max_n = 6, 16, 4, 128, 4230
    c = _split_keys(dev, b, h, h_kv, d)
    assert c < max_n  # the shape splits
    lengths = [0, 1, c - 1, c, c + 1, 4224]
    gen = torch.Generator(device=dev).manual_seed(c)
    q = _rand(gen, dev, b, h, d) * 8
    k = _rand(gen, dev, b, h_kv, max_n, d) * 4
    v = _rand(gen, dev, b, h_kv, max_n, d)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(kw)
    if kw.get("window") == "C+3":
        kw["window"] = c + 3
    if "windows" in kw:
        kw["windows"] = torch.tensor(kw["windows"], dtype=torch.int32,
                                     device=dev)
    scales = {}
    kq, vq = k, v
    if qtype is not None:
        kv = quantize_kv(k, v, qtype)
        kq, vq = kv.k_q, kv.v_q
        scales = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
    _nan_fill_allocator(dev)
    before = decode_attention.launches
    o, lse = decode_attention(q, kq, vq, lens, **scales, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    o_p, lse_p = decode_attention_plain(q, kq, vq, lens, **scales, **kw)
    top = o_p.float().abs().max().item()
    assert top > 0 and _err(o, o_p) <= min(GATE, REL_GATE * top)
    assert _err(lse, lse_p) <= GATE
    assert torch.all(o[0] == 0) and torch.all(lse[0] == -1e30)
    o2, lse2 = decode_attention(q, kq, vq, lens, **scales, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for page in (16, 128):
        cache, (kq2, vq2, ks2, vs2) = _paged_copy(
            dev, k, v, lengths, page, -(-4224 // page) + 2, qtype, gen)
        o_k, lse_k = paged_decode_step(q, cache, **kw)
        torch.cuda.synchronize()
        o_c, lse_c = decode_attention(q, kq2, vq2, lens, k_scale=ks2,
                                      v_scale=vs2, **kw)
        assert torch.equal(o_k, o_c) and torch.equal(lse_k, lse_c), page


@pytest.mark.parametrize("d", [64, 128])
def test_decode_split_sizes_agree(dev, d):
    """Forcing other split sizes moves the result by fp32 rounding only:
    every size meets the plain version, the unsplit walk included."""
    from cuda_flashattention_torch.ops import decode as dec
    b, h, h_kv, max_n = 8, 16, 4, 4224
    gen = torch.Generator(device=dev).manual_seed(d)
    q = _rand(gen, dev, b, h, d) * 8
    k = _rand(gen, dev, b, h_kv, max_n, d) * 4
    v = _rand(gen, dev, b, h_kv, max_n, d)
    lens = torch.tensor([4224, 640, 1, 0, 127, 128, 129, 3000],
                        dtype=torch.int32, device=dev)
    o_p, lse_p = decode_attention_plain(q, k, v, lens)
    top = o_p.float().abs().max().item()
    keys = dec.SPLIT_KEYS
    try:
        for size in (32, 64, 128, 256, 512, 1 << 20):
            dec.SPLIT_KEYS = size
            o, lse = decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            assert _err(o, o_p) <= min(GATE, REL_GATE * top), size
            assert _err(lse, lse_p) <= GATE, size
    finally:
        dec.SPLIT_KEYS = keys


# ---------------------------------------------------------------------------
# fp32 inputs: the fp32 builds of K1, K1b, K5 (forward) and K4, K2
# (backward) against the plain fp32 versions. Gates: O and LSE within 1e-4,
# each gradient within 1e-4 · max(1, max |plain|), on flat inputs
# (uniform ±0.5) and peaked ones (Q x8, K x4). The plain versions run with
# TF32 off, so that they are fp32 products.
# ---------------------------------------------------------------------------

F32_GATE = 1e-4


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _f32_inputs(dev, b, h, h_kv, nq, nk, d, seed, peaked):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5
    q, k, v = u(b, h, nq, d), u(b, h_kv, nk, d), u(b, h_kv, nk, d)
    if peaked:
        q, k = q * 8, k * 4
    return q, k, v


def _assert_f32_fwd(got, want, lse_scale=1.0):
    """O within the fp32 gate, LSE within it times `lse_scale` (scores of
    a magnitude past the bar's inputs carry their relative error)."""
    (o, lse), (o_p, lse_p) = got, want
    assert o.dtype == o_p.dtype and lse.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert o_p.abs().max().item() > 0, "the plain O is all zero"
    assert _err(o, o_p) <= F32_GATE, _err(o, o_p)
    assert _err(lse, lse_p) <= F32_GATE * lse_scale, _err(lse, lse_p)


def _assert_f32_grad(got, want, name):
    assert got.dtype == torch.float32 and got.shape == want.shape
    top = want.abs().max().item()
    assert top > 0, f"{name}: the plain gradient is all zero"
    assert _err(got, want) <= F32_GATE * max(1.0, top), (name, _err(got,
                                                                   want))


_F32_SHAPES = [
    # (b, h, h_kv, nq, nk, d, kw)
    (1, 1, 1, 512, 512, 64, dict()),                         # 02_fwd's
    (2, 8, 2, 300, 200, 128, dict(causal=True, kv_offset=100)),  # GQA 4
    (1, 4, 4, 70, 130, 64, dict(causal=True, kv_offset=-20)),    # empty rows
    (1, 16, 4, 257, 257, 128, dict(causal=True)),            # GQA 16:4
    (2, 4, 1, 200, 333, 64, dict(causal=True, window=90, kv_offset=133)),
    (1, 8, 8, 130, 500, 128, dict()),
]


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("form", ["online", "bound", "kmajor"])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", _F32_SHAPES)
def test_f32_forward_kernels(dev, no_tf32, form, peaked, b, h, h_kv, nq, nk,
                             d, kw):
    """K1 (online), K1b and K5 (each pinned) on fp32 Q/K/V against the
    plain fp32 version: one launch of the form, fp32 O, 1e-4."""
    q, k, v = _f32_inputs(dev, b, h, h_kv, nq, nk, d, nq + nk, peaked)
    _nan_fill_allocator(dev)
    before = _form_counts()
    if form == "online":
        got = flash_attention_forward(q, k, v, softmax="online", **kw)
        want = flash_attention_forward_plain(q, k, v, softmax="online", **kw)
    else:
        got = _pinned(form, q, k, v, **kw)
        want = flash_attention_forward_plain(
            q, k, v, softmax="bound_unchecked", **kw)
    torch.cuda.synchronize()
    after = _form_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "online": int(form == "online"), "bound": int(form == "bound"),
        "kmajor": int(form == "kmajor"), "fallback": 0}
    _assert_f32_fwd(got, want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_f32_forward_auto_and_bf16_out(dev, no_tf32, out_dtype):
    """What "auto" routes fp32 to (K1b with its guarded fallback at the
    ladder's non-causal shape; K5 on a causal call past 5120 rows; K1 on a
    short causal one), O in fp32 or bf16."""
    cases = [((1, 1, 1, 1000, 1000, 64), dict(), "bound"),
             ((1, 2, 2, 5200, 5200, 64), dict(causal=True), "kmajor"),
             ((1, 2, 1, 600, 600, 128), dict(causal=True), "online")]
    for shape, kw, form in cases:
        q, k, v = _f32_inputs(dev, *shape, 11, False)
        before = _form_counts()
        got = flash_attention_forward(q, k, v, out_dtype=out_dtype, **kw)
        want = flash_attention_forward_plain(q, k, v, out_dtype=out_dtype,
                                             **kw)
        torch.cuda.synchronize()
        grown = {n: _form_counts()[n] - before[n] for n in before}
        assert grown[form] == 1, (form, grown)
        assert got[0].dtype == out_dtype
        if out_dtype == torch.float32:
            _assert_f32_fwd(got, want)
        else:  # one bf16 rounding of O apart at most
            assert _err(got[0], want[0]) <= 2 ** -8
            assert _err(got[1], want[1]) <= F32_GATE


@pytest.mark.parametrize("causal", [True, False])
def test_f32_forward_segments(dev, no_tf32, causal):
    """fp32 K1 under segment ids (its SEG build), against the plain
    version."""
    b, h, n, d = 2, 4, 300, 64
    q, k, v = _f32_inputs(dev, b, h, h, n, n, d, 3, True)
    ids = torch.arange(n, device=dev) // 70
    seg = torch.stack([ids, (ids + 1) % 3])
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    got = flash_attention_forward(q, k, v, **kw)
    want = flash_attention_forward_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_f32_fwd(got, want)


def test_f32_loose_bound_falls_back_to_online(dev, no_tf32):
    """A loose bound on fp32 inputs (anti-aligned Q and K of huge norm):
    K1b counts the rows and the guarded fp32 K1 rewrites them."""
    b, h, n, d = 1, 2, 256, 64
    q, k, v = _f32_inputs(dev, b, h, h, n, n, d, 5, False)
    q = q.abs() * 40
    k = -k.abs() * 40
    k[:, :, 0] = k[:, :, 0].abs()  # one key far above the rows' scores
    before = _form_counts()
    got = flash_attention_forward(q, k, v, softmax="bound")
    want = flash_attention_forward_plain(q, k, v, softmax="online")
    torch.cuda.synchronize()
    after = _form_counts()
    assert after["bound"] - before["bound"] == 1
    assert after["fallback"] - before["fallback"] == 1
    # the rows' LSE is ~1000 (inputs x40): held relative to it
    _assert_f32_fwd(got, want, lse_scale=want[1].abs().max().item())


_F32_BWD_SHAPES = [
    # (b, h, h_kv, nq, nk, d, kw)
    (1, 4, 4, 512, 512, 64, dict(causal=True)),
    (2, 8, 2, 300, 200, 128, dict(causal=True, kv_offset=100)),
    (1, 4, 2, 70, 260, 64, dict(causal=True, kv_offset=-20)),
    (1, 16, 4, 257, 257, 128, dict(causal=True)),
    (2, 4, 1, 200, 333, 64, dict(causal=True, window=90, kv_offset=133)),
    (1, 8, 8, 130, 500, 128, dict()),
]


def _f32_bwd_inputs(dev, b, h, h_kv, nq, nk, d, kw, peaked, seed):
    q, k, v = _f32_inputs(dev, b, h, h_kv, nq, nk, d, seed, peaked)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.rand((b, h, nq, d), generator=gen, device=dev) - 0.5
    o, lse = flash_attention_forward_plain(q, k, v, softmax="online", **kw)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", _F32_BWD_SHAPES)
def test_f32_backward_kernels(dev, no_tf32, peaked, b, h, h_kv, nq, nk, d,
                              kw):
    """K4 (fused) and K2 (dK/dV alone) on fp32 inputs against the plain
    fp32 backward: fp32 gradients within 1e-4 · max(1, max |plain|)."""
    from cuda_flashattention_torch.ops import flash_bwd as fb
    args = _f32_bwd_inputs(dev, b, h, h_kv, nq, nk, d, kw, peaked, nq + nk)
    want = flash_attention_backward_plain(*args, **kw)
    _nan_fill_allocator(dev)
    before = dict(flash_attention_backward.launches)
    got = flash_attention_backward(*args, **kw)
    dk2, dv2 = fb._dkdv_cuda(*args, **kw)
    torch.cuda.synchronize()
    after = flash_attention_backward.launches
    assert {n: after[n] - before[n] for n in after} == {
        "fused": 1, "dkdv": 1, "dq": 0, "delta": 2}
    for g, w, name in zip((*got, dk2, dv2), (*want, *want[1:]),
                          ("dQ", "dK", "dV", "K2 dK", "K2 dV")):
        _assert_f32_grad(g, w, name)
    # K2 and K4 share the dK/dV walk: the same bits
    assert torch.equal(dk2, got[1]) and torch.equal(dv2, got[2])


@pytest.mark.parametrize("causal", [True, False])
def test_f32_backward_segments(dev, no_tf32, causal):
    """K4's fp32 SEG build against the plain fp32 backward."""
    b, h, n, d = 2, 4, 300, 128
    ids = torch.arange(n, device=dev) // 70
    seg = torch.stack([ids, (ids + 1) % 3])
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    q, k, v, _, _, do = _f32_bwd_inputs(dev, b, h, h, n, n, d, {}, True, 9)
    o, lse = flash_attention_forward_plain(q, k, v, **kw)
    want = flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    got = flash_attention_backward(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        _assert_f32_grad(g, w, name)


def test_f32_split_backward_raises_before_any_launch(dev):
    """fused=False takes fp32 since K3's fp32 build (test_f32_split_*);
    fp32 q/k/v with a bf16 dO, once refused here, runs K2 + K3's fp32
    builds on dO upcast (P rounded to bf16 before dV, as JAX rounds it),
    once each behind the prologue; an integer dO still raises before any
    launch."""
    args = _f32_bwd_inputs(dev, 1, 2, 2, 64, 64, 64, {}, False, 1)
    args = (*args[:5], args[5].to(torch.bfloat16))
    before = dict(flash_attention_backward.launches)
    got = flash_attention_backward(*args, fused=False)
    want = flash_attention_backward_plain(*args)
    torch.cuda.synchronize()
    after = flash_attention_backward.launches
    assert {n: after[n] - before[n] for n in after} == {
        "dkdv": 1, "dq": 1, "fused": 0, "delta": 1}
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert g.dtype == torch.float32
        top = w.abs().max().item()
        assert _err(g, w) <= 1e-4 * max(1.0, top) + 2.0 ** -7 * top, name
    bad = (*args[:5], args[5].to(torch.int8))
    before = dict(flash_attention_backward.launches)
    with pytest.raises(NotImplementedError, match="bf16, fp16 or fp32"):
        flash_attention_backward(*bad, fused=False)
    assert flash_attention_backward.launches == before


def test_f32_autograd_through_the_kernels(dev, no_tf32):
    """flash_attention on fp32 [B,N,H,d] views: K1 once and K4 once, fp32
    gradients within the fp32 gate of the plain backward."""
    gen = torch.Generator(device=dev).manual_seed(3)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5
    q = u(2, 300, 8, 128).transpose(1, 2).requires_grad_(True)
    k = u(2, 300, 2, 128).transpose(1, 2).requires_grad_(True)
    v = u(2, 300, 2, 128).transpose(1, 2).requires_grad_(True)
    do = u(2, 300, 8, 128).transpose(1, 2)
    fwd0 = flash_attention_forward.launches
    bwd0 = flash_attention_backward.launches["fused"]
    o = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), grad_outputs=do)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32
    assert flash_attention_forward.launches == fwd0 + 1
    assert flash_attention_backward.launches["fused"] == bwd0 + 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o_p, lse = flash_attention_forward_plain(qd, kd, vd, causal=True)
    assert _err(o, o_p) <= F32_GATE
    want = flash_attention_backward_plain(qd, kd, vd, o_p, lse, do,
                                          causal=True)
    for g, w, name in zip(grads, want, ("dQ", "dK", "dV")):
        _assert_f32_grad(g, w, name)


# ---------------------------------------------------------------------------
# fp32 and narrow heads in decode: K6 and K7 on an fp32 q (over an fp32,
# int8, fp8 or mixed cache) and at d in {16, 32}, against the plain
# versions on flat (uniform ±0.5) and peaked (Q x8, K x4) inputs. Gates: an
# fp32 q within 1e-4 on O and LSE (under `quantize_q` P is rounded to bf16,
# as in the JAX body, and the bf16 gate holds); bf16 within 5e-3, and O
# also within 2e-2 · max |plain|. K7 bit for bit against K6 on the same
# keys. The forward (K1, K1b, K5) and K4 at d in {16, 32}: zero-padded
# heads at the caller's scale, against the plain versions at d.
# ---------------------------------------------------------------------------

_NARROW_FORMS = [dict(), dict(window=100),
                 dict(windows=[5, 300, 64, 1, 0, 130]), dict(quantize_q=True)]


def _decode_inputs(dev, dtype, b, h, h_kv, max_n, d, seed, peaked):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5
    q, k, v = u(b, h, d), u(b, h_kv, max_n, d), u(b, h_kv, max_n, d)
    if peaked:
        q, k = q * 8, k * 4
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _stored(k, v, qtype):
    """(k, v, scale kwargs) as a cache of `qtype` holds them."""
    if qtype is None:
        return k, v, {}
    kv = quantize_kv(k, v, qtype)
    return kv.k_q, kv.v_q, dict(k_scale=kv.k_scale, v_scale=kv.v_scale)


def _assert_decode_close(got, want, dtype, quantize_q, peaked):
    (o, lse), (o_p, lse_p) = got, want
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    top = o_p.float().abs().max().item()
    assert top > 0, "the plain O is all zero"
    gate = F32_GATE if dtype == torch.float32 and not quantize_q else GATE
    e_o, e_l = _err(o, o_p), _err(lse, lse_p)
    assert e_o <= gate and e_l <= gate, (e_o, e_l, gate)
    if peaked and dtype == torch.bfloat16:
        assert e_o <= REL_GATE * top, (e_o, top)


@pytest.mark.parametrize("kw", _NARROW_FORMS)
@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_narrow_heads_and_f32(dev, no_tf32, dtype, d, qtype, kw):
    """K6 at d = 16 and 32, on a bf16 or fp32 q over a cache in q's dtype
    or a quantized one, with every window form and `quantize_q`; NaN past
    each live context; one launch per call."""
    b, h, h_kv, max_n = 6, 8, 2, 300
    lengths = [300, 1, 129, 64, 0, 250]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(kw)
    if "windows" in kw:
        kw["windows"] = torch.tensor(kw["windows"], dtype=torch.int32,
                                     device=dev)
    for peaked in (False, True):
        q, k, v = _decode_inputs(dev, dtype, b, h, h_kv, max_n, d, d,
                                 peaked)
        k, v, scales = _stored(k, v, qtype)
        for i, n in enumerate(lengths):
            for x in (scales.values() if scales else (k, v)):
                x[i, :, n:] = float("nan")
        _nan_fill_allocator(dev)
        before = decode_attention.launches
        got = decode_attention(q, k, v, lens, **scales, **kw)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        want = decode_attention_plain(q, k, v, lens, **scales, **kw)
        qq = kw.get("quantize_q", False) and qtype in ("int8", "mixed")
        _assert_decode_close(got, want, dtype, qq, peaked)
        assert torch.all(got[0][4] == 0) and torch.all(got[1][4] == -1e30)


@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_f32_wide_heads(dev, no_tf32, d, qtype):
    """K6's fp32 builds at d = 64 and 128 (the serving model's width),
    with 4 query rows per KV head and a split context."""
    b, h, h_kv, max_n = 8, 16, 4, 1100
    lengths = [1100, 1, 640, 0, 999, 128, 513, 77]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for peaked in (False, True):
        q, k, v = _decode_inputs(dev, torch.float32, b, h, h_kv, max_n, d,
                                 d + 1, peaked)
        k, v, scales = _stored(k, v, qtype)
        got = decode_attention(q, k, v, lens, **scales)
        torch.cuda.synchronize()
        want = decode_attention_plain(q, k, v, lens, **scales)
        _assert_decode_close(got, want, torch.float32, False, peaked)


@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("qtype", [None, "int8", "mixed"])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 16),
                                     (torch.float32, 32),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 32)])
def test_paged_narrow_heads_and_f32(dev, no_tf32, dtype, d, qtype, page):
    """K7 at fp32 and the narrow heads: against its plain version, and
    bit for bit against K6 on the same keys."""
    b, h, h_kv = 4, 8, 2
    lengths = [300, 0, 129, 1]
    max_pages = -(-300 // page) + 2
    gen = torch.Generator(device=dev).manual_seed(page + d)
    q, k, v = _decode_inputs(dev, dtype, b, h, h_kv, 300, d, page, True)
    cache, (kq, vq, ks, vs) = _paged_copy(dev, k, v, lengths, page,
                                          max_pages, qtype, gen)
    for kw in (dict(), dict(window=100)):
        _nan_fill_allocator(dev)
        before = paged_decode_attention.launches
        got = paged_decode_step(q, cache, **kw)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == before + 1
        want = paged_decode_attention_plain(
            q, cache.k_pages, cache.v_pages, cache.page_table,
            cache.lengths, k_scale=cache.k_scale, v_scale=cache.v_scale,
            **kw)
        _assert_decode_close(got, want, dtype, False, True)
        o_c, lse_c = decode_attention(q, kq, vq, cache.lengths, k_scale=ks,
                                      v_scale=vs, **kw)
        assert torch.equal(got[0], o_c) and torch.equal(got[1], lse_c)


@pytest.mark.parametrize("d", [16, 128])
def test_decode_f32_keeps_p_unrounded(dev, no_tf32, d):
    """An fp32 q weights V with the unrounded P, as the JAX body's fp32
    compute dtype does: K6 is ten times nearer the fp32 P·V than the same
    sum over P rounded to bf16."""
    b, h, h_kv, n = 2, 4, 2, 200
    q, k, v = _decode_inputs(dev, torch.float32, b, h, h_kv, n, d, 5, True)
    lens = torch.full((b,), n, dtype=torch.int32, device=dev)
    o, _ = decode_attention(q, k, v, lens)
    s = torch.einsum("bhgd,bhkd->bhgk", q.view(b, h_kv, h // h_kv, d),
                     k) / d ** 0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    exact = (torch.einsum("bhgk,bhkd->bhgd", p, v) / l).reshape(b, h, d)
    rounded = (torch.einsum("bhgk,bhkd->bhgd", p.bfloat16().float(), v)
               / l).reshape(b, h, d)
    torch.cuda.synchronize()
    assert _err(o, exact) <= F32_GATE
    assert _err(o, rounded) > 10 * _err(o, exact)


def _padded_counts():
    return dict(flash_attention_forward.form_launches)


@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("form", ["online", "bound", "kmajor"])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,kw", [
    (2, 4, 2, 200, 200, dict(causal=True)),
    (1, 8, 8, 130, 300, dict()),
])
def test_forward_narrow_heads(dev, no_tf32, dtype, d, form, scale, b, h,
                              h_kv, nq, nk, kw):
    """K1 (online), K1b and K5 (pinned) at d = 16 and 32, on heads
    zero-padded to 64 at the caller's scale, against the plain version at
    d: one launch of the form, O of width d in q's dtype."""
    for peaked in (False, True):
        q, k, v = _f32_inputs(dev, b, h, h_kv, nq, nk, d, nq + d, peaked)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        before = _padded_counts()
        if form == "online":
            got = flash_attention_forward(q, k, v, scale=scale,
                                          softmax="online", **kw)
            want = flash_attention_forward_plain(q, k, v, scale=scale,
                                                 softmax="online", **kw)
        else:
            got = _pinned(form, q, k, v, out_dtype=dtype, scale=scale, **kw)
            want = flash_attention_forward_plain(
                q, k, v, scale=scale, softmax="bound_unchecked",
                out_dtype=dtype, **kw)
        torch.cuda.synchronize()
        after = _padded_counts()
        assert after[form] - before[form] == 1
        assert got[0].shape == q.shape and got[0].dtype == dtype
        if dtype == torch.float32:
            _assert_f32_fwd(got, want)
        else:
            _assert_fwd_close(got, want)


@pytest.mark.parametrize("d", [16, 32])
# the split pair takes bf16 only (K3 has no fp32 build)
@pytest.mark.parametrize("dtype,fused", [(torch.float32, True),
                                         (torch.bfloat16, True),
                                         (torch.bfloat16, False)])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,kw", [
    (1, 4, 4, 300, 300, dict(causal=True)),
    (2, 8, 2, 200, 333, dict(causal=True, window=90, kv_offset=133)),
    (1, 8, 8, 130, 260, dict()),
])
def test_backward_narrow_heads(dev, no_tf32, dtype, d, fused, b, h, h_kv,
                               nq, nk, kw):
    """K4 (and K2 + K3 on bf16) at d = 16 and 32 on zero-padded heads,
    against the plain backward at d, at the default scale and at 0.3."""
    for scale in (None, 0.3):
        for peaked in (False, True):
            q, k, v = _f32_inputs(dev, b, h, h_kv, nq, nk, d, nq + d, peaked)
            gen = torch.Generator(device=dev).manual_seed(d)
            do = torch.rand((b, h, nq, d), generator=gen, device=dev) - 0.5
            q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
            o, lse = flash_attention_forward_plain(q, k, v, scale=scale,
                                                   **kw)
            want = flash_attention_backward_plain(q, k, v, o, lse, do,
                                                  scale=scale, **kw)
            before = dict(flash_attention_backward.launches)
            got = flash_attention_backward(q, k, v, o, lse, do, scale=scale,
                                           fused=fused, **kw)
            torch.cuda.synchronize()
            grown = {n: flash_attention_backward.launches[n] - before[n]
                     for n in before}
            assert grown == ({"fused": 1, "dkdv": 0, "dq": 0, "delta": 1}
                             if fused else
                             {"fused": 0, "dkdv": 1, "dq": 1, "delta": 1})
            for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
                assert g.shape == w.shape and g.dtype == w.dtype
                if dtype == torch.float32:
                    _assert_f32_grad(g, w, name)
                else:
                    _assert_rel(g, w, name)


def test_narrow_heads_through_autograd(dev, no_tf32):
    """flash_attention at d = 16 on fp32 [B,N,H,d] views: K1 once and K4
    once, O and the gradients within the fp32 gates."""
    gen = torch.Generator(device=dev).manual_seed(16)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5
    q = u(2, 96, 4, 16).transpose(1, 2).requires_grad_(True)
    k = u(2, 96, 2, 16).transpose(1, 2).requires_grad_(True)
    v = u(2, 96, 2, 16).transpose(1, 2).requires_grad_(True)
    do = u(2, 96, 4, 16).transpose(1, 2)
    fwd0 = flash_attention_forward.launches
    bwd0 = flash_attention_backward.launches["fused"]
    o = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), grad_outputs=do)
    torch.cuda.synchronize()
    assert flash_attention_forward.launches == fwd0 + 1
    assert flash_attention_backward.launches["fused"] == bwd0 + 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o_p, lse = flash_attention_forward_plain(qd, kd, vd, causal=True)
    assert o.shape == qd.shape and _err(o, o_p) <= F32_GATE
    want = flash_attention_backward_plain(qd, kd, vd, o_p, lse, do,
                                          causal=True)
    for g, w, name in zip(grads, want, ("dQ", "dK", "dV")):
        _assert_f32_grad(g, w, name)


def test_padded_heads_refuse_other_widths(dev, no_tf32):
    """An fp32 Q: d = 48 and 20 are padded to 64 and d = 136 to 256 (the
    fp32 d = 256 builds), each within 1e-4 of the plain version; d = 300,
    past every build, raises naming the width before any launch."""
    for d in (48, 20, 136):
        q = torch.rand(1, 2, 40, d, device=dev)
        got = flash_attention_forward(q, q, q)
        assert got[0].shape == q.shape
        _assert_f32_fwd(got, flash_attention_forward_plain(q, q, q))
    x = torch.rand(1, 2, 40, 300, device=dev)
    before = _form_counts()
    with pytest.raises(ValueError, match="forward takes d from 1 to 256"):
        flash_attention_forward(x, x, x)
    assert _form_counts() == before


# ---------------------------------------------------------------------------
# fp32 on the rest of the card: an fp32 Q over int8, fp8 and mixed K/V in
# the forward (K1, K1b, K5), K3's fp32 build under the split backward, K8's
# fp32 build and narrow heads, K9's fp32 build. Gates as the fp32 builds
# above (quantize_q computes in bf16: the bf16 gate).
# ---------------------------------------------------------------------------

_F32Q_SHAPES = [
    # (b, h, h_kv, nq, nk, d, kw)
    (2, 8, 2, 300, 500, 128, dict()),
    (1, 16, 4, 257, 700, 64, dict(causal=True, kv_offset=443)),
    (2, 4, 1, 200, 333, 64, dict(causal=True, window=90, kv_offset=133)),
    (1, 8, 8, 130, 1000, 128, dict(causal=True, window=700,
                                   kv_offset=870)),
]


def _f32q_inputs(dev, qtype, b, h, h_kv, nq, nk, d, seed, peaked):
    q, k, v = _f32_inputs(dev, b, h, h_kv, nq, nk, d, seed, peaked)
    kv = quantize_kv(k, v, qtype)
    return (q, kv.k_q, kv.v_q), dict(k_scale=kv.k_scale, v_scale=kv.v_scale)


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("form", ["online", "bound", "kmajor"])
@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", _F32Q_SHAPES)
def test_f32q_forward_over_codes(dev, no_tf32, qtype, form, peaked, b, h,
                                 h_kv, nq, nk, d, kw):
    """K1 (online), K1b and K5 (each pinned) on an fp32 Q over one-byte
    K/V against the plain fp32 version (S in fp32, P · v_scale not
    rounded): one launch of the form, fp32 O and LSE within 1e-4."""
    (q, k, v), sc = _f32q_inputs(dev, qtype, b, h, h_kv, nq, nk, d,
                                 nq + nk, peaked)
    _nan_fill_allocator(dev)
    before = _form_counts()
    if form == "online":
        got = flash_attention_forward(q, k, v, softmax="online", **sc, **kw)
        want = flash_attention_forward_plain(q, k, v, softmax="online",
                                             **sc, **kw)
    else:
        got = _pinned(form, q, k, v, **sc, **kw)
        want = flash_attention_forward_plain(
            q, k, v, softmax="bound_unchecked", **sc, **kw)
    torch.cuda.synchronize()
    after = _form_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "online": int(form == "online"), "bound": int(form == "bound"),
        "kmajor": int(form == "kmajor"), "fallback": 0}
    _assert_f32_fwd(got, want)


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_f32q_forward_auto_routes_and_checks(dev, no_tf32, qtype):
    """"auto" on an fp32 Q over codes: K1b with its guarded fallback
    without a mask, K5 with it under a window; O in fp32 and in bf16."""
    for kw, form in ((dict(), "bound"),
                     (dict(causal=True, window=300, kv_offset=500),
                      "kmajor")):
        (q, k, v), sc = _f32q_inputs(dev, qtype, 2, 16, 4, 256, 800, 128, 4,
                                     True)
        for out_dtype in (torch.float32, torch.bfloat16):
            before = _form_counts()
            got = flash_attention_forward(q, k, v, out_dtype=out_dtype,
                                          **sc, **kw)
            want = flash_attention_forward_plain(
                q, k, v, out_dtype=out_dtype, **sc, **kw)
            torch.cuda.synchronize()
            grown = {n: _form_counts()[n] - before[n] for n in before}
            assert grown == dict(online=0, bound=int(form == "bound"),
                                 kmajor=int(form == "kmajor"), fallback=1)
            if out_dtype == torch.float32:
                _assert_f32_fwd(got, want)
            else:
                assert _err(got[0], want[0]) <= 2 ** -8
                assert _err(got[1], want[1]) <= F32_GATE


@pytest.mark.parametrize("form", ["bound", "kmajor"])
@pytest.mark.parametrize("qtype", ["int8", "mixed", "fp8"])
def test_f32q_quantize_q(dev, no_tf32, qtype, form):
    """quantize_q on an fp32 Q: over int8 keys the host's int8 Q runs the
    int8 build (the bf16 gate: its P is rounded to bf16, as the JAX
    function's `cd`); over fp8 keys it is dropped as in the JAX function,
    and the fp32-Q build gives the unquantized call's bits."""
    (q, k, v), sc = _f32q_inputs(dev, qtype, 2, 8, 2, 300, 600, 128, 7,
                                 True)
    kw = dict(causal=True, kv_offset=300)
    got = _pinned(form, q, k, v, quantize_q=True, **sc, **kw)
    want = flash_attention_forward_plain(q, k, v, softmax="bound_unchecked",
                                         quantize_q=True, **sc, **kw)
    torch.cuda.synchronize()
    if qtype == "fp8":
        _assert_f32_fwd(got, want)
    else:
        assert _err(got[0], want[0]) <= GATE
        assert _err(got[1], want[1]) <= GATE


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", _F32_BWD_SHAPES)
def test_f32_split_backward_kernels(dev, no_tf32, peaked, b, h, h_kv, nq, nk,
                                    d, kw):
    """fused=False on fp32: K2 and K3's fp32 builds once each, fp32
    gradients within 1e-4 · max(1, max |plain|); dK and dV the fused
    pass's bits (one dK/dV walk)."""
    args = _f32_bwd_inputs(dev, b, h, h_kv, nq, nk, d, kw, peaked, nq + nk)
    want = flash_attention_backward_plain(*args, **kw)
    _nan_fill_allocator(dev)
    before = dict(flash_attention_backward.launches)
    got = flash_attention_backward(*args, fused=False, **kw)
    torch.cuda.synchronize()
    after = flash_attention_backward.launches
    assert {n: after[n] - before[n] for n in after} == {
        "fused": 0, "dkdv": 1, "dq": 1, "delta": 1}
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        _assert_f32_grad(g, w, name)
    fused = flash_attention_backward(*args, **kw)
    assert torch.equal(got[1], fused[1]) and torch.equal(got[2], fused[2])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,h_kv,d,n", [(4, 4, 128, 300), (16, 4, 64, 257)])
def test_f32_split_backward_segments(dev, no_tf32, causal, h, h_kv, d, n):
    """K3's fp32 SEG build (two 32-key stages at d = 128) against the
    plain fp32 backward, segments crossing key tiles."""
    ids = torch.arange(n, device=dev) // 70
    seg = torch.stack([ids, (ids + 1) % 3])
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    q, k, v, _, _, do = _f32_bwd_inputs(dev, 2, h, h_kv, n, n, d, {}, True,
                                        9)
    o, lse = flash_attention_forward_plain(q, k, v, **kw)
    want = flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    got = flash_attention_backward(q, k, v, o, lse, do, fused=False, **kw)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        _assert_f32_grad(g, w, name)


@pytest.mark.parametrize("nq,nk,causal,kv_offset,window", [
    (31, 33, True, 0, 0), (32, 32, True, 0, 0), (33, 95, True, 62, 0),
    (300, 100, True, 0, 40), (100, 260, True, -20, 0), (65, 31, False, 0, 0),
])
def test_f32_dq_kernel_32_key_tile_edges(dev, no_tf32, nq, nk, causal,
                                         kv_offset, window):
    """K3's fp32 walk of 32-key tiles at their edges (ragged tails, the
    causal and window frontiers inside a tile, empty rows)."""
    kw = dict(causal=causal, kv_offset=kv_offset, window=window)
    args = _f32_bwd_inputs(dev, 1, 8, 2, nq, nk, 128, kw, True, nq * nk)
    want = flash_attention_backward_plain(*args, **kw)
    got = flash_attention_backward(*args, fused=False, **kw)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        _assert_f32_grad(g, w, name)


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("b,h,nq,nk,d,causal,block_q,block_k", [
    (1, 1, 64, 64, 32, False, 64, 64),       # the reference rung's 64 x 32
    (1, 4, 512, 512, 128, True, 256, 256),
    (2, 2, 300, 300, 64, True, 64, 64),
    (1, 2, 100, 333, 128, False, 128, 192),
    (2, 3, 37, 200, 16, False, 256, 256),
    (1, 2, 70, 40, 64, True, 256, 256),
])
def test_f32_fa1_kernel(dev, no_tf32, peaked, b, h, nq, nk, d, causal,
                        block_q, block_k):
    """K8's fp32 build (narrow heads padded to 64) against the plain fp32
    FA1 walk: one launch, fp32 O within 1e-4."""
    q, k, v = _f32_inputs(dev, b, h, h, nq, nk, d, nq + nk + d, peaked)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    _nan_fill_allocator(dev)
    before = fa1_attention.launches
    o = fa1_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa1_attention.launches == before + 1
    assert o.dtype == torch.float32 and o.shape == q.shape
    o_p = fa1_attention_plain(q, k, v, causal=causal,
                              block_q=max(8, min(block_q, -(-nq // 8) * 8)),
                              block_k=max(8, min(block_k, -(-nk // 8) * 8)))
    assert o_p.abs().max().item() > 0
    assert _err(o, o_p) <= F32_GATE


@pytest.mark.parametrize("d", [16, 32, 48])
def test_fa1_narrow_heads_bf16(dev, d):
    """K8's bf16 build on heads padded to 64, at the caller's scale."""
    gen = torch.Generator(device=dev).manual_seed(d)
    q = _rand(gen, dev, 1, 4, 300, d)
    k, v = _rand(gen, dev, 1, 4, 300, d), _rand(gen, dev, 1, 4, 300, d)
    o = fa1_attention(q, k, v, causal=True, block_q=64, block_k=128)
    torch.cuda.synchronize()
    assert o.shape == q.shape
    assert _err(o, fa1_attention_plain(q, k, v, causal=True, block_q=64,
                                       block_k=128)) <= GATE


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,d", [(1024, 128), (192, 64), (8192, 128)])
def test_f32_device_ring_kernel(dev, no_tf32, n, rows, d):
    """K9's fp32 build against the plain ring and (Σ x_i) @ W in fp32, one
    launch, within 1e-4 · max(1, max |ref|); 5 calls give the first's
    bits."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    gen = torch.Generator(device=dev).manual_seed(n * rows + d)
    x = torch.rand((n * rows, d), generator=gen, device=dev) - 0.5
    w = torch.rand((d, d), generator=gen, device=dev) - 0.5
    mesh = _ring_mesh(dev, n)
    before = device_ring_matmul.launches
    o = device_ring_matmul(x, w, mesh)
    torch.cuda.synchronize()
    assert device_ring_matmul.launches == before + 1
    ref = _ring_ref(x, w, n)
    gate = F32_GATE * max(1.0, ref.abs().max().item())
    assert o.dtype == torch.float32
    assert _err(o, ref) <= gate
    assert _err(o, ring_matmul_plain(x, w, mesh)) <= gate
    for _ in range(5):
        assert torch.equal(device_ring_matmul(x, w, mesh), o)


def test_f32_device_ring_across_cards(dev, no_tf32):
    """With two or more cards visible: K9's fp32 .sys build over distinct
    cards against the reference; 20 calls give the first's bits."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    n = 4
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.rand((n * 1024, 128), generator=gen, device=dev) - 0.5
    w = torch.rand((128, 128), generator=gen, device=dev) - 0.5
    mesh = make_mesh((n,), ("sp",),
                     [torch.device("cuda", i % cards) for i in range(n)])
    first = device_ring_matmul(x, w, mesh)
    torch.cuda.synchronize()
    assert device_ring_matmul.last_scope == "sys"
    ref = _ring_ref(x, w, n)
    assert _err(first, ref) <= F32_GATE * max(1.0, ref.abs().max().item())
    for _ in range(20):
        assert torch.equal(device_ring_matmul(x, w, mesh), first)



# ---------------------------------------------------------------------------
# Tiles (ops.common.BlockSizes), the 128-key builds of K1 and K1b, the
# backward's prologue (D and K4's zeroed accumulator), K6's split size as
# block_k, K5's spans, and the tuners
# ---------------------------------------------------------------------------

def _tiles(block_k):
    from cuda_flashattention_torch.ops.common import BlockSizes
    return BlockSizes(block_k=block_k)


K128_CASES = [
    (1, 16, 16, 1024, 1024, 128, dict(causal=True)),
    (1, 16, 16, 1024, 1024, 128, dict(causal=False)),
    (2, 8, 2, 777, 777, 64, dict(causal=True)),
    (2, 16, 4, 512, 1536, 128, dict(causal=True, kv_offset=1024,
                                    window=700)),
    (1, 8, 2, 1000, 1000, 128, dict(causal=True, window=300)),
    (2, 8, 8, 300, 900, 64, dict(causal=False)),
    (1, 4, 4, 200, 200, 128, dict(causal=True, window=64, kv_offset=-70)),
]


@pytest.mark.parametrize("softmax", ["online", "bound_unchecked"])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", K128_CASES)
def test_128_key_builds_match_plain_and_64_keys(dev, softmax, b, h, h_kv,
                                                nq, nk, d, kw):
    """K1 ("online") and K1b ("bound_unchecked", non-causal: Q-major) at
    block_k = 128 against the plain version (5e-3, and 2e-2 · max |O|)
    and against their 64-key builds (the same gates), under causal,
    kv_offset, window and the ragged tail, d 64 and 128; K1b's causal
    calls go to K5, whose 128 keys are a span of 2."""
    args, _ = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, None, nq + nk + d)
    kw = dict(kw, softmax=softmax, out_dtype=torch.float32)
    before = _form_counts()
    got = flash_attention_forward(*args, block_sizes=_tiles(128), **kw)
    torch.cuda.synchronize()
    after = _form_counts()
    form = ("online" if softmax == "online"
            else "kmajor" if kw.get("causal") else "bound")
    assert after[form] == before[form] + 1
    _assert_fwd_close(got, flash_attention_forward_plain(*args, **kw))
    _assert_fwd_close(got, flash_attention_forward(*args, **kw))


@pytest.mark.parametrize("causal", [True, False])
def test_128_key_k1_under_segment_ids(dev, causal):
    b, h, n, d = 2, 8, 1000, 128
    args, _ = _fwd_inputs(dev, b, h, 4, n, n, d, None, 7)
    ids = _segments(dev, b, n, [300, 1, 250, 449])
    kw = dict(causal=causal, q_segment_ids=ids, kv_segment_ids=ids)
    got = flash_attention_forward(*args, block_sizes=_tiles(128), **kw)
    torch.cuda.synchronize()
    _assert_fwd_close(got, flash_attention_forward_plain(*args, **kw))
    _assert_fwd_close(got, flash_attention_forward(*args, **kw))


def test_128_key_k1b_behind_its_guard(dev):
    """"bound" at block_k = 128: K1b's 128-key build, then the guarded
    online launch at the same tile; a loose bound (anti-aligned Q and K)
    returns the online kernel's bits."""
    b, h, n, d = 1, 4, 300, 128
    gen = torch.Generator(device=dev).manual_seed(3)
    base = _rand(gen, dev, b, 1, 1, d).float()
    q = (base * 200).expand(b, h, n, d).contiguous().to(torch.bfloat16)
    k = (-base * 200).expand(b, h, n, d).contiguous().to(torch.bfloat16)
    v = _rand(gen, dev, b, h, n, d)
    got = flash_attention_forward(q, k, v, softmax="bound",
                                  block_sizes=_tiles(128))
    online = flash_attention_forward(q, k, v, softmax="online",
                                     block_sizes=_tiles(128))
    torch.cuda.synchronize()
    assert torch.equal(got[0], online[0]) and torch.equal(got[1], online[1])


@pytest.mark.parametrize("d", [64, 128])
def test_kmajor_at_each_span(dev, d):
    """K5 at every span its build keeps (block_k = 64 · span) against the
    plain version and against the rule's span."""
    from cuda_flashattention_torch.ops.common import BUILT_TILES
    b, h, h_kv, nq, nk = 2, 8, 2, 256, 1100
    args, _ = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, None, d + 1)
    kw = dict(causal=True, kv_offset=nk - nq, softmax="bound_unchecked",
              out_dtype=torch.float32)
    want = flash_attention_forward_plain(*args, **kw)
    rule = flash_attention_forward(*args, **kw)
    for block_k in BUILT_TILES["K5", "bf16", d][1]:
        got = flash_attention_forward(*args, block_sizes=_tiles(block_k),
                                      **kw)
        torch.cuda.synchronize()
        _assert_fwd_close(got, want)
        assert _err(got[0], rule[0]) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 64, 128, 200, 256])
def test_prologue_matches_the_plain_d(dev, dtype, d):
    """The prologue's D within 1e-5 · max(1, max |plain D|) of the plain
    version at a ragged Nq, on heads padded to the kernel's d, and K4's
    accumulator zeroed (it was filled with 7 before)."""
    from cuda_flashattention_torch.ops import flash_bwd as fb
    from cuda_flashattention_torch.ops.common import pad_heads
    gen = torch.Generator(device=dev).manual_seed(d)
    b, h, n = 2, 8, 333
    o = torch.randn((b, h, n, d), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, h, n, d), generator=gen, device=dev).to(dtype)
    _, (o_run, do_run) = pad_heads("test", o, do)
    acc = torch.full((*o_run.shape[:3], o_run.shape[-1]), 7.0, device=dev)
    before = fb.flash_attention_backward.launches["delta"]
    got = fb._launch_delta(o_run, do_run, acc)
    torch.cuda.synchronize()
    assert fb.flash_attention_backward.launches["delta"] == before + 1
    want = fb.delta_plain(o, do)
    assert _err(got, want) <= 1e-5 * max(1.0, want.abs().max().item())
    assert torch.count_nonzero(acc).item() == 0
    # an fp32 O (a ring's combined output) with a bf16 dO
    got = fb._launch_delta(o_run.float(), do_run.to(torch.bfloat16))
    want = fb.delta_plain(o.float(), do.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert _err(got, want) <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("fused", [True, False])
def test_backward_takes_d_from_the_prologue(dev, fused):
    """GQA, segment ids, a ragged Nq: one prologue launch per backward
    call, before K4 (or K2 + K3), and the gradients at the backward's
    gate; the explicit built pair gives the same bits as none."""
    from cuda_flashattention_torch.ops.common import BlockSizes
    b, h, h_kv, n, d = 2, 8, 2, 700, 128
    q, k, v, _, _, do = _bwd_inputs(dev, b, h, h_kv, n, n, d, True, 0, 5)
    ids = _segments(dev, b, n, [200, 1, 499])
    kw = dict(causal=True, q_segment_ids=ids, kv_segment_ids=ids)
    args = (q, k, v, *flash_attention_forward(q, k, v, **kw), do)
    launches = flash_attention_backward.launches
    before = dict(launches)
    got = flash_attention_backward(*args, fused=fused, **kw)
    torch.cuda.synchronize()
    assert launches["delta"] == before["delta"] + 1
    assert launches["fused" if fused else "dkdv"] == before[
        "fused" if fused else "dkdv"] + 1
    want = flash_attention_backward_plain(*args, **kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        _assert_rel(g, w, name)
    tiled = flash_attention_backward(*args, fused=fused,
                                     block_sizes=BlockSizes(), **kw)
    for g, t in zip(got[1:], tiled[1:]):
        assert torch.equal(g, t)


def test_backward_runs_no_torch_reduction_or_zeros(dev):
    """On CUDA tensors at d = 128 the backward's D and dQ's zeroing are
    the prologue's: the profiler records no aten::sum, aten::zeros or
    aten::zero_."""
    args = _bwd_inputs(dev, 1, 16, 16, 1024, 1024, 128, True, 0, 9)
    flash_attention_backward(*args, causal=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        flash_attention_backward(*args, causal=True)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert not names & {"aten::sum", "aten::zeros", "aten::zero_"}, names


@pytest.mark.parametrize("block_k", [64, 128, 1000, 4352, None])
def test_decode_at_explicit_split_sizes(dev, block_k):
    """K6 with block_k below the rule's 128 keys, above it, the whole
    capacity (one split) and the rule, against the plain version."""
    b, h, h_kv, cap, d = 8, 16, 4, 4352, 128
    gen = torch.Generator(device=dev).manual_seed(4)
    q = (_rand(gen, dev, b, h, d).float() * 8).to(torch.bfloat16)
    k = (_rand(gen, dev, b, h_kv, cap, d).float() * 4).to(torch.bfloat16)
    v = _rand(gen, dev, b, h_kv, cap, d)
    lengths = torch.tensor([4224, 1, 0, 4352, 129, 128, 3000, 64],
                           dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lengths, block_k=block_k)
    torch.cuda.synchronize()
    _assert_fwd_close(got, decode_attention_plain(q, k, v, lengths))


def test_tuners_on_a_small_shape(dev, tmp_path, monkeypatch):
    """Each tuner returns a built choice, writes it to its cache, and a
    second call measures nothing."""
    from cuda_flashattention_torch.ops.common import BlockSizes
    from cuda_flashattention_torch.utils import autotune
    monkeypatch.setenv("CFA_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    autotune._MEM_CACHE.clear()
    fwd = autotune.autotune_block_sizes(nq=512, nk=512, d=128, heads=4,
                                        causal=True, iters=2)
    bwd = autotune.autotune_block_sizes(nq=512, nk=512, d=128, heads=4,
                                        causal=True, mode="bwd", iters=2)
    bk = autotune.autotune_decode_block_k(ctx=600, heads=8, kv_heads=2,
                                          batch=2, iters=2)
    ps = autotune.autotune_page_size(ctx=600, heads=8, kv_heads=2, batch=2,
                                     iters=2)
    assert fwd.block_k in (64, 128) and fwd.block_q == 128
    assert (bwd.block_q_bwd, bwd.block_k_bwd) == (64, 128)
    assert bk in autotune.decode_candidates(600)
    assert ps in autotune.page_candidates(600)
    assert all(ms is not None for sweep in autotune.sweeps.values()
               for _, ms in sweep)
    assert len(autotune._disk_cache_load()) == 4
    autotune._MEM_CACHE.clear()
    monkeypatch.setattr(autotune, "time_fn",
                        lambda *a, **k: pytest.fail("cache miss"))
    assert autotune.autotune_block_sizes(nq=512, nk=512, d=128, heads=4,
                                         causal=True, iters=2) == fwd
    assert isinstance(fwd, BlockSizes)


# ---------------------------------------------------------------------------
# An fp32 model served over bf16 caches: the BF16KV builds of K1, K1b and
# K5 (an fp32 Q over bf16 K/V), fp16 O in their epilogues, K6 / K7 on an
# fp32 q over a bf16 cache, unbuilt tiles and split sizes mapped as the
# JAX functions take them, and a seeded fuzz of K1, K1b, K5 and K6 against
# their plain versions. Gates: fp32 1e-4, bf16 as above.
# ---------------------------------------------------------------------------

_F32BF16_SHAPES = _F32Q_SHAPES + [
    (2, 8, 2, 300, 500, 32, dict(causal=True, kv_offset=200)),  # d 32
    (1, 8, 4, 130, 260, 16, dict()),                            # d 16
]


def _f32bf16_inputs(dev, b, h, h_kv, nq, nk, d, seed, peaked):
    q, k, v = _f32_inputs(dev, b, h, h_kv, nq, nk, d, seed, peaked)
    return q, k.bfloat16(), v.bfloat16()


def _one_form(form, q, k, v, out_dtype=torch.float32, **kw):
    """The kernel of `form` alone ("online": K1, "bound": K1b, "kmajor":
    K5, no guarded fallback), and its plain version."""
    if form == "online":
        kw = dict(kw, softmax="online", out_dtype=out_dtype)
        return (flash_attention_forward(q, k, v, **kw),
                flash_attention_forward_plain(q, k, v, **kw))
    return (_pinned(form, q, k, v, out_dtype=out_dtype, **kw),
            flash_attention_forward_plain(q, k, v, softmax="bound_unchecked",
                                          out_dtype=out_dtype, **kw))


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("form", ["online", "bound", "kmajor"])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", _F32BF16_SHAPES)
def test_f32q_forward_over_bf16(dev, no_tf32, form, peaked, b, h, h_kv, nq,
                                nk, d, kw):
    """K1 (online), K1b and K5 (each pinned) on an fp32 Q over bf16 K/V,
    every mask, d 128 and 64 and padded 32 and 16: one launch of the form,
    fp32 O and LSE within 1e-4 of the plain fp32 version."""
    q, k, v = _f32bf16_inputs(dev, b, h, h_kv, nq, nk, d, nq + nk, peaked)
    _nan_fill_allocator(dev)
    before = _form_counts()
    got, want = _one_form(form, q, k, v, **kw)
    torch.cuda.synchronize()
    after = _form_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "online": int(form == "online"), "bound": int(form == "bound"),
        "kmajor": int(form == "kmajor"), "fallback": 0}
    _assert_f32_fwd(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_f32q_over_bf16_segments_and_auto(dev, no_tf32, causal):
    """K1's BF16KV build under segment ids; then "auto", which routes as
    the JAX function: not causal (the chunked prefill's prefix reads) to
    K1b, causal past 5120 rows to K5, each with its guarded K1 of the same
    build behind it."""
    q, k, v = _f32bf16_inputs(dev, 2, 8, 2, 300, 300, 128, 3, True)
    seg = _segments(dev, 2, 300, [70, 1, 129, 100])
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    _assert_f32_fwd(flash_attention_forward(q, k, v, **kw),
                    flash_attention_forward_plain(q, k, v, **kw))
    shape = (1, 16, 4, 5200, 5200, 128) if causal else (2, 16, 4, 256, 800,
                                                         128)
    q, k, v = _f32bf16_inputs(dev, *shape, 4, True)
    kw = dict(causal=causal)
    before = _form_counts()
    got = flash_attention_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    grown = {n: _form_counts()[n] - before[n] for n in before}
    assert grown == dict(online=0, bound=int(not causal),
                         kmajor=int(causal), fallback=1)
    _assert_f32_fwd(got, flash_attention_forward_plain(q, k, v, **kw))


@pytest.mark.parametrize("form", ["online", "bound", "kmajor"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_fp16_out(dev, no_tf32, form, q_dtype):
    """O in fp16 from K1's, K1b's and K5's epilogues (an fp32 or bf16 Q
    over bf16 K/V): the fp32-out build's O rounded to fp16 (K5's fp32 sums
    add in another order run to run: one fp16 ulp), the LSE the same, and
    rows that see no key (kv_offset -20) O = 0, LSE = NEG_INF."""
    q, k, v = _f32bf16_inputs(dev, 2, 16, 4, 300, 500, 128, 9, True)
    q = q.to(q_dtype)
    kw = dict(causal=True, kv_offset=-20)
    (o32, lse32), _ = _one_form(form, q, k, v, **kw)
    (o16, lse16), (o16_p, _) = _one_form(form, q, k, v,
                                         out_dtype=torch.float16, **kw)
    torch.cuda.synchronize()
    assert o16.dtype == torch.float16 and o16_p.dtype == torch.float16
    ulp = 0.0 if form != "kmajor" else 2.0 ** -10
    assert _err(o16, o32.half()) <= ulp * max(1.0, o32.abs().max().item())
    assert _err(lse16, lse32) <= (0.0 if form != "kmajor" else F32_GATE)
    assert torch.all(o16[:, :, :20] == 0)
    assert torch.all(lse16[:, :, :20] == -1e30)
    # O cast as the JAX function casts, for a type no epilogue writes
    o_i, _ = flash_attention_forward(q, k, v, out_dtype=torch.int32, **kw)
    assert o_i.dtype == torch.int32


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_decode_f32_q_over_bf16_cache(dev, no_tf32, d):
    """K6 on an fp32 q over a bf16 cache (P unrounded, each key and value
    widened exactly) against the plain version at 1e-4, under windows and
    with empty sequences; K7 over the same keys in 16-token pages bit for
    bit against K6."""
    b, h, h_kv, max_n = 8, 16, 4, 1100
    lengths = [1100, 1, 640, 0, 999, 128, 513, 77]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(d)
    for peaked in (False, True):
        q, k, v = _decode_inputs(dev, torch.float32, b, h, h_kv, max_n, d,
                                 d + 3, peaked)
        k, v = k.bfloat16(), v.bfloat16()
        for kw in (dict(), dict(window=300)):
            before = decode_attention.launches
            got = decode_attention(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            assert decode_attention.launches == before + 1
            want = decode_attention_plain(q, k, v, lens, **kw)
            _assert_decode_close(got, want, torch.float32, False, peaked)
            cache, (kq, vq, _, _) = _paged_copy(dev, k, v, lengths, 16,
                                                -(-max_n // 16) + 2, None,
                                                gen)
            before = paged_decode_attention.launches
            paged = paged_decode_step(q, cache, **kw)
            torch.cuda.synchronize()
            assert paged_decode_attention.launches == before + 1
            assert torch.equal(paged[0], got[0])
            assert torch.equal(paged[1], got[1])


def test_unbuilt_tiles_and_splits_run_on_the_card(dev):
    """JAX's BlockSizes() defaults and a (512, 512) run the forward at the
    nearest built tile (its bits), and the backward at its one pair
    (dK, dV bit for bit; dQ's TMA reduces add in any order); a decode
    split size past the capacity gives the capacity's bits."""
    from cuda_flashattention_torch.ops.common import BlockSizes
    (q, k, v), _ = _fwd_inputs(dev, 1, 16, 16, 1024, 1024, 128, None, 5)
    do = torch.ones_like(q)
    for tiles in ((2048, 2048, 1024, 2048), (512, 512, 1024, 2048)):
        bs = BlockSizes(*tiles)
        for kw in (dict(causal=True), dict(softmax="bound")):
            got = flash_attention_forward(q, k, v, block_sizes=bs, **kw)
            want = flash_attention_forward(q, k, v, **kw,
                                           block_sizes=BlockSizes(
                                               block_k=128))
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        o, lse = flash_attention_forward(q, k, v, causal=True)
        got = flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                       block_sizes=bs)
        want = flash_attention_backward(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        _assert_rel(got[0], want[0], "dQ")
    qd = q[:, :, 0].contiguous()
    lens = torch.full((1,), 1000, dtype=torch.int32, device=dev)
    got = decode_attention(qd, k, v, lens, block_k=10 ** 6)
    want = decode_attention(qd, k, v, lens, block_k=1024)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _fuzz_case(rng, dims=(16, 32, 64, 128),
               all_types=("bf16", "fp32", "fp32/bf16")):
    """One random forward case: shape, GQA group, head dim (of `dims`),
    operand types (of `all_types`), mask."""
    d = int(rng.choice(list(dims)))
    h_kv = int(rng.choice([1, 2, 4]))
    h = h_kv * int(rng.choice([1, 2, 4, 8]))
    nq, nk = int(rng.integers(1, 700)), int(rng.integers(1, 900))
    types = str(rng.choice(list(all_types)))
    mask = int(rng.integers(0, 4))
    kw = [dict(), dict(causal=True, kv_offset=nk - nq),
          dict(causal=True, kv_offset=int(rng.integers(-50, nk))),
          dict(causal=True, kv_offset=nk - nq,
               window=int(rng.integers(1, nk + 1)))][mask]
    return int(rng.integers(1, 3)), h, h_kv, nq, nk, d, types, kw


def test_fuzz_forward_and_decode(dev, no_tf32):
    """Ten seeded random cases (as tests/test_fuzz.py draws them for the
    JAX package), then six of an fp32 Q at d 200 or 256 (over fp32 or
    bf16 K/V): K1, K1b and K5 pinned at random nq, nk, d, group, operand
    types and mask, and K6 at random lengths, windows, d and types, each
    against its plain version (fp32 1e-4; bf16 5e-3 and 2e-2 · max |plain
    O|); then six fp32 backward cases at d 200 or 256, K4 or K2 + K3 in
    turn, against the plain backward (1e-4 · max(1, max |plain|))."""
    import numpy as np
    rng = np.random.default_rng(2024)
    for case in range(16):
        b, h, h_kv, nq, nk, d, types, kw = (
            _fuzz_case(rng) if case < 10 else
            _fuzz_case(rng, (200, 256), ("fp32", "fp32/bf16")))
        q, k, v = _f32_inputs(dev, b, h, h_kv, nq, nk, d, case, True)
        if types == "bf16":
            q = q.bfloat16()
        if types != "fp32":
            k, v = k.bfloat16(), v.bfloat16()
        for form in ("online", "bound", "kmajor"):
            got, want = _one_form(form, q, k, v, **kw)
            torch.cuda.synchronize()
            what = (form, b, h, h_kv, nq, nk, d, types, kw)
            (o, lse), (o_p, lse_p) = got, want
            if types == "bf16":
                assert torch.isfinite(o).all(), what
                # the relative gate where |O| is large enough for it
                ref = o_p.abs().max().item()
                assert _err(o, o_p) <= GATE, what
                assert ref < 0.25 or _err(o, o_p) <= REL_GATE * ref, what
                assert _err(lse, lse_p) <= GATE, what
            else:
                assert _err(o, o_p) <= F32_GATE, what
                assert _err(lse, lse_p) <= F32_GATE, what
        dtype = torch.bfloat16 if types == "bf16" else torch.float32
        cap = int(rng.integers(1, 1500))
        lengths = torch.from_numpy(rng.integers(0, cap + 1, b)).to(
            device=dev, dtype=torch.int32)
        window = int(rng.choice([0, int(rng.integers(1, cap + 1))]))
        qd, kc, vc = _decode_inputs(dev, dtype, b, h, h_kv, cap, d, case,
                                    True)
        if types == "fp32/bf16":
            kc, vc = kc.bfloat16(), vc.bfloat16()
        got = decode_attention(qd, kc, vc, lengths, window=window)
        want = decode_attention_plain(qd, kc, vc, lengths, window=window)
        torch.cuda.synchronize()
        gate = GATE if dtype == torch.bfloat16 else F32_GATE
        what = ("K6", b, h, h_kv, cap, d, types, lengths.tolist(), window)
        assert _err(got[0], want[0]) <= gate, what
        assert _err(got[1], want[1]) <= gate, what
    # then six fp32 backward cases at d 200 or 256 (a generator of their
    # own, so that the cases above stay as they were), fused and split
    rng = np.random.default_rng(2026)
    for case in range(6):
        b, h, h_kv, nq, nk, d, _, kw = _fuzz_case(rng, (200, 256), ("fp32",))
        _wide_f32_bwd(dev, b, h, h_kv, nq, nk, d, 100 + case,
                      bool(case % 2), True, **kw)


# ---------------------------------------------------------------------------
# Wide heads: K1, K1b and K5 at d = 256 (a bf16 Q over bf16, int8, fp8 and
# mixed K/V, every mask, quantize_q), the forward at widths between builds
# on zero-padded heads, and K6 / K7 at every d from 1 to 256 read in place.
# Gates as above: 5e-3 on O and LSE, O also within 2e-2 · max |plain| on
# peaked inputs; K5 within 1e-4 of K1b; K7 bit for bit against K6; an fp32
# q within 1e-4. A decode call's peak allocation stays below the cache's
# bytes (no padded copy of it).
# ---------------------------------------------------------------------------

WIDE_CASES = [
    # the serving prefill: a quantize_q score contracted into an fma with
    # the bound flipped K1b's P roundings against K5's here (2.1e-4)
    (8, 8, 4, 512, 512, 256, dict(causal=True)),
    (2, 8, 4, 300, 300, 256, dict(causal=True, window=100)),
    (1, 8, 4, 130, 500, 256, dict(causal=True, kv_offset=370)),
    (1, 4, 4, 200, 200, 256, dict(causal=True, window=64, kv_offset=-70)),
    (2, 8, 2, 128, 384, 256, dict(causal=False)),
    (1, 8, 1, 77, 300, 256, dict(causal=True, window=100, kv_offset=223)),
]


@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", WIDE_CASES)
def test_wide_forward_online(dev, qtype, b, h, h_kv, nq, nk, d, kw):
    """K1 at d = 256 (its in-order walk; one converted pair over one-byte
    K/V) against the plain version; one online launch."""
    args, scales = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, qtype, nq + nk)
    kw = dict(kw, softmax="online", out_dtype=torch.float32, **scales)
    _nan_fill_allocator(dev)
    before = _form_counts()
    got = flash_attention_forward(*args, **kw)
    torch.cuda.synchronize()
    assert _form_counts()["online"] == before["online"] + 1
    _assert_fwd_close(got, flash_attention_forward_plain(*args, **kw))


@pytest.mark.parametrize("causal", [True, False])
def test_wide_forward_segments(dev, causal):
    """K1's SEG build at d = 256, ragged segments."""
    b, h, h_kv, n, d = 2, 8, 4, 300, 256
    (q, k, v), _ = _fwd_inputs(dev, b, h, h_kv, n, n, d, None, 13)
    seg = _segments(dev, b, n, [70, 1, 129, 100])
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    got = flash_attention_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_fwd_close(got, flash_attention_forward_plain(q, k, v, **kw))


@pytest.mark.parametrize("qtype,quantize_q", _STORAGE_FORMS)
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", WIDE_CASES)
def test_wide_bound_kernels_pinned(dev, qtype, quantize_q, b, h, h_kv, nq,
                                   nk, d, kw):
    """K1b and K5 at d = 256, each pinned, over every storage pair with and
    without quantize_q (int8 Q rows of two 128-byte slabs), against the
    plain version; K5 within 1e-4 of K1b."""
    args, scales = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, qtype, nq + nk)
    kw = dict(kw, **scales)
    want = flash_attention_forward_plain(
        *args, softmax="bound_unchecked", quantize_q=quantize_q,
        out_dtype=torch.float32, **kw)
    _nan_fill_allocator(dev)
    got = {}
    for form in ("bound", "kmajor"):
        before = _form_counts()
        got[form] = _pinned(form, *args, quantize_q=quantize_q, **kw)
        torch.cuda.synchronize()
        assert _form_counts()[form] == before[form] + 1
        _assert_fwd_close(got[form], want)
    assert _err(got["kmajor"][0], got["bound"][0]) <= 1e-4
    assert _err(got["kmajor"][1], got["bound"][1]) <= 1e-4


@pytest.mark.parametrize("form", ["online", "bound", "kmajor"])
@pytest.mark.parametrize("qtype", [None, "int8"])
@pytest.mark.parametrize("d", [8, 90, 96, 100, 130, 200])
def test_forward_between_builds(dev, d, qtype, form):
    """A d that is no build runs on the next build up, heads zero-padded at
    the caller's scale; O comes back at width d."""
    b, h, h_kv, nq, nk = 2, 8, 4, 200, 333
    args, scales = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, qtype, d)
    kw = dict(causal=True, kv_offset=nk - nq, **scales)
    if form == "online":
        got = flash_attention_forward(*args, softmax="online",
                                      out_dtype=torch.float32, **kw)
        want = flash_attention_forward_plain(*args, softmax="online",
                                             out_dtype=torch.float32, **kw)
    else:
        got = _pinned(form, *args, **kw)
        want = flash_attention_forward_plain(
            *args, softmax="bound_unchecked", out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == args[0].shape
    _assert_fwd_close(got, want)


def test_wide_forward_auto_routes_and_falls_back(dev):
    """"auto" at d = 256: the fp8 prefix read goes to K5, the guarded
    online fallback behind a checked K1b launch runs the d = 256 K1."""
    b, h, h_kv, nq, nk, d = 2, 8, 4, 128, 640, 256
    args, scales = _fwd_inputs(dev, b, h, h_kv, nq, nk, d, "fp8", 3)
    before = _form_counts()
    got = flash_attention_forward(*args, out_dtype=torch.float32, **scales)
    torch.cuda.synchronize()
    after = _form_counts()
    assert after["kmajor"] - before["kmajor"] == 1
    assert after["fallback"] - before["fallback"] == 1
    _assert_fwd_close(got, flash_attention_forward_plain(
        *args, out_dtype=torch.float32, **scales))


def test_wide_forms_refused(dev):
    """The backward (bf16 and fp32), the forward, K8 and K9 past 256 raise,
    each naming the form; nothing falls back and nothing launches. (The
    fp32 forward, the fp32 backward, K8 and K9 at d = 256 run: the
    test_wide_f32_* and test_wide_device_ring_* tests.)"""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    lse32 = torch.zeros(1, 2, 64, device=dev)
    before = dict(flash_attention_backward.launches)
    q300f = torch.rand(1, 2, 64, 300, device=dev)
    with pytest.raises(ValueError, match="backward takes d from 1 to 256"):
        flash_attention_backward(q300f, q300f, q300f, q300f, lse32, q300f)
    q300 = torch.rand(1, 2, 64, 300, device=dev).bfloat16()
    with pytest.raises(ValueError, match="backward takes d from 1 to 256"):
        flash_attention_backward(q300, q300, q300, q300, lse32, q300)
    assert flash_attention_backward.launches == before
    fwd_before, fa1_before = _form_counts(), fa1_attention.launches
    with pytest.raises(ValueError, match="forward takes d from 1 to 256"):
        flash_attention_forward(q300.float(), q300.float(), q300.float())
    with pytest.raises(ValueError, match="FA1 takes d from 1 to 256"):
        fa1_attention(q300, q300, q300)
    assert _form_counts() == fwd_before
    assert fa1_attention.launches == fa1_before
    ring_before = device_ring_matmul.launches
    x, w = torch.rand(2 * 64, 300, device=dev), torch.rand(300, 300,
                                                           device=dev)
    for t in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="ring takes d from 1 to 256"):
            device_ring_matmul(x.to(t), w.to(t), _ring_mesh(dev, 2))
    assert device_ring_matmul.launches == ring_before


# ---------------------------------------------------------------------------
# fp32 at d = 256: K1, K1b and K5 on an fp32 Q over fp32 K/V (32-key split
# tiles), bf16 K/V and one-byte K/V (64-key tiles, one stage beside the
# 128 KB split Q tile), every mask; K8 at d = 256 in bf16 and fp32. Gates:
# 1e-4 on O and LSE (5e-3 where quantize_q's int8 Q runs the int8 build),
# K5 within 1e-4 of K1b, fp16 O the fp32 O rounded.
# ---------------------------------------------------------------------------

_F32_KV = ["fp32", "bf16", "int8", "fp8", "mixed"]


def _wide_f32_inputs(dev, kv, b, h, h_kv, nq, nk, d, seed, peaked):
    """An fp32 Q over K/V stored as `kv` (fp32, bf16 or a quantized pair),
    and the scales of a quantized pair."""
    q, k, v = _f32_inputs(dev, b, h, h_kv, nq, nk, d, seed, peaked)
    if kv == "fp32":
        return (q, k, v), {}
    if kv == "bf16":
        return (q, k.bfloat16(), v.bfloat16()), {}
    kvq = quantize_kv(k, v, kv)
    return (q, kvq.k_q, kvq.v_q), dict(k_scale=kvq.k_scale,
                                       v_scale=kvq.v_scale)


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("form", ["online", "bound", "kmajor"])
@pytest.mark.parametrize("kv", _F32_KV)
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", WIDE_CASES)
def test_wide_f32_forward_kernels(dev, no_tf32, kv, form, peaked, b, h,
                                  h_kv, nq, nk, d, kw):
    """K1 (online), K1b and K5 (each pinned) on an fp32 Q at d = 256 over
    fp32, bf16 and one-byte K/V against the plain fp32 version: one
    launch of the form, fp32 O and LSE within 1e-4."""
    (q, k, v), sc = _wide_f32_inputs(dev, kv, b, h, h_kv, nq, nk, d,
                                     nq + nk, peaked)
    _nan_fill_allocator(dev)
    before = _form_counts()
    got, want = _one_form(form, q, k, v, **sc, **kw)
    torch.cuda.synchronize()
    after = _form_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "online": int(form == "online"), "bound": int(form == "bound"),
        "kmajor": int(form == "kmajor"), "fallback": 0}
    _assert_f32_fwd(got, want)


@pytest.mark.parametrize("kv", _F32_KV)
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", WIDE_CASES)
def test_wide_f32_kmajor_matches_bound(dev, no_tf32, kv, b, h, h_kv, nq, nk,
                                       d, kw):
    """K5 within 1e-4 of K1b on the same fp32 d = 256 call: the same
    products and roundings, another order of fp32 sums."""
    (q, k, v), sc = _wide_f32_inputs(dev, kv, b, h, h_kv, nq, nk, d, 5,
                                     True)
    o_k, lse_k = _pinned("kmajor", q, k, v, **sc, **kw)
    o_q, lse_q = _pinned("bound", q, k, v, **sc, **kw)
    torch.cuda.synchronize()
    assert _err(o_k, o_q) <= 1e-4 and _err(lse_k, lse_q) <= 1e-4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
def test_wide_f32_segments(dev, no_tf32, kv, causal):
    """K1's fp32-Q SEG builds at d = 256 (fp32 K/V in 32-key tiles, bf16
    K/V, codes with the converted pair before the stage)."""
    (q, k, v), sc = _wide_f32_inputs(dev, kv, 2, 8, 4, 300, 300, 256, 13,
                                     True)
    seg = _segments(dev, 2, 300, [70, 1, 129, 100])
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg, **sc)
    before = _form_counts()
    got = flash_attention_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _form_counts()["online"] == before["online"] + 1
    _assert_f32_fwd(got, flash_attention_forward_plain(q, k, v, **kw))


@pytest.mark.parametrize("form", ["online", "bound", "kmajor"])
@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
def test_wide_f32_fp16_out(dev, no_tf32, kv, form):
    """O in fp16 from the fp32-Q d = 256 builds: the fp32-out build's O
    rounded to fp16 (K5: one fp16 ulp), the same LSE, and rows that see
    no key O = 0, LSE = NEG_INF."""
    (q, k, v), sc = _wide_f32_inputs(dev, kv, 2, 8, 4, 300, 500, 256, 9,
                                     True)
    kw = dict(causal=True, kv_offset=-20, **sc)
    (o32, lse32), _ = _one_form(form, q, k, v, **kw)
    (o16, lse16), (o16_p, _) = _one_form(form, q, k, v,
                                         out_dtype=torch.float16, **kw)
    torch.cuda.synchronize()
    assert o16.dtype == torch.float16 and o16_p.dtype == torch.float16
    ulp = 0.0 if form != "kmajor" else 2.0 ** -10
    assert _err(o16, o32.half()) <= ulp * max(1.0, o32.abs().max().item())
    assert _err(lse16, lse32) <= (0.0 if form != "kmajor" else F32_GATE)
    assert torch.all(o16[:, :, :20] == 0)
    assert torch.all(lse16[:, :, :20] == -1e30)


@pytest.mark.parametrize("form", ["bound", "kmajor"])
@pytest.mark.parametrize("qtype", ["int8", "mixed", "fp8"])
def test_wide_f32_quantize_q(dev, no_tf32, qtype, form):
    """quantize_q on an fp32 Q at d = 256: over int8 keys the host's int8
    Q runs the d = 256 int8 build (the bf16 gate); over fp8 keys it is
    dropped, and the fp32-Q build gives the unquantized call's result."""
    (q, k, v), sc = _wide_f32_inputs(dev, qtype, 2, 8, 4, 300, 600, 256, 7,
                                     True)
    kw = dict(causal=True, kv_offset=300, **sc)
    got = _pinned(form, q, k, v, quantize_q=True, **kw)
    want = flash_attention_forward_plain(q, k, v, softmax="bound_unchecked",
                                         quantize_q=True, **kw)
    torch.cuda.synchronize()
    if qtype == "fp8":
        _assert_f32_fwd(got, want)
    else:
        assert _err(got[0], want[0]) <= GATE
        assert _err(got[1], want[1]) <= GATE


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
def test_wide_f32_loose_bound_falls_back_to_online(dev, no_tf32, kv):
    """A loose bound at d = 256 (anti-aligned Q and K of huge norm): K1b
    counts the rows and the guarded fp32-Q K1 of the same storage
    rewrites them with the online kernel's bits."""
    b, h, n, d = 1, 4, 256, 256
    q, k, v = _f32_inputs(dev, b, h, h, n, n, d, 5, False)
    q = q.abs() * 20
    k = -k.abs() * 20
    k[:, :, 0] = k[:, :, 0].abs()  # one key far above the rows' scores
    sc = {}
    if kv == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif kv == "int8":
        kvq = quantize_kv(k, v, kv)
        k, v, sc = kvq.k_q, kvq.v_q, dict(k_scale=kvq.k_scale,
                                          v_scale=kvq.v_scale)
    before = _form_counts()
    got = flash_attention_forward(q, k, v, softmax="bound", **sc)
    online = flash_attention_forward(q, k, v, softmax="online", **sc)
    want = flash_attention_forward_plain(q, k, v, softmax="online", **sc)
    torch.cuda.synchronize()
    after = _form_counts()
    assert after["bound"] - before["bound"] == 1
    assert after["fallback"] - before["fallback"] == 1
    assert torch.equal(got[0], online[0]) and torch.equal(got[1], online[1])
    # the rows' LSE is ~1000 (inputs x20): held relative to it
    _assert_f32_fwd(got, want, lse_scale=want[1].abs().max().item())


def test_wide_f32_auto_routes_and_tiles(dev, no_tf32):
    """"auto" on an fp32 Q at d = 256 routes as the JAX function: the
    chunked prefill's own chunk (causal, 512 rows) to K1, its prefix read
    (not causal) to K1b with its guarded K1, a windowed read over int8
    to K5 with its guarded K1, a causal call past 5120 rows over fp32 K/V
    to K5 (32-key tiles); a block_k of 64 or 128 over fp32 K/V runs at
    the built 32 (the default's bits)."""
    from cuda_flashattention_torch.ops.common import BlockSizes
    cases = [("fp32", (2, 8, 4, 512, 512, 256), dict(causal=True),
              dict(online=1)),
             ("fp32", (2, 8, 4, 256, 1000, 256), dict(),
              dict(bound=1, fallback=1)),
             ("bf16", (2, 8, 4, 256, 1000, 256), dict(),
              dict(bound=1, fallback=1)),
             ("int8", (2, 8, 4, 256, 1000, 256),
              dict(causal=True, window=300, kv_offset=744),
              dict(kmajor=1, fallback=1)),
             ("fp32", (1, 2, 1, 5200, 5200, 256), dict(causal=True),
              dict(kmajor=1, fallback=1))]
    for kv, shape, kw, forms in cases:
        (q, k, v), sc = _wide_f32_inputs(dev, kv, *shape, 3, True)
        before = _form_counts()
        got = flash_attention_forward(q, k, v, **sc, **kw)
        torch.cuda.synchronize()
        grown = {n: _form_counts()[n] - before[n] for n in before}
        assert grown == dict(dict(online=0, bound=0, kmajor=0, fallback=0),
                             **forms), (kv, shape, grown)
        _assert_f32_fwd(got, flash_attention_forward_plain(q, k, v, **sc,
                                                           **kw))
        if kv == "fp32":
            for block_k in (64, 128):
                tiled = flash_attention_forward(
                    q, k, v, block_sizes=BlockSizes(block_k=block_k), **kw)
                torch.cuda.synchronize()
                if grown["kmajor"]:  # fp32 sums add in any order
                    assert _err(tiled[0], got[0]) <= 1e-4
                else:
                    assert torch.equal(tiled[0], got[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,nq,nk,d,causal,block_q,block_k", [
    (1, 4, 512, 512, 256, True, 256, 256),
    (2, 2, 300, 300, 256, True, 64, 64),
    (1, 2, 100, 333, 256, False, 128, 192),
    (2, 3, 37, 200, 200, False, 256, 256),   # d 200 on heads padded to 256
    (1, 2, 70, 40, 256, True, 256, 256),
])
def test_wide_fa1_kernel(dev, no_tf32, dtype, b, h, nq, nk, d, causal,
                         block_q, block_k):
    """K8 at d = 256 (bf16: two stages; fp32: 32-key split tiles, two to a
    64-key tile of a block) against the plain FA1 walk, peaked inputs:
    one launch; bf16 within 5e-3 and 2e-2 · max |plain O|, fp32 within
    1e-4."""
    q, k, v = _f32_inputs(dev, b, h, h, nq, nk, d, nq + nk + d, True)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    _nan_fill_allocator(dev)
    before = fa1_attention.launches
    o = fa1_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa1_attention.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    o_p = fa1_attention_plain(q, k, v, causal=causal,
                              block_q=max(8, min(block_q, -(-nq // 8) * 8)),
                              block_k=max(8, min(block_k, -(-nk // 8) * 8)))
    ref = o_p.float().abs().max().item()
    assert ref > 0 and torch.isfinite(o.float()).all()
    if dtype == torch.float32:
        assert _err(o, o_p) <= F32_GATE
    else:
        assert _err(o, o_p) <= min(GATE, REL_GATE * ref)


def _no_copy_call(fn, cache_bytes):
    """fn() and the peak of what it allocated past what was live before:
    below the cache's bytes, so no padded copy of the cache was made."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert grown < cache_bytes, (grown, cache_bytes)
    return out


@pytest.mark.parametrize("kw", [dict(), dict(window=100),
                                dict(quantize_q=True)])
@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_decode(dev, no_tf32, dtype, qtype, kw):
    """K6 at d = 256: a bf16 or fp32 q over every cache (fp32 too under an
    fp32 q), windows, quantize_q (two int8 words a lane), a split context;
    NaN past each live length; no copy of the cache."""
    b, h, h_kv, max_n, d = 8, 8, 4, 1100, 256
    lengths = [1100, 1, 640, 0, 999, 128, 513, 77]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for peaked in (False, True):
        q, k, v = _decode_inputs(dev, dtype, b, h, h_kv, max_n, d, 7, peaked)
        k, v, scales = _stored(k, v, qtype)
        for i, n in enumerate(lengths):
            for x in (scales.values() if scales else (k, v)):
                x[i, :, n:] = float("nan")
        nbytes = k.nbytes + v.nbytes
        before = decode_attention.launches
        got = _no_copy_call(
            lambda: decode_attention(q, k, v, lens, **scales, **kw), nbytes)
        assert decode_attention.launches == before + 1
        want = decode_attention_plain(q, k, v, lens, **scales, **kw)
        qq = kw.get("quantize_q", False) and qtype in ("int8", "mixed")
        _assert_decode_close(got, want, dtype, qq, peaked)
        assert torch.all(got[0][3] == 0) and torch.all(got[1][3] == -1e30)
    if dtype == torch.float32 and qtype is None:
        # an fp32 q over a bf16 cache (the fp32 model's half-size cache)
        kb, vb = k.bfloat16(), v.bfloat16()
        got = decode_attention(q, kb, vb, lens, **kw)
        torch.cuda.synchronize()
        _assert_decode_close(got, decode_attention_plain(
            q, kb, vb, lens, **kw), dtype, False, True)


@pytest.mark.parametrize("qtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("d", [1, 8, 20, 48, 80, 90, 96, 100, 130, 200, 250])
def test_decode_any_width(dev, d, qtype):
    """K6 at widths between its builds, read at the cache's own row width
    (vector loads where d is a multiple of a lane's elements, else one
    element at a time: d = 90, 100, 130, 250), with a window and
    quantize_q; no copy of the cache."""
    b, h, h_kv, max_n = 4, 8, 2, 700
    lengths = [700, 1, 333, 0]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q, k, v = _decode_inputs(dev, torch.bfloat16, b, h, h_kv, max_n, d,
                             d + 3, True)
    k, v, scales = _stored(k, v, qtype)
    nbytes = k.nbytes + v.nbytes
    for kw in (dict(), dict(window=100), dict(quantize_q=True)):
        got = _no_copy_call(
            lambda: decode_attention(q, k, v, lens, **scales, **kw), nbytes)
        assert got[0].shape == q.shape
        want = decode_attention_plain(q, k, v, lens, **scales, **kw)
        qq = kw.get("quantize_q", False) and qtype == "int8"
        _assert_decode_close(got, want, torch.bfloat16, qq, True)


@pytest.mark.parametrize("qtype", [None, "int8"])
def test_decode_any_width_misaligned_views(dev, qtype):
    """A cache that is a view starting one element in (its base off the
    4-byte alignment cp.async needs): its rows come in by shifted loads
    into the slots the aligned copy's TMA boxes fill, so the result is the
    copy's, bit for bit."""
    b, h, h_kv, max_n, d = 2, 4, 2, 300, 128
    lens = torch.tensor([300, 77], dtype=torch.int32, device=dev)
    q, k, v = _decode_inputs(dev, torch.bfloat16, b, h, h_kv, max_n, d, 1,
                             True)
    k, v, scales = _stored(k, v, qtype)
    kb = torch.empty(k.numel() + 1, dtype=k.dtype, device=dev)
    vb = torch.empty(v.numel() + 1, dtype=v.dtype, device=dev)
    kb.view(torch.uint8)[k.element_size():] = k.reshape(-1).view(torch.uint8)
    vb.view(torch.uint8)[v.element_size():] = v.reshape(-1).view(torch.uint8)
    ko, vo = kb[1:].view(k.shape), vb[1:].view(v.shape)
    from cuda_flashattention_torch.ops import decode as dec
    assert dec.row_copy(d, ko, vo) == 0 and dec.row_copy(d, k, v) == 16
    got = decode_attention(q, ko, vo, lens, **scales)
    torch.cuda.synchronize()
    want = decode_attention(q, k, v, lens, **scales)
    assert _err(got[0], want[0]) <= 1e-6 and _err(got[1], want[1]) <= 1e-6
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The tile walk's edges (csrc/decode_body.cuh, TileWalk): key tiles of T
# keys at multiples of T, splits of C keys; K7 bit-equal to K6 on the same
# keys at page sizes 16, 64 and 128; rows copied each way the walk copies.
# ---------------------------------------------------------------------------

_TILE_FORMS = [dict(), dict(window=90), dict(windows=[0, 1, 70, 100, 63, 3]),
               dict(quantize_q=True), dict(block_k=100),
               dict(block_k=100, window=150, quantize_q=True)]


def _launch_counts():
    from cuda_flashattention_torch.ops.paged import paged_decode_attention
    return decode_attention.launches, paged_decode_attention.launches


def _paged_same_bits(dev, q, k, v, lengths, qtype, gen, kw, pages):
    """K7 over pools of each page size holding the same keys (their own
    quantisation of k, v) against K6 on those keys: bit for bit."""
    kw = {x: y for x, y in kw.items() if x != "block_k"}
    for page in pages:
        cache, (kq, vq, ks, vs) = _paged_copy(
            dev, k, v, lengths, page, -(-max(lengths) // page) + 2, qtype,
            gen)
        o_k, lse_k = paged_decode_step(q, cache, **kw)
        torch.cuda.synchronize()
        o_c, lse_c = decode_attention(q, kq, vq, cache.lengths, k_scale=ks,
                                      v_scale=vs, **kw)
        assert torch.equal(o_k, o_c) and torch.equal(lse_k, lse_c), page


@pytest.mark.parametrize("kw", _TILE_FORMS)
@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_tile_edges(dev, d, qtype, kw):
    """Lengths 0, 1, T − 1, T + 1, 2T + 1 and past a split (T: the walk's
    key tile at this d), a window whose first key falls inside a tile,
    per-sequence windows, `quantize_q`, a split size of 100 keys (not a
    multiple of T), every cache type, on peaked inputs and NaN past each
    live context: K6 at the decode gates of the plain version; K7 over
    16-, 64- and 128-token pages bit-equal to K6."""
    from cuda_flashattention_torch.ops import decode as dec
    t = dec.key_tile(d, 1 if qtype else 2)
    lengths = [0, 1, t - 1, t + 1, 2 * t + 1, 700]
    b, h, h_kv, max_n = len(lengths), 8, 2, 704
    q, k, v = _decode_inputs(dev, torch.bfloat16, b, h, h_kv, max_n, d,
                             d + t, True)
    for i, n in enumerate(lengths):
        k[i, :, n:] = float("nan")
        v[i, :, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(kw)
    if "windows" in kw:
        kw["windows"] = torch.tensor(kw["windows"], dtype=torch.int32,
                                     device=dev)
    kq, vq, scales = _stored(k, v, qtype)
    before = _launch_counts()
    got = decode_attention(q, kq, vq, lens, **scales, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches == before[0] + 1
    assert torch.all(got[0][0] == 0) and torch.all(got[1][0] == -1e30)
    want = decode_attention_plain(q, kq, vq, lens, **scales, **kw)
    qq = kw.get("quantize_q", False) and qtype in ("int8", "mixed")
    _assert_decode_close(got, want, torch.bfloat16, qq, True)
    gen = torch.Generator(device=dev).manual_seed(d)
    _paged_same_bits(dev, q, k, v, lengths, qtype, gen, kw, (16, 64, 128))
    assert _launch_counts()[1] == before[1] + 3


@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("d", [8, 16, 32, 90, 100, 7, 91])
def test_decode_narrow_and_odd_widths_by_walk(dev, d, qtype):
    """d = 8, 16, 32 (the narrow heads), 90 and 100 (rows copied 4 and 8
    bytes at a time by cp.async), and the rows no cp.async can take (d =
    7 and 91 in bf16, d = 90, 7 and 91 over int8 or fp8), which the
    producer warp copies by shifted loads: each at the decode gates,
    with a window, K7 bit-equal to K6 on 16- and 64-token pages."""
    b, h, h_kv, max_n = 4, 8, 2, 700
    lengths = [700, 1, 333, 129]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q, k, v = _decode_inputs(dev, torch.bfloat16, b, h, h_kv, max_n, d,
                             d + 11, True)
    kq, vq, scales = _stored(k, v, qtype)
    from cuda_flashattention_torch.ops import decode as dec
    row = d * kq.element_size()
    assert dec.row_copy(d, kq, vq) == (16 if row % 16 == 0 else 8
                                        if row % 8 == 0 else 4
                                        if row % 4 == 0 else 0)
    gen = torch.Generator(device=dev).manual_seed(d)
    for kw in (dict(), dict(window=100)):
        before = _launch_counts()
        got = decode_attention(q, kq, vq, lens, **scales, **kw)
        torch.cuda.synchronize()
        assert decode_attention.launches == before[0] + 1
        want = decode_attention_plain(q, kq, vq, lens, **scales, **kw)
        _assert_decode_close(got, want, torch.bfloat16, False, True)
        _paged_same_bits(dev, q, k, v, lengths, qtype, gen, kw, (16, 64))
        assert _launch_counts()[1] == before[1] + 2


@pytest.mark.parametrize("quantize_q", [False, True])
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float16,
                                    torch.float32])
def test_serving_forms_run_the_tile_walk(dev, no_tf32, qdtype, quantize_q):
    """Every serving form (d = 64, 128, 256; every q type; every cache
    type; a window) comes in as 16-byte copies (TMA boxes: `row_copy`
    16) and launches K6 once, at its gates (an fp32 q at 1e-4, 5e-3 under
    `quantize_q`)."""
    from cuda_flashattention_torch.ops import decode as dec
    b, h, h_kv, max_n = 8, 16, 4, 640
    lengths = [640, 513, 1, 0, 64, 65, 300, 639]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    own = {torch.bfloat16: None, torch.float16: None, torch.float32: None}
    for d in (64, 128, 256):
        q, k, v = _decode_inputs(dev, qdtype, b, h, h_kv, max_n, d, d, True)
        for qtype in (own[qdtype], "int8", "fp8", "mixed"):
            kq, vq, scales = _stored(k, v, qtype)
            for kw in (dict(quantize_q=quantize_q),
                       dict(window=128, quantize_q=quantize_q)):
                assert dec.row_copy(d, kq, vq) == 16, (d, qtype)
                before = decode_attention.launches
                got = decode_attention(q, kq, vq, lens, **scales, **kw)
                torch.cuda.synchronize()
                assert decode_attention.launches == before + 1, (d, qtype)
                want = decode_attention_plain(q, kq, vq, lens, **scales,
                                              **kw)
                qq = quantize_q and qtype in ("int8", "mixed")
                _assert_decode_close(got, want, qdtype, qq,
                                     qdtype == torch.bfloat16)


@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 256),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 80),
                                     (torch.bfloat16, 90),
                                     (torch.bfloat16, 200)])
def test_wide_paged(dev, no_tf32, dtype, d, qtype):
    """K7 at d = 256 and between builds: against its plain version, bit for
    bit against K6 on the same keys, and `paged_prefix_attention` (a
    chunk's rows folded into K7's rows) against the plain prefix."""
    b, h, h_kv, page = 4, 8, 4, 128
    lengths = [300, 0, 129, 1]
    max_pages = -(-300 // page) + 2
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v = _decode_inputs(dev, dtype, b, h, h_kv, 300, d, d, True)
    cache, (kq, vq, ks, vs) = _paged_copy(dev, k, v, lengths, page,
                                          max_pages, qtype, gen)
    for kw in (dict(), dict(window=100)):
        before = paged_decode_attention.launches
        got = paged_decode_step(q, cache, **kw)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == before + 1
        want = paged_decode_attention_plain(
            q, cache.k_pages, cache.v_pages, cache.page_table,
            cache.lengths, k_scale=cache.k_scale, v_scale=cache.v_scale,
            **kw)
        _assert_decode_close(got, want, dtype, False, True)
        o_c, lse_c = decode_attention(q, kq, vq, cache.lengths, k_scale=ks,
                                      v_scale=vs, **kw)
        assert torch.equal(got[0], o_c) and torch.equal(got[1], lse_c)
    if dtype == torch.bfloat16:
        qc = _decode_inputs(dev, dtype, b, h * 16, h_kv, 1, d, 5, True)[0]
        qc = qc.view(b, h, 16, d)
        got = paged_prefix_attention(qc, cache)
        torch.cuda.synchronize()
        want = paged_decode_attention_plain(
            qc.reshape(b, h * 16, d), cache.k_pages, cache.v_pages,
            cache.page_table, cache.lengths, k_scale=cache.k_scale,
            v_scale=cache.v_scale)
        _assert_decode_close((got[0].reshape(b, h * 16, d),
                              got[1].reshape(b, h * 16)), want, dtype,
                             False, True)


# ---------------------------------------------------------------------------
# The backward at d = 256: K4, K2 + K3 and the prologue's d = 256 builds
# against the plain backward (BWD_GATE per gradient, on peaked inputs: Q x8,
# K x4), over every mask, GQA 8:4 and 16:4, ragged shapes with empty rows
# and unseen keys, widths between 128 and 256 on zero-padded heads, a ring
# step's full block against a global LSE, autograd, and a seeded fuzz of
# the backward at d in {64, 128, 256}.
# ---------------------------------------------------------------------------


def _wide_bwd(dev, b, h, h_kv, nq, nk, d, seed, fused, **kw):
    """The backward into NaN-filled memory against the plain one, on the
    forward's O and LSE: finite gradients of the input shapes, each within
    BWD_GATE · max |plain| (or all zero where the plain one is), one
    prologue launch and one K4 (or K2 + K3)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (_rand(gen, dev, b, h, nq, d).float() * 8).to(torch.bfloat16)
    k = (_rand(gen, dev, b, h_kv, nk, d).float() * 4).to(torch.bfloat16)
    v, do = _rand(gen, dev, b, h_kv, nk, d), _rand(gen, dev, b, h, nq, d)
    o, lse = flash_attention_forward(q, k, v, **kw)
    args = (q, k, v, o, lse, do)
    _nan_fill_allocator(dev)
    before = dict(flash_attention_backward.launches)
    got = flash_attention_backward(*args, fused=fused, **kw)
    torch.cuda.synchronize()
    grown = {n: flash_attention_backward.launches[n] - before[n]
             for n in before}
    assert grown == ({"fused": 1, "dkdv": 0, "dq": 0, "delta": 1} if fused
                     else {"fused": 0, "dkdv": 1, "dq": 1, "delta": 1})
    want = flash_attention_backward_plain(*args, **kw)
    what = (b, h, h_kv, nq, nk, d, fused, kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        assert torch.isfinite(g.float()).all(), (what, name)
        if torch.all(w == 0):
            assert torch.all(g == 0), (what, name)
        else:
            _assert_rel(g, w, f"{what} {name}")
    return got


WIDE_BWD_CASES = [
    # the Gemma-width layer (8 query heads over 4 KV heads)
    (1, 8, 4, 1024, 1024, dict(causal=True)),
    (1, 16, 4, 300, 300, dict(causal=True)),                 # GQA 16:4
    (2, 8, 4, 300, 300, dict(causal=True, window=100)),
    (1, 8, 4, 200, 333, dict(causal=True, kv_offset=133)),
    # empty rows and unseen keys, whole 64-key tiles among them
    (1, 4, 2, 70, 260, dict(causal=True, kv_offset=-20)),
    (1, 8, 4, 130, 500, dict(causal=True, window=70, kv_offset=370)),
    (1, 4, 4, 200, 200, dict(causal=True, window=64, kv_offset=-70)),
    (2, 8, 2, 128, 384, dict(causal=False)),
    (1, 8, 8, 100, 63, dict(causal=False)),                  # Nk < a tile
    (1, 8, 4, 65, 129, dict(causal=True, kv_offset=64)),     # tile edges
]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,kw", WIDE_BWD_CASES)
def test_wide_backward_kernels(dev, b, h, h_kv, nq, nk, kw, fused):
    _wide_bwd(dev, b, h, h_kv, nq, nk, 256, nq + nk, fused, **kw)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_backward_segments(dev, causal, fused):
    """The SEG builds at d = 256: segments ending one key before, at and
    after 64- and 32-key tile edges, and one of a single token."""
    n = 300
    seg = _segments(dev, 2, n, [63, 1, 65, 128, 43])
    _wide_bwd(dev, 2, 8, 4, n, n, 256, 7, fused, causal=causal,
              q_segment_ids=seg, kv_segment_ids=seg)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("d", [136, 160, 200])
def test_wide_backward_between_builds(dev, d, fused):
    """A d between 128 and 256 runs on the d = 256 build, heads zero-padded
    at the caller's scale; the gradients come back at width d."""
    got = _wide_bwd(dev, 1, 8, 4, 200, 333, d, d, fused, causal=True,
                    kv_offset=133)
    assert got[0].shape[-1] == d and got[1].shape[-1] == d


def test_wide_fused_matches_split_and_repeats(dev):
    """At d = 256 K4 and K2 + K3 agree within the gate; two K4 runs give
    dK and dV bit for bit and dQ within one bf16 step of its largest
    value (its atomics land in no fixed order)."""
    a = _wide_bwd(dev, 1, 8, 4, 1000, 1000, 256, 3, True, causal=True)
    s = _wide_bwd(dev, 1, 8, 4, 1000, 1000, 256, 3, False, causal=True)
    for x, y, name in zip(a, s, ("dQ", "dK", "dV")):
        _assert_rel(x, y, name)
    b_ = _wide_bwd(dev, 1, 8, 4, 1000, 1000, 256, 3, True, causal=True)
    assert torch.equal(a[1], b_[1]) and torch.equal(a[2], b_[2])
    top = a[0].float().abs().max().item()
    assert _err(a[0], b_[0]) <= 2.0 ** -7 * top


def test_wide_backward_on_a_ring_step(dev):
    """K4 on a ring step's full block at d = 256 (`parallel/ring.py`'s
    `_step_bwd`: an off-diagonal block, non-causal, against the LSE of the
    whole two-block context) against the plain backward."""
    from cuda_flashattention_torch.parallel.ring import _step_bwd
    gen = torch.Generator(device=dev).manual_seed(11)
    h, h_kv, n, d = 8, 4, 512, 256
    q = (_rand(gen, dev, 1, h, n, d).float() * 8).to(torch.bfloat16)
    k, v = (_rand(gen, dev, 1, h_kv, 2 * n, d) for _ in range(2))
    do = _rand(gen, dev, 1, h, n, d)
    # the global O and LSE: the query block attends both key blocks
    o, lse = flash_attention_forward(q, k, v, out_dtype=torch.float32)
    kb, vb = k[:, :, :n].contiguous(), v[:, :, :n].contiguous()
    before = flash_attention_backward.launches["fused"]
    got = _step_bwd(q, kb, vb, o, lse, do, 0, 1, scale=None, causal=True,
                    window=0, step=1, shard_len=n)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches["fused"] == before + 1
    want = flash_attention_backward_plain(q, kb, vb, o, lse, do)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        _assert_rel(g, w, name)


def test_wide_autograd_through_the_kernels(dev):
    """flash_attention at d = 256 on strided [B,N,H,d] views: K1 once, K4
    once (the forward's O and LSE saved for it), gradients as the plain
    backward's."""
    gen = torch.Generator(device=dev).manual_seed(12)
    q = _rand(gen, dev, 2, 300, 8, 256).transpose(1, 2).requires_grad_(True)
    k = _rand(gen, dev, 2, 300, 4, 256).transpose(1, 2).requires_grad_(True)
    v = _rand(gen, dev, 2, 300, 4, 256).transpose(1, 2).requires_grad_(True)
    do = _rand(gen, dev, 2, 300, 8, 256).transpose(1, 2)
    fwd0 = flash_attention_forward.launches
    bwd0 = flash_attention_backward.launches["fused"]
    o = flash_attention(q, k, v, causal=True, window=90)
    grads = torch.autograd.grad(o, (q, k, v), grad_outputs=do)
    torch.cuda.synchronize()
    assert flash_attention_forward.launches == fwd0 + 1
    assert flash_attention_backward.launches["fused"] == bwd0 + 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    _, lse = flash_attention_forward_plain(qd, kd, vd, causal=True,
                                           window=90)
    want = flash_attention_backward_plain(qd, kd, vd, o.detach(), lse, do,
                                          causal=True, window=90)
    for g, w, name in zip(grads, want, ("dQ", "dK", "dV")):
        _assert_rel(g, w, name)


def test_fuzz_backward(dev):
    """Twelve seeded random cases: nq, nk, GQA group, d in {64, 128, 256},
    causal / window / segment ids / kv_offset (stacked at random), fused
    and split, each against the plain backward (BWD_GATE)."""
    import numpy as np
    rng = np.random.default_rng(2025)
    for case in range(12):
        d = int(rng.choice([64, 128, 256]))
        h_kv = int(rng.choice([1, 2, 4]))
        h = h_kv * int(rng.choice([1, 2, 4]))
        nq, nk = int(rng.integers(1, 600)), int(rng.integers(1, 700))
        kw = {}
        if rng.random() < 0.75:
            kw = dict(causal=True, kv_offset=int(rng.integers(-60, nk)))
            if rng.random() < 0.5:
                kw["window"] = int(rng.integers(1, nk + 1))
        if rng.random() < 0.4:
            cuts = np.sort(rng.integers(0, min(nq, nk) + 1, 3))
            lengths = np.diff(np.concatenate([[0], cuts, [max(nq, nk)]]))
            kw["q_segment_ids"] = _segments(dev, 1, nq, lengths.tolist())
            kw["kv_segment_ids"] = _segments(dev, 1, nk, lengths.tolist())
        _wide_bwd(dev, 1, h, h_kv, nq, nk, d, case, bool(rng.random() < 0.5),
                  **kw)


# ---------------------------------------------------------------------------
# fp32 at d = 256 in the backward: K4 and K2 (64-key CTAs streaming 32-row
# split Q / dO tiles, one stage) and K3 (64-row CTAs, one consumer
# warpgroup, 16-key split tiles), every mask, d = 256 and 200 (zero-padded
# heads), flat and peaked (Q x8, K x4) inputs; K9 at d = 256 and between
# builds, bf16 and fp32. Gates: 1e-4 · max(1, max |plain|) per gradient;
# K9 bf16 within min(1e-2, 2e-2 · max |ref|), fp32 within 1e-4 · max(1,
# max |ref|).
# ---------------------------------------------------------------------------

WIDE_F32_BWD_CASES = [
    # the Gemma-width layer (8 query heads over 4 KV heads)
    (1, 8, 4, 1024, 1024, dict(causal=True)),
    (1, 8, 4, 600, 600, dict(causal=True, window=100)),
    # ragged, empty rows and unseen keys
    (2, 8, 4, 300, 400, dict(causal=True, kv_offset=-20)),
    (1, 16, 4, 300, 300, dict(causal=True)),                 # GQA 16:4
    (1, 8, 4, 130, 500, dict(causal=True, window=70, kv_offset=370)),
    (2, 8, 2, 128, 384, dict(causal=False)),
    (1, 8, 8, 100, 63, dict()),                              # Nk < a tile
    (1, 8, 4, 65, 129, dict(causal=True, kv_offset=64)),     # tile edges
]


def _wide_f32_bwd(dev, b, h, h_kv, nq, nk, d, seed, fused, peaked, **kw):
    """The fp32 backward into NaN-filled memory against the plain fp32
    one: fp32 gradients of the input shapes, each within 1e-4 · max(1, max
    |plain|) (all zero where the plain one is), one prologue launch and
    one K4 (or K2 + K3)."""
    args = _f32_bwd_inputs(dev, b, h, h_kv, nq, nk, d, kw, peaked, seed)
    want = flash_attention_backward_plain(*args, **kw)
    _nan_fill_allocator(dev)
    before = dict(flash_attention_backward.launches)
    got = flash_attention_backward(*args, fused=fused, **kw)
    torch.cuda.synchronize()
    grown = {n: flash_attention_backward.launches[n] - before[n]
             for n in before}
    assert grown == ({"fused": 1, "dkdv": 0, "dq": 0, "delta": 1} if fused
                     else {"fused": 0, "dkdv": 1, "dq": 1, "delta": 1})
    what = (b, h, h_kv, nq, nk, d, fused, peaked, kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert g.shape == w.shape and torch.isfinite(g).all(), (what, name)
        if torch.all(w == 0):
            assert torch.all(g == 0), (what, name)
        else:
            _assert_f32_grad(g, w, f"{what} {name}")
    return got


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,kw", WIDE_F32_BWD_CASES)
def test_wide_f32_backward_kernels(dev, no_tf32, b, h, h_kv, nq, nk, kw, d,
                                   fused, peaked):
    got = _wide_f32_bwd(dev, b, h, h_kv, nq, nk, d, nq + nk + d, fused,
                        peaked, **kw)
    assert all(g.shape[-1] == d for g in got)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_f32_backward_segments(dev, no_tf32, causal, fused):
    """The fp32 SEG builds at d = 256: segments ending one key before, at
    and after 16-, 32- and 64-key tile edges, and one of a single
    token."""
    n = 300
    seg = _segments(dev, 2, n, [63, 1, 65, 128, 43])
    _wide_f32_bwd(dev, 2, 8, 4, n, n, 256, 7, fused, True, causal=causal,
                  q_segment_ids=seg, kv_segment_ids=seg)


def test_wide_f32_k2_matches_k4(dev, no_tf32):
    """K2 and K4's fp32 d = 256 builds share the dK / dV walk: the same
    bits; K2 + K3 and K4 agree within the fp32 gate."""
    from cuda_flashattention_torch.ops import flash_bwd as fb
    kw = dict(causal=True, window=300)
    args = _f32_bwd_inputs(dev, 1, 8, 4, 700, 700, 256, kw, True, 5)
    fused = flash_attention_backward(*args, fused=True, **kw)
    split = flash_attention_backward(*args, fused=False, **kw)
    dk2, dv2 = fb._dkdv_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dk2, fused[1]) and torch.equal(dv2, fused[2])
    assert torch.equal(split[1], fused[1]) and torch.equal(split[2],
                                                           fused[2])
    _assert_f32_grad(split[0], fused[0], "dQ")


def test_wide_f32_autograd_through_the_kernels(dev, no_tf32):
    """flash_attention at d = 256 on fp32 [B,N,H,d] views: K1 once and K4
    once, fp32 gradients within the fp32 gate of the plain backward."""
    gen = torch.Generator(device=dev).manual_seed(4)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5
    q = u(2, 300, 8, 256).transpose(1, 2).requires_grad_(True)
    k = u(2, 300, 4, 256).transpose(1, 2).requires_grad_(True)
    v = u(2, 300, 4, 256).transpose(1, 2).requires_grad_(True)
    do = u(2, 300, 8, 256).transpose(1, 2)
    fwd0 = flash_attention_forward.launches
    bwd0 = flash_attention_backward.launches["fused"]
    o = flash_attention(q, k, v, causal=True, window=90)
    grads = torch.autograd.grad(o, (q, k, v), grad_outputs=do)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32
    assert flash_attention_forward.launches == fwd0 + 1
    assert flash_attention_backward.launches["fused"] == bwd0 + 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o_p, lse = flash_attention_forward_plain(qd, kd, vd, causal=True,
                                             window=90)
    assert _err(o, o_p) <= F32_GATE
    want = flash_attention_backward_plain(qd, kd, vd, o_p, lse, do,
                                          causal=True, window=90)
    for g, w, name in zip(grads, want, ("dQ", "dK", "dV")):
        _assert_f32_grad(g, w, name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,rows,d", [(1, 64, 256), (4, 1024, 256),
                                      (8, 192, 256), (3, 8192, 256),
                                      (4, 1024, 200), (2, 128, 100),
                                      (2, 192, 8)])
def test_wide_device_ring_kernel(dev, no_tf32, dtype, n, rows, d):
    """K9 at d = 256 (bf16: W whole, one tile a round; fp32: two CTAs a
    span, one per column half of W) and at widths between builds (x and W
    zero-padded, o sliced back) against the plain ring and (Σ x_i) @ W in
    fp32, one launch; 3 more calls give the first's bits."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    gen = torch.Generator(device=dev).manual_seed(n * rows + d)
    x = (torch.rand((n * rows, d), generator=gen, device=dev) - 0.5).to(
        dtype)
    w = (torch.rand((d, d), generator=gen, device=dev) - 0.5).to(dtype)
    mesh = _ring_mesh(dev, n)
    before = device_ring_matmul.launches
    o = device_ring_matmul(x, w, mesh)
    torch.cuda.synchronize()
    assert device_ring_matmul.launches == before + 1
    assert o.dtype == torch.float32 and o.shape == (n * rows, d)
    ref = _ring_ref(x, w, n)
    top = ref.abs().max().item()
    gate = (F32_GATE * max(1.0, top) if dtype == torch.float32
            else min(1e-2, 2e-2 * top))
    assert top > 0 and _err(o, ref) <= gate, _err(o, ref)
    assert _err(o, ring_matmul_plain(x, w, mesh)) <= gate
    for _ in range(3):
        assert torch.equal(device_ring_matmul(x, w, mesh), o)


# ---------------------------------------------------------------------------
# The mesh across processes (scripts/launch_multihost.py)
# ---------------------------------------------------------------------------

MP_PATHS = ("ring_causal", "ring_ragged", "decode", "ulysses", "collectives",
            "train")


def _mp_launch(tmp_path, nproc, per_proc, env_extra=None, timeout=600,
               args=None):
    """`utils/multiprocess_paths.py --check` over every path, bf16 at
    B=1 H=8 Hkv=4 N=4096 d=128 (decode B=4; the small fp32 model, sp over
    every rank), or over `args`, launched as `nproc` processes of
    `per_proc` ranks; each process's report."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    out = tmp_path / "mp"
    cmd = [sys.executable, "-m",
           "cuda_flashattention_torch.scripts.launch_multihost", "-np",
           str(nproc), "--devices-per-proc", str(per_proc), "--timeout",
           str(timeout - 30), "-m",
           "cuda_flashattention_torch.utils.multiprocess_paths", "--out",
           str(out), "--check", *(args or [
               "--dtype", "bf16", "--batch", "1", "--decode-batch", "4",
               "--heads", "8", "--kv-heads", "4", "--d", "128", "--seq",
               "4096", "--train-seq", "64", "--axes",
               f"sp={nproc * per_proc}", *MP_PATHS])]
    env = dict(os.environ, PYTHONPATH=str(repo), **(env_extra or {}))
    r = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return [json.loads((out / f"p{p}.json").read_text())
            for p in range(nproc)]


def _mp_check(reports, transport):
    """Every process names the transport; process 0's paths against its
    own one-process runs at the ring's gates (O min(5e-3, 2e-2 · max),
    gradients 2e-2 · max), decode 5e-3 against K6 on the whole cache,
    the collectives bit for bit, the train step's loss 2e-2 and every
    gradient 5e-2 relative L2; the ring's forward and K4 launches, summed
    over the processes, are the one-process ring's."""
    assert all(r["transport"] == transport for r in reports), reports
    paths = reports[0]["paths"]
    for path in ("ring_causal", "ring_ragged", "ulysses"):
        e = paths[path]["errors"]
        assert e["o"][0] <= min(GATE, 2e-2 * e["o"][1]), (path, e)
        for g in ("dq", "dk", "dv"):
            assert e[g][1] > 0 and e[g][0] <= BWD_GATE * e[g][1], (path, e)
    for name in ("o", "lse", "o@whole", "lse@whole"):
        assert paths["decode"]["errors"][name][0] <= GATE, paths["decode"]
    assert all(v[0] == 0.0 for v in paths["collectives"]["errors"].values())
    e = paths["train"]["errors"]
    assert e["loss"][0] <= 2e-2, e
    assert all(v[2] <= 5e-2 for k, v in e.items() if k != "loss"), e
    n = reports[0]["ranks"]
    fwd = sum(r["paths"]["ring_causal"]["launches"]["fwd"] for r in reports)
    k4 = sum(r["paths"]["ring_causal"]["launches"]["bwd"]["fused"]
             for r in reports)
    assert k4 == n * (n + 1) // 2, reports
    assert fwd >= k4, reports


def test_multiprocess_staged_on_one_card(dev, tmp_path):
    """Two processes of two ranks each on card 0 (processes that share a
    card: the staged transport, device → pinned host → gloo → device)."""
    _mp_check(_mp_launch(tmp_path, 2, 2, {"CUDA_VISIBLE_DEVICES": "0"}),
              "staged")


def test_multiprocess_nccl_across_cards(dev, tmp_path):
    """With two or more cards visible: one process per card (up to 4), one
    rank each: NCCL send / recv."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    _mp_check(_mp_launch(tmp_path, min(cards, 4), 1), "nccl")


# K9 and pipelined training across processes: n = 4 ranks, L = 1024,
# d 128 and 256, bf16 and fp32; the small fp32 model at B=4 x 64
MP_K9 = ["--k9-rows", "1024", "--k9-d", "128", "256", "--k9-dtypes",
         "bf16", "fp32", "--k9-repeats", "5"]


def _mp_k9_pipe(tmp_path, nproc, per_proc, pipe_axes, micro,
                env_extra=None):
    """`utils/multiprocess_paths.py --check k9 pipe_train` in `nproc`
    processes of `per_proc` ranks; each process's report."""
    return _mp_launch(tmp_path, nproc, per_proc, env_extra, args=[
        *MP_K9, "--pipe-axes", pipe_axes, "--micro", str(micro),
        "--pipe-batch", "4", "--seq", "64", "k9", "pipe_train"])


def _mp_k9_pipe_check(reports, transport):
    """K9: every case within its gate of the fp32 reference (bf16
    min(1e-2, 2e-2 · max), fp32 1e-4 · max(1, max)), bit for bit the
    one-process K9, every repeat bit-identical, one launch per case in
    each process, the .sys scope; the pipelined step's loss within 1e-5
    and every gradient within 1e-4 · max of the same step in one
    process."""
    assert all(r["transport"] == transport for r in reports), reports
    k9 = reports[0]["paths"]["k9"]
    for key, t in k9["k9"].items():
        got, top, _ = k9["errors"][f"o[{key}]@ref"]
        gate = (1e-4 * max(1.0, top) if key.endswith("fp32")
                else min(1e-2, 2e-2 * top))
        assert top > 0 and got <= gate, (key, got, gate)
        assert k9["errors"][f"o[{key}]"][0] == 0.0, (key, k9["errors"])
        assert t["scope"] == "sys", t
        for r in reports:
            row = r["paths"]["k9"]["k9"][key]
            assert row["same"] == row["repeats"], (key, row)
    cases = len(k9["k9"])
    assert all(r["paths"]["k9"]["launches"]["k9"] == cases
               for r in reports), reports
    e = reports[0]["paths"]["pipe_train"]["errors"]
    assert e["loss"][0] <= 1e-5, e
    assert all(v[1] > 0 and v[0] <= 1e-4 * v[1]
               for k, v in e.items() if k != "loss"), e


def test_multiprocess_device_ring_and_pipeline_on_one_card(dev, tmp_path):
    """Two processes of two ranks each on card 0: K9 over a ring of 4
    whose neighbours in the other process are reached through buffers
    and flags mapped by CUDA IPC handles (the card time-slices the two
    processes' kernels), and the pipelined training step at pp=2 over one
    rank of each process (GPipe's backward across processes)."""
    _mp_k9_pipe_check(_mp_k9_pipe(tmp_path, 2, 2, "pp=2", 2,
                                  {"CUDA_VISIBLE_DEVICES": "0"}), "staged")


def test_multiprocess_device_ring_and_pipeline_across_cards(dev, tmp_path):
    """With two or more cards visible: one process per card (2, or 4 with
    pp=2·dp=2), one rank each: K9 over NVLink between processes, and the
    pipelined step over NCCL."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    n = 4 if cards >= 4 else 2
    _mp_k9_pipe_check(_mp_k9_pipe(tmp_path, n, 1, "pp=2" if n == 2
                                  else "pp=2,dp=2", 2), "nccl")


def test_multiprocess_device_ring_late_neighbour(dev, tmp_path):
    """A process of the ring that reaches its call 5 s after the other:
    the other waits on the host before its launch (the ring's barrier),
    so no kernel spins out its trap; both calls finish and equal the
    first call bit for bit."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    script = tmp_path / "late.py"
    script.write_text("""
import time
import torch
from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.parallel import mesh as M
from cuda_flashattention_torch.parallel.device_ring import device_ring_matmul
devs = _ladder.devices(None, False)
home = _ladder.home(devs)
mesh = M.make_mesh((4,), ("sp",), devs)
g = torch.Generator().manual_seed(0)
x = torch.randn(4 * 1024, 128, generator=g).to(home, torch.bfloat16)
w = (torch.randn(128, 128, generator=g) * 0.1).to(home, torch.bfloat16)
first = device_ring_matmul(x, w, mesh)
torch.cuda.synchronize()
if M.process_index() == 1:
    time.sleep(5)
t0 = time.perf_counter()
again = device_ring_matmul(x, w, mesh)
torch.cuda.synchronize()
print(f"late p{M.process_index()} {time.perf_counter() - t0:.3f} s, waited "
      f"{device_ring_matmul.last_start_s:.3f} s, equal "
      f"{torch.equal(first, again)}", flush=True)
assert torch.equal(first, again)
""")
    r = subprocess.run(
        [sys.executable, "-m",
         "cuda_flashattention_torch.scripts.launch_multihost", "-np", "2",
         "--devices-per-proc", "2", "--timeout", "240", str(script)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo),
                           CUDA_VISIBLE_DEVICES="0"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    waited = float(r.stdout.split("waited ")[1].split(" s")[0])
    assert waited >= 4.0 and "equal True" in r.stdout, r.stdout


@pytest.mark.parametrize("placed", [False, True], ids=["restacked",
                                                       "placed"])
def test_pipeline_training_on_the_card(dev, placed):
    """The pipelined training step in one process, 2 stages sharing the
    card, over the restacked layers and over `stage_param_sharding`'s
    placed stages: loss within 2e-2 and every gradient within 5e-2
    relative L2 of `loss_fn` without a mesh; K1, K4 and the prologue once
    per layer and microbatch."""
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    from cuda_flashattention_torch.utils.multiprocess_paths import pipe_loss
    cfg = tfm.TransformerConfig(vocab_size=512, d_model=256, n_layers=4,
                                n_heads=2, n_kv_heads=2, d_head=128,
                                d_ff=512, max_seq=256, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tfm.Transformer(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                           device=dev, dtype=torch.int32)
    ref = tfm.loss_fn(model, tokens)
    ref.backward()
    want = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    mesh = make_mesh((2,), ("pp",), [dev] * 2)
    flash_attention_forward.form_launches["online"] = 0
    for k in flash_attention_backward.launches:
        flash_attention_backward.launches[k] = 0
    loss = pipe_loss(model, tokens, mesh, 2, placed=placed)
    loss.backward()
    torch.cuda.synchronize()
    assert flash_attention_forward.form_launches["online"] == 8
    assert flash_attention_backward.launches == dict(
        dkdv=0, dq=0, fused=8, delta=8)
    assert abs(loss.item() - ref.item()) <= 2e-2
    for n, p in model.named_parameters():
        g = p.grad.float()
        assert torch.isfinite(g).all(), n
        assert ((g - want[n]).norm() / want[n].norm()).item() <= 5e-2, n


# -- fp16 builds and mixed float types --------------------------------------
#
# fp16 runs the fp16 units' builds (csrc/*_f16.cu: bf16's kernels with fp16
# operands, wgmma .f16, P and dS rounded to fp16) at the bf16 gates. Mixed
# float types run the fp32 builds on exactly upcast operands, P (dS)
# rounded to the type JAX rounds it to: held to 1e-4 · max(1, max |plain|)
# plus one ulp of the output's and of P's type at the plain version's
# largest |O| and |V| (a P at a rounding boundary may round the other way).

_ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
        torch.float16: 2.0 ** -10}


def _u(gen, dev, *shape, scale=1.0):
    return (torch.rand(shape, generator=gen, device=dev) - 0.5) * scale


def _assert_mixed(got, want, v, p_type):
    o, o_p = got, want
    top = o_p.float().abs().max().item()
    vtop = v.float().abs().max().item()
    assert top > 0 and torch.isfinite(o.float()).all()
    gate = (1e-4 * max(1.0, top) + _ULP[o_p.dtype] * top
            + _ULP[p_type] * vtop)
    assert _err(o, o_p) <= gate, (_err(o, o_p), gate)


# Peaked inputs of the bound forms in fp16 (and of any fp16 P): P = 2^(s −
# c) against the Cauchy–Schwarz bound c is rounded to fp16, whose least
# subnormal is 2^-24, as the JAX kernel rounds it; at Q x8, K x4 the bound
# sits ~30 log2 units above the scores and every P underflows (JAX's too).
# Q x4, K x1 keep c within ~8 units.
_F16_BOUND_PEAK = (4.0, 1.0)

_F16_FWD = [
    (2, 16, 4, 512, 512, 128, dict(causal=True)),
    (1, 4, 2, 37, 53, 64, dict(causal=True, kv_offset=16)),
    (2, 8, 8, 100, 300, 128, dict()),
    (1, 8, 4, 300, 300, 256, dict(causal=True)),
    (1, 4, 2, 200, 200, 200, dict(causal=True)),
    (2, 4, 2, 90, 90, 16, dict()),
    (2, 8, 2, 300, 300, 128, dict(causal=True, window=100)),
    (1, 4, 4, 200, 200, 128, dict(causal=True, window=64, kv_offset=-70)),
]


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("qtype", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("form", ["online", "bound", "kmajor"])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw", _F16_FWD)
def test_f16_forward_forms(dev, b, h, h_kv, nq, nk, d, kw, form, qtype,
                           peaked):
    """An fp16 Q over fp16 or one-byte K/V: K1, K1b and K5 of the fp16
    unit against the plain version (P rounded to fp16), O in fp16; K5 within
    1e-4 of K1b (fp32 O). Peaked inputs: Q x8, K x4 online; the bound forms
    Q x4, K x1 (_F16_BOUND_PEAK)."""
    gen = torch.Generator(device=dev).manual_seed(nq + nk + d)
    sq, sk = ((8.0, 4.0) if form == "online" else _F16_BOUND_PEAK) if (
        peaked) else (1.0, 1.0)
    q = _u(gen, dev, b, h, nq, d, scale=sq).half()
    k = _u(gen, dev, b, h_kv, nk, d, scale=sk).half()
    v = _u(gen, dev, b, h_kv, nk, d).half()
    k, v, scales = _stored(k, v, qtype)
    kw = dict(kw, **scales)
    if form == "online":
        got = flash_attention_forward(q, k, v, softmax="online", **kw)
        want = flash_attention_forward_plain(q, k, v, softmax="online", **kw)
    else:
        got = _pinned(form, q, k, v, out_dtype=torch.float16, **kw)
        want = flash_attention_forward_plain(
            q, k, v, softmax="bound_unchecked", **kw)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float16
    _assert_fwd_close(got, want)
    if form == "kmajor":
        ref = _pinned("bound", q, k, v, **kw)[0]
        assert _err(_pinned("kmajor", q, k, v, **kw)[0], ref) <= 1e-4


@pytest.mark.parametrize("qtype", ["int8", "mixed", "fp8"])
def test_f16_forward_quantize_q(dev, qtype):
    """quantize_q under an fp16 Q: over int8 keys the bf16 unit's int8-Q
    build (P·V in bf16, as JAX's), O fp16; over fp8 keys the flag is
    dropped (JAX's rule) and the fp16 build runs."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = _u(gen, dev, 2, 16, 100, 128, scale=_F16_BOUND_PEAK[0]).half()
    k = _u(gen, dev, 2, 4, 300, 128, scale=_F16_BOUND_PEAK[1]).half()
    v = _u(gen, dev, 2, 4, 300, 128).half()
    k, v, scales = _stored(k, v, qtype)
    kw = dict(causal=True, kv_offset=200, quantize_q=True, **scales)
    got = flash_attention_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float16
    _assert_fwd_close(got, flash_attention_forward_plain(q, k, v, **kw))


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(),
                                dict(causal=True, window=256)])
def test_f16_forward_tiles_and_segments(dev, block_k, kw):
    """The fp16 unit's 64- and 128-key builds of K1 and K1b; segment ids."""
    from cuda_flashattention_torch.ops.common import BlockSizes
    gen = torch.Generator(device=dev).manual_seed(block_k)
    q = _u(gen, dev, 1, 16, 1024, 128).half()
    k, v = _u(gen, dev, 1, 4, 1024, 128).half(), _u(gen, dev, 1, 4, 1024,
                                                    128).half()
    bs = BlockSizes(block_k=block_k)
    for softmax in ("online", "bound"):
        if softmax == "bound" and kw.get("causal"):
            continue
        got = flash_attention_forward(q, k, v, softmax=softmax,
                                      block_sizes=bs, **kw)
        want = flash_attention_forward_plain(q, k, v, softmax=softmax, **kw)
        torch.cuda.synchronize()
        _assert_fwd_close(got, want)
    ids = torch.arange(1024, device=dev) // 300
    seg = dict(q_segment_ids=ids[None], kv_segment_ids=ids[None])
    got = flash_attention_forward(q, k, v, block_sizes=bs, **seg, **kw)
    _assert_fwd_close(got, flash_attention_forward_plain(q, k, v, **seg,
                                                          **kw))


def test_f16_out_is_the_fp32_out_rounded(dev):
    """fp16 O from the fp16 builds' epilogue is their fp32 O rounded."""
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _u(gen, dev, 1, 8, 512, 128).half()
    k, v = _u(gen, dev, 1, 8, 512, 128).half(), _u(gen, dev, 1, 8, 512,
                                                   128).half()
    # K1 causal and K1b (not causal: a causal bound call is K5's, whose
    # fp32 sums add in any order)
    for softmax, causal in (("online", True), ("bound_unchecked", False)):
        o32, _ = flash_attention_forward(q, k, v, causal=causal,
                                         softmax=softmax,
                                         out_dtype=torch.float32)
        o16, _ = flash_attention_forward(q, k, v, causal=causal,
                                         softmax=softmax)
        assert torch.equal(o16, o32.half())


_MIXED = [(torch.bfloat16, torch.float32, torch.float32),
          (torch.float16, torch.float32, torch.float32),
          (torch.float16, torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float16, torch.float16),
          (torch.float32, torch.float16, torch.float16),
          (torch.bfloat16, torch.bfloat16, torch.float32),
          (torch.float16, torch.float16, torch.bfloat16)]


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("form", ["online", "bound", "kmajor"])
@pytest.mark.parametrize("types", _MIXED)
def test_mixed_forward(dev, types, form, d, no_tf32):
    """Q, K, V of mixed float types: the fp32 builds on upcast operands, P
    rounded to Q's type, O in Q's type, against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(d)
    tq, tk, tv = types
    q = _u(gen, dev, 2, 8, 200, d, scale=_F16_BOUND_PEAK[0]).to(tq)
    k = _u(gen, dev, 2, 4, 300, d, scale=_F16_BOUND_PEAK[1]).to(tk)
    v = _u(gen, dev, 2, 4, 300, d).to(tv)
    kw = dict(causal=True, kv_offset=100)
    if form == "online":
        got = flash_attention_forward(q, k, v, softmax="online", **kw)[0]
        want = flash_attention_forward_plain(q, k, v, softmax="online",
                                             **kw)[0]
    else:
        got = _pinned(form, q, k, v, out_dtype=tq, **kw)[0]
        want = flash_attention_forward_plain(
            q, k, v, softmax="bound_unchecked", **kw)[0]
    torch.cuda.synchronize()
    assert got.dtype == tq
    _assert_mixed(got, want, v, tq)


@pytest.mark.parametrize("tq", [torch.bfloat16, torch.float16])
def test_mixed_forward_rounds_p(dev, tq, no_tf32):
    """The rounding flag acts: a 2-byte Q over fp32 K/V (fp32 O, peaked
    scores) sits on the plain version that rounds P to Q's type, and off
    the one that leaves P unrounded (the same call on Q upcast) by far
    more than its own distance, on average over O."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q = _u(gen, dev, 1, 16, 512, 128, scale=8).to(tq)
    k = _u(gen, dev, 1, 16, 512, 128, scale=4)
    v = _u(gen, dev, 1, 16, 512, 128)
    kw = dict(causal=True, out_dtype=torch.float32, softmax="online")
    o, _ = flash_attention_forward(q, k, v, **kw)
    rounded, _ = flash_attention_forward_plain(q, k, v, **kw)
    unrounded, _ = flash_attention_forward_plain(q.float(), k, v, **kw)
    near = (o - rounded).abs().mean().item()
    far = (o - unrounded).abs().mean().item()
    assert far > 5 * near, (near, far)


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("qtype,quantize_q", [
    (None, False), ("int8", False), ("fp8", False), ("mixed", False),
    ("int8", True), ("mixed", True)])
@pytest.mark.parametrize("d", [16, 64, 128, 200, 256])
def test_f16_decode_and_paged(dev, d, qtype, quantize_q, peaked):
    """K6 and K7 of the fp16-q unit over fp16 and one-byte caches, against
    the plain version; K7 bit for bit K6 on the same keys."""
    b, h, h_kv, max_n = 4, 8, 2, 700
    q, k, v = _decode_inputs(dev, torch.float16, b, h, h_kv, max_n, d, d,
                             peaked)
    lens = torch.tensor([700, 1, 333, 0], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(d)
    cache, (kq, vq, ks, vs) = _paged_copy(dev, k, v, lens.tolist(), 64, 11,
                                          qtype, gen)
    scales = {} if qtype is None else dict(k_scale=ks, v_scale=vs)
    got = decode_attention(q, kq, vq, lens, quantize_q=quantize_q, **scales)
    want = decode_attention_plain(q, kq, vq, lens, quantize_q=quantize_q,
                                  **scales)
    torch.cuda.synchronize()
    _assert_decode_close(got, want, torch.float16, quantize_q, peaked)
    if peaked:
        top = want[0].float().abs().max().item()
        assert _err(got[0], want[0]) <= REL_GATE * top
    paged = paged_decode_attention(q, cache.k_pages, cache.v_pages,
                                   cache.page_table, lens,
                                   k_scale=cache.k_scale,
                                   v_scale=cache.v_scale,
                                   quantize_q=quantize_q)
    torch.cuda.synchronize()
    assert torch.equal(paged[0], got[0]) and torch.equal(paged[1], got[1])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("tq,tc", [
    (torch.bfloat16, torch.float32), (torch.float16, torch.float32),
    (torch.float16, torch.bfloat16), (torch.bfloat16, torch.float16),
    (torch.float32, torch.float16)])
def test_mixed_decode_and_paged(dev, tq, tc, d):
    """A q over a float cache of another type: the fp32-q unit on q upcast,
    P rounded to q's type, O in q's; K7 bit for bit K6."""
    b, h, h_kv, max_n = 4, 8, 2, 700
    gen = torch.Generator(device=dev).manual_seed(d)
    q = _u(gen, dev, b, h, d, scale=8).to(tq)
    k = _u(gen, dev, b, h_kv, max_n, d, scale=4).to(tc)
    v = _u(gen, dev, b, h_kv, max_n, d).to(tc)
    lens = torch.tensor([700, 1, 333, 0], dtype=torch.int32, device=dev)
    o, lse = decode_attention(q, k, v, lens)
    o_p, lse_p = decode_attention_plain(q, k, v, lens)
    torch.cuda.synchronize()
    assert o.dtype == tq
    _assert_mixed(o, o_p, v, tq)
    assert _err(lse, lse_p) <= 1e-4 * max(1.0, lse_p.abs().max().item())
    cache, _ = _paged_copy(dev, k, v, lens.tolist(), 64, 11, None, gen)
    paged = paged_decode_attention(q, cache.k_pages, cache.v_pages,
                                   cache.page_table, lens)
    torch.cuda.synchronize()
    assert torch.equal(paged[0], o) and torch.equal(paged[1], lse)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("d,kw", [
    (128, dict(causal=True)), (64, dict(causal=True, kv_offset=-20)),
    (128, dict()), (256, dict(causal=True)), (200, dict(causal=True)),
    (16, dict(causal=True)), (128, dict(causal=True, window=100)),
    (128, "segments")])
def test_f16_backward(dev, d, kw, fused):
    """K4, K2 + K3 and the prologue of the fp16 unit: gradients in fp16
    within the bf16 gate of the plain backward (P rounded to dO's type,
    dS to q's and k's: fp16)."""
    gen = torch.Generator(device=dev).manual_seed(d + int(fused))
    b, h, h_kv, n = 2, 8, 4, 300
    q = _u(gen, dev, b, h, n, d, scale=2).half()
    k = _u(gen, dev, b, h_kv, n, d, scale=2).half()
    v, do = _u(gen, dev, b, h_kv, n, d).half(), _u(gen, dev, b, h, n,
                                                   d).half()
    if kw == "segments":
        ids = torch.arange(n, device=dev) // 70
        kw = dict(causal=True, q_segment_ids=torch.stack([ids, ids]),
                  kv_segment_ids=torch.stack([ids, ids]))
    o, lse = flash_attention_forward_plain(q, k, v, **kw)
    before = dict(flash_attention_backward.launches)
    got = flash_attention_backward(q, k, v, o, lse, do, fused=fused, **kw)
    torch.cuda.synchronize()
    after = flash_attention_backward.launches
    assert after["delta"] == before["delta"] + 1
    assert after["fused" if fused else "dq"] == before[
        "fused" if fused else "dq"] + 1
    want = flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert g.dtype == torch.float16
        _assert_rel(g, w, name)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("types", [
    (torch.bfloat16, torch.float32, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.float32, torch.bfloat16),
    (torch.float16, torch.bfloat16, torch.bfloat16, torch.float16),
    (torch.float16, torch.float16, torch.float16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16)])
def test_mixed_backward(dev, types, d, fused, no_tf32):
    """q / k / v / dO not all of one type: the fp32 builds on upcast
    operands, P rounded to dO's type, dS to q's (dK) and k's (dQ), the
    gradients in q's, k's, v's types, against the plain backward (1e-4 ·
    max(1, max |plain|) plus one ulp of the gradient's and the rounded
    operand's types)."""
    gen = torch.Generator(device=dev).manual_seed(d)
    tq, tk, tv, tdo = types
    b, h, h_kv, n = 1, 8, 4, 300
    q = _u(gen, dev, b, h, n, d, scale=2).to(tq)
    k = _u(gen, dev, b, h_kv, n, d, scale=2).to(tk)
    v, do = _u(gen, dev, b, h_kv, n, d).to(tv), _u(gen, dev, b, h, n,
                                                   d).to(tdo)
    o, lse = flash_attention_forward_plain(q.float(), k.float(), v.float(),
                                           causal=True)
    got = flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                   fused=fused)
    want = flash_attention_backward_plain(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    narrow = max(_ULP[t] for t in types)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t
        top = w.float().abs().max().item()
        assert top > 0
        gate = 1e-4 * max(1.0, top) + (_ULP[t] + 2 * narrow) * top
        assert _err(g, w) <= gate, (_err(g, w), gate)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_f16_and_mixed_fa1(dev, d, causal, no_tf32):
    """K8: fp16 through the fp16 unit (bf16 gate), mixed types through the
    fp32 build (P rounded to v's type, O in q's)."""
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (_u(gen, dev, 1, 4, 512, d, scale=2) for _ in range(3))
    h = [x.half() for x in (q, k, v)]
    o = fa1_attention(*h, causal=causal)
    assert o.dtype == torch.float16
    assert _err(o, fa1_attention_plain(*h, causal=causal)) <= GATE
    for types in ((torch.float32, torch.bfloat16, torch.bfloat16),
                  (torch.float16, torch.float32, torch.bfloat16)):
        m = [x.to(t) for x, t in zip((q, k, v), types)]
        o = fa1_attention(*m, causal=causal)
        want = fa1_attention_plain(*m, causal=causal)
        torch.cuda.synchronize()
        assert o.dtype == types[0]
        _assert_mixed(o, want, m[2], types[2])


@pytest.mark.parametrize("d", [64, 128, 200, 256])
@pytest.mark.parametrize("types", [(torch.float16, torch.float16),
                                   (torch.float32, torch.bfloat16),
                                   (torch.float16, torch.bfloat16)])
def test_f16_and_mixed_device_ring(dev, types, d, no_tf32):
    """K9: fp16 x and w through the fp16 unit (o fp32), x and w of two
    float types through the fp32 build, against the fp32 reference."""
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    gen = torch.Generator(device=dev).manual_seed(d)
    n, rows = 4, 256
    x = _u(gen, dev, n * rows, d).to(types[0])
    w = _u(gen, dev, d, d).to(types[1])
    mesh = _ring_mesh(dev, n)
    o = device_ring_matmul(x, w, mesh)
    torch.cuda.synchronize()
    ref = _ring_ref(x, w, n)
    top = ref.abs().max().item()
    assert o.dtype == torch.float32
    gate = (1e-3 if types == (torch.float16,) * 2 else 1e-4) * max(1.0, top)
    assert _err(o, ref) <= gate
    assert _err(o, ring_matmul_plain(x, w, mesh)) <= gate
