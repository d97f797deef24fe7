"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and skip without one. The file
imports no JAX, so on a machine without it they run with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Gates (bf16 inputs): 5e-3 on O and LSE of the forward (every softmax
form, mask, storage type and `quantize_q`; on peaked inputs O is also held
to 2e-2 of the plain version's largest |O|), the decode (every storage
type, window and `quantize_q` form), the paged decode and FA1;
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
    plan = ff._plan(q, k, v, None, kw.get("causal", False),
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
    with pytest.raises(NotImplementedError, match="block_sizes"):
        flash_attention_forward(q, q, q, block_sizes=object())


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


def test_device_ring_refuses_what_it_does_not_take(dev):
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    gen = torch.Generator(device=dev).manual_seed(0)
    x, w = _rand(gen, dev, 4 * 64, 128), _rand(gen, dev, 128, 128)
    mesh = _ring_mesh(dev, 4)
    with pytest.raises(NotImplementedError, match="bf16"):
        device_ring_matmul(x.float(), w.float(), mesh)
    with pytest.raises(ValueError, match="multiple of 64"):
        device_ring_matmul(x[:4 * 40], w, mesh)
    with pytest.raises(ValueError, match="d in"):
        device_ring_matmul(x[:, :32].contiguous(),
                           w[:32, :32].contiguous(), mesh)
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
    unguarded launch's bits when it is 1."""
    import ctypes
    from cuda_flashattention_torch import _build
    from cuda_flashattention_torch.ops import flash_fwd as ff
    (q, k, v), _ = _fwd_inputs(dev, 1, 8, 2, 150, 220, d, None, 4)
    want = flash_attention_forward(q, k, v, causal=True, softmax="online",
                                   out_dtype=torch.float32)
    q_hat = ff._prescale_q(q, ff.resolve_scale(None, d))
    strides = (ctypes.c_longlong * 9)(*q_hat.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    for flag in (0, 1):
        guard = torch.tensor([flag], dtype=torch.int32, device=dev)
        o = torch.full_like(want[0], 7.0)
        lse = torch.full_like(want[1], 7.0)
        err = _build.library().cfa_flash_fwd(
            ff._ptrs(q_hat, k, v, None, None, None, None, guard, o, lse),
            1, 8, 2, 150, 220, d, strides, 0, 0, 1, 0, 0, 1,
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
