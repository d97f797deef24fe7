"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and skip without one. The file
imports no JAX, so on a machine without it they run with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Gates (bf16 inputs): 5e-3 on the forward's and the decode's O and LSE;
for the backward, per gradient, max |diff| <= 2e-2 · max |plain| (an
absolute gate near the gradients' own size would pass all-zero dK)."""

import pytest
import torch

from cuda_flashattention_torch.ops.attention import flash_attention
from cuda_flashattention_torch.ops.decode import (
    decode_attention,
    decode_attention_plain,
)
from cuda_flashattention_torch.ops.flash_bwd import (
    flash_attention_backward,
    flash_attention_backward_plain,
)
from cuda_flashattention_torch.ops.flash_fwd import (
    flash_attention_forward,
    flash_attention_forward_plain,
)

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
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(NotImplementedError, match="bf16"):
        flash_attention_backward(q32, q32, q32, q32, lse, q32)
    with pytest.raises(ValueError, match="d in"):
        flash_attention_backward(q, q, q, q, lse, q)
