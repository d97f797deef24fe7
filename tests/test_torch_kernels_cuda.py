"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and skip without one. The file
imports no JAX, so on a machine without it they run with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Gate: 5e-3 on O and LSE (bf16 inputs)."""

import pytest
import torch

from cuda_flashattention_torch.ops.decode import (
    decode_attention,
    decode_attention_plain,
)
from cuda_flashattention_torch.ops.flash_fwd import (
    flash_attention_forward,
    flash_attention_forward_plain,
)

GATE = 5e-3
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


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 2, 8, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d in"):
        flash_attention_forward(q, q, q)
    q32 = torch.zeros(1, 2, 8, 64, device=dev)
    with pytest.raises(NotImplementedError, match="bf16"):
        flash_attention_forward(q32, q32, q32)
