"""Tiles in the torch port: `ops.common.BlockSizes`, `auto_block_sizes`
and the table of the tiles each CUDA kernel is built for, the mapping of
an unbuilt tile to the nearest built one below it (as on the card; the
JAX kernels take any tile, which sets only their speed) and of a decode
split size past the capacity to the capacity (the JAX clamp), and the ops
with explicit tiles against the JAX functions at JAX tiles (bf16 forward
5e-3, backward 1e-3 · max |JAX| on the fused, window-0 path, where the JAX
kernel computes D in-kernel, `fuse_delta`; decode 5e-3), and the ring
forms with explicit tiles against the port's own one-device functions (a
JAX ring compile costs 30-60 s). On the CPU the plain versions ignore a
mapped tile: every tile computes the same function."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops import common as jcommon
from cuda_flashattention_tpu.ops.decode import (
    decode_attention as jax_decode,
)
from cuda_flashattention_tpu.ops.flash_bwd import (
    flash_attention_backward as jax_bwd,
)
from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_fwd,
)
from cuda_flashattention_torch.ops import common
from cuda_flashattention_torch.ops import decode as tdec
from cuda_flashattention_torch.ops import flash_fwd as ff
from cuda_flashattention_torch.ops.attention import flash_attention
from cuda_flashattention_torch.ops.common import (
    BUILT_TILES,
    BlockSizes,
    auto_block_sizes,
)
from cuda_flashattention_torch.ops.flash_bwd import flash_attention_backward
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_torch.ops.kv_cache import (
    append,
    decode_step,
    init_cache,
)
from cuda_flashattention_torch.parallel import ring as tring
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.utils.testing import max_abs, seeded_random

FWD_GATE, BWD_GATE, DEC_GATE = 5e-3, 1e-3, 5e-3


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# ---- the dataclass, the rule and the table --------------------------------

def test_block_sizes_keep_the_jax_fields_and_the_card_defaults():
    names = [f.name for f in dataclasses.fields(BlockSizes)]
    assert names == [f.name for f in dataclasses.fields(jcommon.BlockSizes)]
    assert BlockSizes() == BlockSizes(block_q=128, block_k=64,
                                      block_q_bwd=64, block_k_bwd=128)


@pytest.mark.parametrize("bs", [BlockSizes(), BlockSizes(block_k=128),
                                BlockSizes(block_k=192),
                                BlockSizes(block_q=512, block_k=96)])
@pytest.mark.parametrize("nq,nk", [(1, 1), (7, 33), (64, 100), (4096, 4096)])
def test_clamp_and_with_bwd_like_change_no_legality(bs, nq, nk):
    """A built tile runs any size masked, so `clamp` leaves every tile as
    it is (an unbuilt one stays unbuilt, a built one built) and
    `with_bwd_like` keeps the backward's one built pair."""
    assert bs.clamp(nq, nk) == bs
    assert (bs.with_bwd_like(nq, nk).block_q_bwd,
            bs.with_bwd_like(nq, nk).block_k_bwd) == (64, 128)


def test_table_lists_the_builds():
    for d in (64, 128):
        for kn in ("K1", "K1b"):
            assert BUILT_TILES[kn, "bf16", d] == ((128,), (64, 128))
            for ty in ("fp32", "codes", "fp32/codes", "fp32/bf16"):
                assert BUILT_TILES[kn, ty, d] == ((128,), (64,))
        for kn in ("K2", "K4"):
            for ty in ("bf16", "fp32"):
                assert BUILT_TILES[kn, ty, d] == ((64,), (128,))
    assert BUILT_TILES["K5", "bf16", 128][1] == (64, 128, 192, 256)
    assert BUILT_TILES["K5", "fp32", 128][1] == (64,)
    assert BUILT_TILES["K5", "fp32/codes", 128][1] == (64, 128, 192)
    assert BUILT_TILES["K5", "fp32/bf16", 128][1] == (64, 128, 192)
    assert BUILT_TILES["K5", "codes", 64][1] == tuple(64 * s
                                                      for s in range(1, 9))
    # narrow heads run on the d = 64 builds
    assert common.built_tiles("K1", "bf16", 16) == BUILT_TILES["K1", "bf16",
                                                               64]


@pytest.mark.parametrize("b,h_kv,nk,d", [(1, 16, 4096, 128),
                                         (8, 4, 3584, 128), (1, 1, 512, 64)])
def test_auto_block_sizes_is_the_default_rule(b, h_kv, nk, d):
    """Today's tiles where "auto" routes to K1 or K1b, and K5's span rule
    (`_kmajor_span`) where it routes to K5: fp8 keys, or causal past
    5120 rows."""
    assert auto_block_sizes(4096, nk, d, causal=True) == BlockSizes()
    assert auto_block_sizes(512, nk, d) == BlockSizes()
    for nq, causal, fp8 in ((8192, True, False), (512, False, True)):
        bs = auto_block_sizes(nq, nk, d, causal=causal, fp8=fp8, batch=b,
                              kv_heads=h_kv)
        span = ff._kmajor_span(b, h_kv, nk, d, 132, False, fp8)
        assert bs == BlockSizes(block_k=64 * span)
        assert bs.block_k in BUILT_TILES["K5", "bf16", d][1]


# ---- unbuilt tiles on CPU tensors -----------------------------------------

def _qkv(b=1, h=4, h_kv=2, nq=40, nk=70, d=64, dtype=torch.bfloat16,
         seed=0):
    return (_t(seeded_random((b, h, nq, d), seed), dtype),
            _t(seeded_random((b, h_kv, nk, d), seed + 1), dtype),
            _t(seeded_random((b, h_kv, nk, d), seed + 2), dtype))


@pytest.mark.parametrize("bs,dtype,kw", [
    (BlockSizes(block_q=256), torch.bfloat16, dict(causal=True)),
    (BlockSizes(block_k=256), torch.bfloat16, dict(causal=True)),
    (BlockSizes(block_k=96), torch.bfloat16, dict(softmax="bound")),
    (BlockSizes(block_k=128), torch.float32, dict(causal=True)),
    (BlockSizes(block_k=128), torch.float32, dict(softmax="bound")),
    (BlockSizes(block_k=576), torch.bfloat16,
     dict(causal=True, softmax="bound")),
])
def test_forward_refuses_unbuilt_tiles_on_the_cpu(bs, dtype, kw, capsys):
    """Tiles the forward was refusing: each now runs at the nearest built
    tile below it (the JAX function takes them all), gives the default
    tiles' result, and its mapping is logged once (the package's logger
    writes to stderr)."""
    q, k, v = _qkv(dtype=dtype)
    common._LOGGED_MAPPINGS.clear()
    capsys.readouterr()
    got = flash_attention_forward(q, k, v, block_sizes=bs, **kw)
    flash_attention_forward(q, k, v, block_sizes=bs, **kw)
    err = capsys.readouterr().err
    want = flash_attention_forward(q, k, v, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert err.count("runs as") == 1 and "is built for" in err


def test_one_byte_kv_refuse_the_128_key_tile():
    """K1 over codes has no 128-key build: 128 keys run at 64 (K5 over
    codes takes 128 keys as a span of 2)."""
    from cuda_flashattention_torch.ops.quant import quantize_kv
    q, k, v = _qkv()
    kv = quantize_kv(k, v, "int8")
    assert common.check_tiles("K1", "codes", 64, BlockSizes(block_k=128),
                              "test") == 64
    flash_attention_forward(q, kv.k_q, kv.v_q, k_scale=kv.k_scale,
                            v_scale=kv.v_scale, softmax="online",
                            block_sizes=BlockSizes(block_k=128))
    # K5 over codes: 128 keys are a span of 2
    flash_attention_forward(q, kv.k_q, kv.v_q, k_scale=kv.k_scale,
                            v_scale=kv.v_scale, causal=True,
                            softmax="bound",
                            block_sizes=BlockSizes(block_k=128))


@pytest.mark.parametrize("bs", [BlockSizes(block_q_bwd=128),
                                BlockSizes(block_k_bwd=64),
                                BlockSizes(block_q_bwd=1024,
                                           block_k_bwd=2048)])
@pytest.mark.parametrize("fused", [True, False])
def test_backward_refuses_unbuilt_pairs_on_the_cpu(bs, fused):
    """Pairs the backward was refusing: its one build, (64, 128), runs
    every pair, with the default pair's gradients."""
    q, k, v = _qkv()
    o, lse = flash_attention_forward(q, k, v, causal=True)
    assert common.check_tiles("K2" if not fused else "K4", "bf16", 64, bs,
                              "test", bwd=True) == 128
    got = flash_attention_backward(q, k, v, o, lse, o, causal=True,
                                   block_sizes=bs, fused=fused)
    want = flash_attention_backward(q, k, v, o, lse, o, causal=True,
                                    fused=fused)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("block_k", [0, -4, 71, 10**6, 2.5])
def test_decode_refuses_split_sizes_past_the_capacity(block_k):
    """A split size past the capacity (71, 10**6 over 70 keys) is clamped
    to it, one split, as the JAX function clamps its block; what the JAX
    function fails on too (0, -4, 2.5) stays a ValueError."""
    q = _t(seeded_random((2, 4, 32), 1))
    k = _t(seeded_random((2, 2, 70, 32), 2))
    lengths = torch.tensor([70, 3])
    if isinstance(block_k, float) or block_k < 1:
        with pytest.raises(ValueError, match="split size"):
            tdec.decode_attention(q, k, k, lengths, block_k=block_k)
        return
    assert tdec.check_block_k(block_k, 70, "test") == 70
    got = tdec.decode_attention(q, k, k, lengths, block_k=block_k)
    want = tdec.decode_attention(q, k, k, lengths)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ring_attention_refuses_an_unbuilt_tile():
    """A tile the ring's steps were refusing runs at the nearest built
    one, with the default tiles' result."""
    mesh = make_mesh((2,), ("sp",), ["cpu"] * 2)
    q, k, v = _qkv(nq=64, nk=64)
    got = tring.ring_attention(q, k, v, mesh, causal=True,
                               block_sizes=BlockSizes(block_k=512))
    want = tring.ring_attention(q, k, v, mesh, causal=True)
    assert torch.equal(got, want)


def test_default_decode_block_k_is_the_split_rule():
    """The JAX name and arguments; the card's `split_size` rule, and the
    capacity (one split) where that rule leaves the context unsplit."""
    args = (torch.bfloat16, torch.bfloat16, torch.bfloat16, False, 0,
            False)
    assert tdec.default_decode_block_k(*args, 4352, batch=8, kv_heads=4,
                                       rows=4) == tdec.SPLIT_KEYS
    assert tdec.default_decode_block_k(*args, 4352, batch=8, kv_heads=4,
                                       rows=4, d=64) == 2 * tdec.SPLIT_KEYS
    assert tdec.default_decode_block_k(*args, 4352, batch=64, kv_heads=16,
                                       rows=1) == 4352
    assert tdec.default_decode_block_k(*args, 100) == 100


@pytest.mark.parametrize("split", [None, 16, 100, 1024])
def test_split_scratch_is_sized_from_the_split_used(split):
    used, part, tickets = tdec.split_scratch(8, 4, 4, 128, 1024, "cpu",
                                             split)
    assert used == (tdec.split_size(8, 4, 1, 128) if split is None
                    else split)
    n = -(-1024 // used)
    if n == 1:
        assert part is None and tickets is None
    else:
        assert part.numel() == 8 * 4 * 1 * n * 4 * (128 + 2)
        assert tickets.numel() == 8 * 4


# ---- parity with explicit tiles ------------------------------------------

@pytest.fixture(scope="module")
def fwd_case():
    """One JAX compile: the bf16 causal forward and its fused backward
    (fuse_delta: window 0) at a JAX tile, GQA, ragged."""
    b, h, h_kv, n, d = 1, 4, 2, 200, 64
    q = seeded_random((b, h, n, d), 3)
    k = seeded_random((b, h_kv, n, d), 4)
    v = seeded_random((b, h_kv, n, d), 5)
    do = seeded_random((b, h, n, d), 6)
    jbs = jcommon.BlockSizes(128, 128, 128, 128)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    o, lse = jax_fwd(jq, jk, jv, causal=True, block_sizes=jbs)
    grads = jax_bwd(jq, jk, jv, o, lse, jdo, causal=True, block_sizes=jbs,
                    fused=True)
    return dict(inputs=(q, k, v, do), o=o, lse=lse, grads=grads)


@pytest.mark.parametrize("block_k", [64, 128])
def test_forward_with_explicit_tiles_matches_jax(fwd_case, block_k):
    q, k, v, _ = fwd_case["inputs"]
    o, lse = flash_attention_forward(
        _t(q), _t(k), _t(v), causal=True,
        block_sizes=BlockSizes(block_k=block_k))
    assert _diff(o.float(), fwd_case["o"]) <= FWD_GATE
    assert _diff(lse, fwd_case["lse"]) <= FWD_GATE


@pytest.mark.parametrize("bs", [BlockSizes(), BlockSizes(block_k=128)])
def test_fused_backward_with_explicit_tiles_matches_jax_fuse_delta(fwd_case,
                                                                   bs):
    """The fused, window-0 backward, whose D the JAX kernel computes in
    its body and the port's prologue (here its plain version), at 1e-3 ·
    max |JAX| per gradient, from the JAX forward's O and LSE."""
    q, k, v, do = fwd_case["inputs"]
    o = _t(np.asarray(fwd_case["o"], np.float32))
    lse = torch.from_numpy(np.array(fwd_case["lse"], np.float32))
    got = flash_attention_backward(_t(q), _t(k), _t(v), o, lse, _t(do),
                                   causal=True, block_sizes=bs, fused=True)
    for g, w in zip(got, fwd_case["grads"]):
        assert _diff(g.float(), w) <= BWD_GATE * max_abs(w)


# JAX's own tiles: the BlockSizes() defaults and a (512, 512) of its
# auto_block_sizes, which the port's builds do not have
JAX_TILES = {"defaults": (2048, 2048, 1024, 2048),
             "512x512": (512, 512, 1024, 2048)}


@pytest.fixture(scope="module", params=sorted(JAX_TILES))
def jax_tiles_case(request, fwd_case):
    """The JAX forward and fused backward at JAX's tiles, on fwd_case's
    inputs."""
    tiles = JAX_TILES[request.param]
    q, k, v, do = fwd_case["inputs"]
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    jbs = jcommon.BlockSizes(*tiles)
    o, lse = jax_fwd(jq, jk, jv, causal=True, block_sizes=jbs)
    grads = jax_bwd(jq, jk, jv, o, lse, jdo, causal=True, block_sizes=jbs,
                    fused=True)
    return dict(tiles=tiles, o=o, lse=lse, grads=grads)


def test_forward_and_backward_at_jax_tiles_match_jax(fwd_case,
                                                     jax_tiles_case):
    """The forward and the fused backward under the JAX package's own
    tiles, which no build of the port has: they run at the nearest built
    ones and give the JAX function's result (forward 5e-3, each gradient
    1e-3 · max |JAX|)."""
    q, k, v, do = fwd_case["inputs"]
    bs = BlockSizes(*jax_tiles_case["tiles"])
    o, lse = flash_attention_forward(_t(q), _t(k), _t(v), causal=True,
                                     block_sizes=bs)
    assert _diff(o.float(), jax_tiles_case["o"]) <= FWD_GATE
    assert _diff(lse, jax_tiles_case["lse"]) <= FWD_GATE
    o_j = _t(np.asarray(jax_tiles_case["o"], np.float32))
    lse_j = torch.from_numpy(np.array(jax_tiles_case["lse"], np.float32))
    got = flash_attention_backward(_t(q), _t(k), _t(v), o_j, lse_j, _t(do),
                                   causal=True, block_sizes=bs, fused=True)
    for g, w in zip(got, jax_tiles_case["grads"]):
        assert _diff(g.float(), w) <= BWD_GATE * max_abs(w)


def test_flash_attention_passes_tiles_to_both_directions():
    q, k, v = (x.requires_grad_() for x in _qkv(nq=70, nk=70))
    bs = BlockSizes(block_k=128)
    o = flash_attention(q, k, v, causal=True, block_sizes=bs)
    o.float().square().sum().backward()
    grads = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    o2 = flash_attention(q, k, v, causal=True)
    o2.float().square().sum().backward()
    assert torch.equal(o, o2)
    for g, x in zip(grads, (q, k, v)):
        assert torch.equal(g, x.grad)
    # an unbuilt backward pair runs at the one built pair
    for x in (q, k, v):
        x.grad = None
    o3 = flash_attention(q, k, v, causal=True,
                         block_sizes=BlockSizes(block_q_bwd=128))
    o3.float().square().sum().backward()
    for g, x in zip(grads, (q, k, v)):
        assert torch.equal(g, x.grad)


@pytest.fixture(scope="module")
def decode_case():
    b, h, h_kv, max_n, d = 2, 8, 2, 300, 64
    rng = np.random.default_rng(7)
    q = rng.uniform(-1, 1, (b, h, d)).astype(np.float32)
    k = rng.uniform(-1, 1, (b, h_kv, max_n, d)).astype(np.float32)
    v = rng.uniform(-1, 1, (b, h_kv, max_n, d)).astype(np.float32)
    lengths = np.array([300, 77], np.int32)
    o, lse = jax_decode(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                        jnp.asarray(lengths), block_k=256)
    return dict(inputs=(q, k, v, lengths), o=o, lse=lse)


@pytest.mark.parametrize("block_k", [1, 16, 128, 300])
def test_decode_with_explicit_split_matches_jax(decode_case, block_k):
    q, k, v, lengths = decode_case["inputs"]
    o, lse = tdec.decode_attention(_t(q), _t(k), _t(v),
                                   torch.from_numpy(lengths),
                                   block_k=block_k)
    assert _diff(o.float(), decode_case["o"]) <= DEC_GATE
    assert _diff(lse, decode_case["lse"]) <= DEC_GATE


@pytest.mark.parametrize("block_k", [301, 10**6])
def test_decode_split_past_the_capacity_matches_jax(decode_case, block_k):
    """A split size past the 300-key cache: JAX clamps its block to the
    cache, the port its split size to the capacity; both give the same
    result (5e-3, bf16)."""
    q, k, v, lengths = decode_case["inputs"]
    o_j, lse_j = jax_decode(*(jnp.asarray(a, jnp.bfloat16) for a in
                              (q, k, v)), jnp.asarray(lengths),
                            block_k=block_k)
    o, lse = tdec.decode_attention(_t(q), _t(k), _t(v),
                                   torch.from_numpy(lengths),
                                   block_k=block_k)
    assert _diff(o.float(), o_j) <= DEC_GATE
    assert _diff(lse, lse_j) <= DEC_GATE


def test_decode_step_passes_block_k():
    cache = init_cache(2, 2, 64, 32, device="cpu")
    k = _t(seeded_random((2, 2, 40, 32), 8))
    append(cache, k, k)
    q = _t(seeded_random((2, 4, 32), 9))
    want = decode_step(q, cache)
    got = decode_step(q, cache, block_k=16)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    # past the capacity: clamped to it, one split
    got = decode_step(q, cache, block_k=65)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


@pytest.mark.parametrize("bs", [BlockSizes(), BlockSizes(block_k=128)])
def test_ring_attention_with_explicit_tiles_matches_one_device(bs):
    """Forward and gradients of the ring over 4 ranks of a "cpu" mesh with
    explicit tiles against the port's one-device `flash_attention`: bf16
    O within 5e-3, gradients within 2e-2 · max |one device|."""
    mesh = make_mesh((4,), ("sp",), ["cpu"] * 4)
    q, k, v = (x.requires_grad_() for x in _qkv(nq=128, nk=128, seed=11))
    o = tring.ring_attention(q, k, v, mesh, causal=True, block_sizes=bs)
    o.float().square().sum().backward()
    g_ring = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    o1 = flash_attention(q, k, v, causal=True)
    o1.float().square().sum().backward()
    assert _diff(o.detach().float(), o1.detach().float()) <= FWD_GATE
    for g, x in zip(g_ring, (q, k, v)):
        assert _diff(g.float(), x.grad.float()) <= 2e-2 * max_abs(
            x.grad.float())


@pytest.mark.parametrize("block_k", [8, 64])
def test_ring_decode_with_explicit_split_matches_one_device(block_k):
    mesh = make_mesh((4,), ("sp",), ["cpu"] * 4)
    rng = np.random.default_rng(12)
    q = _t(rng.uniform(-1, 1, (2, 4, 32)))
    k = _t(rng.uniform(-1, 1, (2, 2, 256, 32)))
    v = _t(rng.uniform(-1, 1, (2, 2, 256, 32)))
    lengths = torch.tensor([256, 130], dtype=torch.int32)
    o, lse = tring.ring_decode(q, k, v, lengths, mesh, block_k=block_k)
    o1, lse1 = tdec.decode_attention(q, k, v, lengths)
    assert _diff(o.float(), o1.float()) <= DEC_GATE
    assert _diff(lse, lse1) <= DEC_GATE


def test_table_lists_the_d256_builds():
    """d = 256: K1 and K1b over bf16 or one-byte K/V at 64 keys, K5 at a
    span of one tile, under a bf16 or an fp32 Q (an fp32 Q over fp32 K/V
    at 32 keys); K2 and K4 over bf16 at (64, 64) (64-key CTAs) and over
    fp32 at (32, 64) (64-key CTAs streaming 32-row Q tiles). A width
    between builds looks up the next build up, and one past every build of
    its family has none."""
    for ty in ("bf16", "codes", "fp32/codes", "fp32/bf16"):
        for kn in ("K1", "K1b", "K5"):
            assert BUILT_TILES[kn, ty, 256] == ((128,), (64,))
            assert common.built_tiles(kn, ty, 200) == ((128,), (64,))
    for kn in ("K1", "K1b", "K5"):
        assert BUILT_TILES[kn, "fp32", 256] == ((128,), (32,))
        assert common.built_tiles(kn, "fp32", 200) == ((128,), (32,))
        assert common.built_tiles(kn, "fp32", 257) is None
    for kn in ("K2", "K4"):
        assert BUILT_TILES[kn, "bf16", 256] == ((64,), (64,))
        assert common.built_tiles(kn, "bf16", 200) == ((64,), (64,))
        assert BUILT_TILES[kn, "fp32", 256] == ((32,), (64,))
        assert common.built_tiles(kn, "fp32", 200) == ((32,), (64,))
        assert common.built_tiles(kn, "bf16", 257) is None
        assert common.built_tiles(kn, "fp32", 257) is None
    assert common.built_tiles("K1", "bf16", 96) == BUILT_TILES["K1", "bf16",
                                                               128]
    assert common.built_tiles("K1b", "codes", 130) == BUILT_TILES[
        "K1b", "codes", 256]
    assert common.built_tiles("K1", "bf16", 300) is None


def test_d256_tiles_map_to_the_built_one(capsys):
    """block_k = 128 (a 128-key build at d <= 128) runs at 64 keys at d =
    256, logged once; K5's 192 too, and the backward's default (64, 128)
    at K4's (64, 64); an fp32 Q over fp32 K/V at d = 256 runs 32-key
    tiles, so 64 and 128 map to 32 there; the fp32 backward at d = 256
    runs (32, 64), so the default (64, 128) maps to it."""
    assert common.check_tiles("K1", "bf16", 256, BlockSizes(block_k=128),
                       "test256") == 64
    assert common.check_tiles("K5", "codes", 256, BlockSizes(block_k=192),
                       "test256") == 64
    err = capsys.readouterr().err
    assert "at d=256" in err and "(128, 128) runs as (128, 64)" in err
    assert common.check_tiles("K1", "fp32", 256, BlockSizes(block_k=128),
                       "test256") == 32
    assert common.check_tiles("K5", "fp32", 256, BlockSizes(), "test256") == 32
    assert common.check_tiles("K1b", "fp32/bf16", 256,
                              BlockSizes(block_k=128), "test256") == 64
    assert "(128, 128) runs as (128, 32)" in capsys.readouterr().err
    assert common.check_tiles("K4", "bf16", 256, BlockSizes(), "test256",
                       bwd=True) == 64
    assert "(64, 128) runs as (64, 64)" in capsys.readouterr().err
    assert common.check_tiles("K4", "fp32", 256, BlockSizes(), "test256",
                       bwd=True) == 64
    assert "(64, 128) runs as (32, 64)" in capsys.readouterr().err
    assert common.check_tiles("K2", "fp32", 200, BlockSizes(block_q_bwd=32,
                                                            block_k_bwd=64),
                              "test256", bwd=True) == 64
    assert "test256" not in capsys.readouterr().err


@pytest.mark.parametrize("d", [96, 256])
def test_forward_at_wide_heads_takes_any_tile_on_the_cpu(d):
    """On the CPU the plain version ignores the tile at every width: a
    block_k the d = 256 builds lack gives the default's result."""
    q, k, v = _qkv(d=d)
    want = flash_attention_forward(q, k, v, causal=True)
    got = flash_attention_forward(q, k, v, causal=True,
                                  block_sizes=BlockSizes(block_k=128))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
