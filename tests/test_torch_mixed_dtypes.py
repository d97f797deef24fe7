"""Mixed float types in the torch port against the JAX package on the CPU:
the same seeded numpy inputs, in the same mix of bf16, fp16 and fp32, go
through the JAX function (Pallas in interpret mode) and its counterpart in
the port (the plain versions of the kernels; on the card the fp32 builds
run these forms on exactly upcast operands, tests/test_torch_kernels_cuda.py
`test_mixed_*`).

- The forward: a bf16 or fp16 Q over fp32 K/V, fp16 over bf16 K/V and the
  reverse, an fp32 Q over fp16 K/V, K and V of two types; online, bound
  and K-major.
- Decode and paged decode: a q over a float cache of another type.
- The backward with q / k / v / dO not all of one type, fused and split;
  FA1; the device ring's plain version on x and w of two types.
- The bf16 model over an fp32 cache and the fp16 model over a bf16 cache,
  through `prefill_chunked` + `decode_one`.

Gates. JAX computes a product of two float types on exactly upcast
operands with fp32 sums, and first rounds P (dS) to one type where its
kernel casts it; both packages do the same, in other orders, so their
fp32 sums differ in the last bits (~1e-6 relative here) and a P at a
rounding boundary of the narrow type may round the other way (one ulp of
that type, 2^-7 bf16 or 2^-10 fp16 relative, of one weight's share of O),
as may O itself, written in the output's type. So O is held to 1e-4 ·
max(1, max |O|) plus one ulp of P's type and one of O's at max |O|; LSE
(fp32) to 1e-4 · max(1, |LSE|), plus, for a bf16 Q, 2^-9 · max(1, |LSE|):
JAX rounds the prescale factor scale · log2(e) to bf16 (a weakly typed
scalar), the port keeps it unrounded for a bf16 Q (`ops/flash_fwd.py::
_prescale_q`), which moves the scores by up to 2^-9 relative; gradients to 1e-4 of their largest value
plus two ulps of the narrowest operand type and one of their own; the
models' logits to 2^-5 · max(1, max |logit|): their activations are
2-byte, and an attention output that differs in its last bits flips the
rounding of an activation (one bf16 ulp, 2^-7 relative) in each of the two
layers and their residual sums (the values seen: 0.031 at max |logit|
2.64 for the bf16 model, 0.0098 for the fp16 one); greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_tpu.ops import kv_cache as jkv
from cuda_flashattention_tpu.ops import paged as jpaged
from cuda_flashattention_tpu.ops.decode import decode_attention as jax_decode
from cuda_flashattention_tpu.ops.fa1 import fa1_attention as jax_fa1
from cuda_flashattention_tpu.ops.flash_bwd import (
    flash_attention_backward as jax_bwd,
)
from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_fwd,
)
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import params_from_jax
from cuda_flashattention_torch.ops import flash_fwd as ff
from cuda_flashattention_torch.ops import kv_cache as tkv
from cuda_flashattention_torch.ops import paged as tpaged
from cuda_flashattention_torch.ops.decode import decode_attention
from cuda_flashattention_torch.ops.fa1 import fa1_attention
from cuda_flashattention_torch.ops.flash_bwd import flash_attention_backward

F32, BF16, F16 = "float32", "bfloat16", "float16"
ULP = {F32: 0.0, BF16: 2.0 ** -7, F16: 2.0 ** -10}


def _u(rng, *shape, peak=1.0):
    return (rng.uniform(-1, 1, shape) * peak).astype(np.float32)


def _j(x, dt):
    return jnp.asarray(x, getattr(jnp, dt))


def _t(x, dt):
    return torch.from_numpy(x).to(getattr(torch, dt))


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _diff(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _top(a):
    return max(1.0, float(np.max(np.abs(np.asarray(a, np.float32)))))


def _o_gate(o_j, p_type, o_type):
    return (1e-4 + ULP[p_type] + ULP[o_type]) * _top(o_j)


def _lse_gate(lse_j, q_type):
    return (1e-4 + (2.0 ** -9 if q_type == BF16 else 0.0)) * _top(lse_j)


# (q, k, v) types; forms run for each
FWD_TYPES = [(BF16, F32, F32), (F16, F32, F32), (F16, BF16, BF16),
             (BF16, F16, F16), (F32, F16, F16), (BF16, BF16, F32)]
FWD_FORMS = [("online", "online", dict(causal=True, kv_offset=30)),
             ("bound", "bound", {}),
             ("kmajor", "bound", dict(causal=True, window=24, kv_offset=30))]


@pytest.fixture(scope="module")
def fwd_jax():
    out = {}
    for i, types in enumerate(FWD_TYPES):
        rng = np.random.default_rng(i)
        x = (_u(rng, 1, 4, 40, 64, peak=2.0), _u(rng, 1, 2, 70, 64),
             _u(rng, 1, 2, 70, 64))
        for form, softmax, kw in FWD_FORMS:
            out[types, form] = (x, jax_fwd(
                *(_j(a, t) for a, t in zip(x, types)), softmax=softmax,
                **kw))
    return out


@pytest.mark.parametrize("form", [f[0] for f in FWD_FORMS])
@pytest.mark.parametrize("types", FWD_TYPES, ids="-".join)
def test_forward_mixed_matches_jax(fwd_jax, types, form):
    _, softmax, kw = next(f for f in FWD_FORMS if f[0] == form)
    x, (o_j, lse_j) = fwd_jax[types, form]
    args = [_t(a, t) for a, t in zip(x, types)]
    plan = ff._plan(*args, None, kw.get("causal", False), kw.get("window", 0),
                    kw.get("kv_offset", 0), None, None, None, None, None,
                    softmax, False)
    assert plan.use_kmajor == (form == "kmajor")
    o, lse = ff.flash_attention_forward(*args, softmax=softmax, **kw)
    assert str(o.dtype) == f"torch.{types[0]}" and o_j.dtype == types[0]
    assert _diff(o, o_j) <= _o_gate(o_j, types[0], types[0])
    assert _diff(lse, lse_j) <= _lse_gate(lse_j, types[0])


@pytest.mark.parametrize("types", [(BF16, F32), (F16, F32), (F16, BF16),
                                   (BF16, F16), (F32, F16)], ids="-".join)
def test_decode_mixed_matches_jax(types):
    tq, tc = types
    rng = np.random.default_rng(3)
    q = _u(rng, 2, 8, 64, peak=4.0)
    k, v = _u(rng, 2, 2, 50, 64, peak=2.0), _u(rng, 2, 2, 50, 64)
    lengths = np.array([50, 17], np.int32)
    o_j, lse_j = jax_decode(_j(q, tq), _j(k, tc), _j(v, tc),
                            jnp.asarray(lengths), window=20)
    o, lse = decode_attention(_t(q, tq), _t(k, tc), _t(v, tc),
                              torch.from_numpy(lengths), window=20)
    assert str(o.dtype) == f"torch.{tq}" and o_j.dtype == tq
    assert _diff(o, o_j) <= _o_gate(o_j, tq, tq)
    assert _diff(lse, lse_j) <= 1e-4 * _top(lse_j)


def test_paged_decode_mixed_matches_jax():
    """An fp16 q over bf16 pools."""
    rng = np.random.default_rng(4)
    b, h, hkv, page, n_pages, d = 2, 8, 2, 8, 12, 32
    q = _u(rng, b, h, d, peak=4.0)
    kp, vp = _u(rng, n_pages, hkv, page, d), _u(rng, n_pages, hkv, page, d)
    table = np.array([[1, 3, 5, 7, 9], [0, 2, 4, 6, 8]], np.int32)
    lengths = np.array([37, 21], np.int32)
    o_j, lse_j = jpaged.paged_decode_attention(
        _j(q, F16), _j(kp, BF16), _j(vp, BF16), jnp.asarray(table),
        jnp.asarray(lengths))
    o, lse = tpaged.paged_decode_attention(
        _t(q, F16), _t(kp, BF16), _t(vp, BF16), torch.from_numpy(table),
        torch.from_numpy(lengths))
    assert o.dtype == torch.float16
    assert _diff(o, o_j) <= _o_gate(o_j, F16, F16)
    assert _diff(lse, lse_j) <= 1e-4 * _top(lse_j)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("types", [(BF16, F32, F32, F32),
                                   (F32, F32, F32, BF16),
                                   (F16, BF16, BF16, F16)], ids="-".join)
def test_backward_mixed_matches_jax(types, fused):
    """dQ, dK, dV in q's, k's and v's types, P rounded to dO's type, dS to
    q's (dK) and k's (dQ), on the JAX forward's O and LSE."""
    rng = np.random.default_rng(5)
    q, do = _u(rng, 1, 4, 40, 64, peak=2.0), _u(rng, 1, 4, 40, 64)
    k, v = _u(rng, 1, 2, 40, 64, peak=2.0), _u(rng, 1, 2, 40, 64)
    ja = [_j(a, t) for a, t in zip((q, k, v, do), types)]
    ta = [_t(a, t) for a, t in zip((q, k, v, do), types)]
    o_j, lse_j = jax_fwd(*ja[:3], causal=True, out_dtype=jnp.float32)
    want = jax_bwd(*ja[:3], o_j, lse_j, ja[3], causal=True, fused=fused)
    o = torch.from_numpy(np.array(o_j, np.float32))
    lse = torch.from_numpy(np.array(lse_j, np.float32))
    got = flash_attention_backward(*ta[:3], o, lse, ta[3], causal=True,
                                   fused=fused)
    narrow = max(ULP[t] for t in types)
    for g, w, t, name in zip(got, want, types, ("dQ", "dK", "dV")):
        assert str(g.dtype) == f"torch.{t}" and w.dtype == t, name
        gate = (1e-4 + 2 * narrow + ULP[t]) * _top(w)
        assert _diff(g, w) <= gate, name


def test_fa1_mixed_matches_jax():
    """An fp32 Q over bf16 K and fp16 V: P rounded to v's type, O fp32."""
    rng = np.random.default_rng(6)
    q, k, v = (_u(rng, 1, 2, 96, 64, peak=p) for p in (2.0, 2.0, 1.0))
    types = (F32, BF16, F16)
    o_j = jax_fa1(*(_j(a, t) for a, t in zip((q, k, v), types)),
                  causal=True, block_q=64, block_k=64)
    o = fa1_attention(*(_t(a, t) for a, t in zip((q, k, v), types)),
                      causal=True, block_q=64, block_k=64)
    assert o.dtype == torch.float32
    assert _diff(o, o_j) <= _o_gate(o_j, F16, F32)


def test_device_ring_plain_mixed_matches_the_jax_example():
    """fp32 x over bf16 W through the ring's plain version against the JAX
    example's ring (products on exactly upcast operands)."""
    import importlib.util
    import sys
    from pathlib import Path
    from cuda_flashattention_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from cuda_flashattention_torch.parallel.device_ring import (
        ring_matmul_plain)
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    root = Path(__file__).resolve().parents[1] / "examples"
    sys.path.insert(0, str(root))
    try:
        spec = importlib.util.spec_from_file_location(
            "example_07_device_ring_mixed", root / "07_device_ring.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
    finally:
        sys.path.remove(str(root))
    rng = np.random.default_rng(7)
    n, rows, d = 2, 64, 64
    x, w = _u(rng, n * rows, d), _u(rng, d, d)
    want = example.xla_ring_matmul(
        _j(x, F32), _j(w, BF16), jax_make_mesh((n,), ("sp",),
                                               jax.devices()[:n]))
    got = ring_matmul_plain(_t(x, F32), _t(w, BF16),
                            make_mesh((n,), ("sp",), ["cpu"] * n))
    assert got.dtype == torch.float32
    assert _diff(got, want) <= 1e-4 * _top(want)


# ---- models over caches of another type ----------------------------------

_SIZES = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
              n_kv_heads=1, d_head=64, d_ff=128, max_seq=64)
PROMPT, CHUNK, STEPS, MAX_LEN = 7, 3, 3, 16


@pytest.mark.parametrize("model_type,cache_type", [(BF16, F32), (F16, BF16)],
                         ids=["bf16-over-fp32", "fp16-over-bf16"])
def test_model_over_a_cache_of_another_type_serves_like_jax(model_type,
                                                             cache_type):
    jcfg = jtf.TransformerConfig(**_SIZES, dtype=getattr(jnp, model_type))
    tcfg = ttf.TransformerConfig(**_SIZES, dtype=getattr(torch, model_type))
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            tcfg)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jc = tuple(jkv.init_cache(2, jcfg.n_kv_heads, MAX_LEN, jcfg.d_head,
                              dtype=getattr(jnp, cache_type))
               for _ in range(jcfg.n_layers))
    tc = tuple(tkv.init_cache(2, tcfg.n_kv_heads, MAX_LEN, tcfg.d_head,
                              dtype=getattr(torch, cache_type),
                              device="cpu")
               for _ in range(tcfg.n_layers))
    lj, jc = jtf.prefill_chunked(jparams, jnp.asarray(prompt), jcfg, jc,
                                 chunk=CHUNK)
    lt, tc = ttf.prefill_chunked(model, torch.from_numpy(prompt), tc,
                                 chunk=CHUNK)
    assert all(str(c.k.dtype) == f"torch.{cache_type}" for c in tc)
    pairs = [(lj, lt)]
    tok_j, tok_t = jnp.argmax(lj, -1), torch.argmax(lt, -1)
    for i in range(STEPS):
        assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
        lj, jc = jtf.decode_one(jparams, tok_j.astype(jnp.int32),
                                PROMPT + i, jcfg, jc)
        lt, tc = ttf.decode_one(model, tok_t.to(torch.int32), PROMPT + i,
                                tc)
        tok_j, tok_t = jnp.argmax(lj, -1), torch.argmax(lt, -1)
        pairs.append((lj, lt))
    for a, b in pairs:
        assert _diff(b.float(), a) <= 2.0 ** -5 * _top(a)
