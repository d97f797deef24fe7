"""fp16 in the torch port against the JAX package on the CPU: the same
seeded numpy inputs go through the JAX function (Pallas in interpret mode)
and its counterpart in the port (the plain versions of the kernels, which
the card's fp16 builds are held to in tests/test_torch_kernels_cuda.py).

- The forward on fp16 Q/K/V: online (K1), bound (K1b) and K-major (K5)
  under causal, window and segment masks, over int8, fp8 and mixed K/V,
  `quantize_q` over int8 keys (P·V in bf16, O fp16) and over fp8 keys
  (dropped for a non-bf16 Q, as in JAX).
- Decode and paged decode of an fp16 q over fp16, int8 and fp8 caches.
- The backward, fused and split; FA1; the device ring's plain version.
- An fp16 model through `prefill_chunked` + `decode_one` over fp16, int8
  and fp8 caches, and through `loss_fn` and its gradients.

Gates, argued from fp16's unit roundoff u = 2^-11: both packages round P
(and dS) to fp16 at the same points and accumulate in fp32, in other
orders, so their fp32 values differ in the last bits and a P (or O
itself, written in fp16) may land on the other side of an fp16 rounding
boundary: one fp16 ulp (2u relative) of O, or of one weight's share of
it. O and the decode's O are held to 4u · max(1, max |O|) (~2e-3), LSE
(fp32 from fp16 inputs) to 1e-4 · max(1, |LSE|). Under `quantize_q` P is
bf16 (u = 2^-8) on both sides: 4 · 2^-8. Gradients (fp16, each the sum of
hundreds of rounded products) to 16u of their largest value; the model's
logits (two layers of fp16 activations) to 16u · max(1, max |logit|)
(~8e-3; the values seen are 1.5e-3 relative), its loss to 1e-3 and its
weight gradients (the model's parameters are fp32, its activations fp16)
to 5e-2 · max |grad|.
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
from cuda_flashattention_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from cuda_flashattention_torch.ops import flash_fwd as ff
from cuda_flashattention_torch.ops import kv_cache as tkv
from cuda_flashattention_torch.ops import paged as tpaged
from cuda_flashattention_torch.ops.decode import decode_attention
from cuda_flashattention_torch.ops.fa1 import fa1_attention
from cuda_flashattention_torch.ops.flash_bwd import flash_attention_backward
from cuda_flashattention_torch.ops.quant import quantize_kv

U = 2.0 ** -11
O_GATE = 4 * U
QQ_GATE = 4 * 2.0 ** -8
LSE_GATE = 1e-4
GRAD_GATE = 16 * U
LOGIT_GATE = 16 * U


def _u(rng, *shape, peak=1.0):
    """fp16 values as fp32 numpy (both packages then hold the same fp16
    values)."""
    x = (rng.uniform(-1, 1, shape) * peak).astype(np.float32)
    return x.astype(np.float16).astype(np.float32)


def _diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _top(a):
    return max(1.0, float(np.max(np.abs(np.asarray(a, np.float32)))))


def _j(x):
    return jnp.asarray(x, jnp.float16)


def _t(x):
    return torch.from_numpy(x).half()


def _codes(k, v, qtype):
    """K/V quantized once (the port's `quantize_kv`), as (JAX arrays,
    torch tensors, JAX scale kwargs, torch scale kwargs): both packages
    read the same codes and scales (their quantizers may round a code at a
    tie differently)."""
    tq = quantize_kv(_t(k), _t(v), qtype)

    def to_jax(x):
        if x.dtype == torch.float8_e4m3fn:
            return jnp.asarray(x.view(torch.uint8).numpy()).view(
                jnp.float8_e4m3fn)
        return jnp.asarray(x.numpy())
    return ([to_jax(tq.k_q), to_jax(tq.v_q)], [tq.k_q, tq.v_q],
            dict(k_scale=to_jax(tq.k_scale), v_scale=to_jax(tq.v_scale)),
            dict(k_scale=tq.k_scale, v_scale=tq.v_scale))


# (name, (B, H, Hkv, Nq, Nk, d), mask, softmax, qtype, quantize_q)
FWD_CASES = [
    ("online causal", (1, 4, 2, 40, 70, 64),
     dict(causal=True, kv_offset=30), "online", None, False),
    ("bound", (1, 4, 2, 40, 70, 64), {}, "bound", None, False),
    ("kmajor window", (1, 4, 1, 40, 70, 64),
     dict(causal=True, window=24, kv_offset=30), "bound", None, False),
    ("online segments", (1, 4, 2, 48, 48, 64), "segments", "online", None,
     False),
    ("int8 online", (1, 4, 2, 40, 70, 64), dict(causal=True, kv_offset=30),
     "online", "int8", False),
    ("fp8 kmajor", (1, 4, 2, 40, 70, 64), dict(causal=True, kv_offset=30),
     "bound", "fp8", False),
    ("mixed bound", (1, 4, 2, 40, 70, 64), {}, "bound", "mixed", False),
    ("int8 quantize_q", (1, 4, 2, 40, 70, 64),
     dict(causal=True, kv_offset=30), "bound", "int8", True),
    ("fp8 quantize_q dropped", (1, 4, 2, 40, 70, 64), {}, "bound", "fp8",
     True),
]


def _fwd_call(case, seed):
    """(jax args, torch args, kwargs of both) of a forward case."""
    name, (b, h, hkv, nq, nk, d), kw, softmax, qtype, qq = case
    rng = np.random.default_rng(seed)
    q = _u(rng, b, h, nq, d, peak=4.0)
    k, v = _u(rng, b, hkv, nk, d, peak=2.0), _u(rng, b, hkv, nk, d)
    if kw == "segments":
        ids = (np.arange(nq) // 20).astype(np.int32)[None]
        jkw = dict(q_segment_ids=jnp.asarray(ids),
                   kv_segment_ids=jnp.asarray(ids))
        tkw = dict(q_segment_ids=torch.from_numpy(ids),
                   kv_segment_ids=torch.from_numpy(ids))
    else:
        jkw, tkw = dict(kw), dict(kw)
    ja, ta = [_j(q), _j(k), _j(v)], [_t(q), _t(k), _t(v)]
    if qtype is not None:
        ja[1:], ta[1:], js, ts = _codes(k, v, qtype)
        jkw.update(js)
        tkw.update(ts)
    for x in (jkw, tkw):
        x.update(softmax=softmax, quantize_q=qq)
    return ja, ta, jkw, tkw


@pytest.fixture(scope="module")
def fwd_jax():
    """The JAX forward of each case (one compile each)."""
    out = {}
    for i, case in enumerate(FWD_CASES):
        ja, ta, jkw, tkw = _fwd_call(case, i)
        out[case[0]] = (ta, tkw, jax_fwd(*ja, **jkw))
    return out


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_forward_fp16_matches_jax(fwd_jax, case):
    ta, tkw, (o_j, lse_j) = fwd_jax[case[0]]
    plan = ff._plan(*ta, None, tkw.get("causal", False), tkw.get("window", 0),
                    tkw.get("kv_offset", 0), None, tkw.get("k_scale"),
                    tkw.get("v_scale"), tkw.get("q_segment_ids"),
                    tkw.get("kv_segment_ids"), tkw["softmax"],
                    tkw["quantize_q"])
    # quantize_q holds over int8 keys and is dropped over fp8 ones
    assert plan.qq == (case[5] and case[4] == "int8")
    o, lse = ff.flash_attention_forward(*ta, **tkw)
    assert o.dtype == torch.float16 and o_j.dtype == jnp.float16
    gate = QQ_GATE if plan.qq else O_GATE
    assert _diff(o, o_j) <= gate * _top(o_j)
    assert _diff(lse, lse_j) <= LSE_GATE * _top(lse_j)


@pytest.mark.parametrize("qtype,qq", [(None, False), ("int8", False),
                                      ("fp8", False), ("int8", True)])
def test_decode_fp16_matches_jax(qtype, qq):
    rng = np.random.default_rng(3)
    q = _u(rng, 2, 8, 64, peak=4.0)
    k, v = _u(rng, 2, 2, 50, 64, peak=2.0), _u(rng, 2, 2, 50, 64)
    lengths = np.array([50, 17], np.int32)
    ja, ta, jkw, tkw = [_j(q), _j(k), _j(v)], [_t(q), _t(k), _t(v)], {}, {}
    if qtype is not None:
        ja[1:], ta[1:], jkw, tkw = _codes(k, v, qtype)
    o_j, lse_j = jax_decode(*ja, jnp.asarray(lengths), window=20,
                            quantize_q=qq, **jkw)
    o, lse = decode_attention(*ta, torch.from_numpy(lengths), window=20,
                              quantize_q=qq, **tkw)
    assert o.dtype == torch.float16 and o_j.dtype == jnp.float16
    assert _diff(o, o_j) <= (QQ_GATE if qq else O_GATE) * _top(o_j)
    assert _diff(lse, lse_j) <= LSE_GATE * _top(lse_j)


def test_paged_decode_fp16_pools_match_jax():
    rng = np.random.default_rng(4)
    b, h, hkv, page, n_pages, d = 2, 8, 2, 8, 12, 32
    q = _u(rng, b, h, d, peak=4.0)
    kp, vp = _u(rng, n_pages, hkv, page, d), _u(rng, n_pages, hkv, page, d)
    table = np.array([[1, 3, 5, 7, 9], [0, 2, 4, 6, 8]], np.int32)
    lengths = np.array([37, 21], np.int32)
    o_j, lse_j = jpaged.paged_decode_attention(
        _j(q), _j(kp), _j(vp), jnp.asarray(table), jnp.asarray(lengths))
    o, lse = tpaged.paged_decode_attention(
        _t(q), _t(kp), _t(vp), torch.from_numpy(table),
        torch.from_numpy(lengths))
    assert o.dtype == torch.float16
    assert _diff(o, o_j) <= O_GATE * _top(o_j)
    assert _diff(lse, lse_j) <= LSE_GATE * _top(lse_j)


@pytest.mark.parametrize("fused", [True, False])
def test_backward_fp16_matches_jax(fused):
    """dQ, dK, dV in fp16 (P rounded to dO's type, dS to q's and k's), on
    the forward's own O and LSE, causal with GQA."""
    rng = np.random.default_rng(5)
    q, do = _u(rng, 1, 4, 40, 64, peak=2.0), _u(rng, 1, 4, 40, 64)
    k, v = _u(rng, 1, 2, 40, 64, peak=2.0), _u(rng, 1, 2, 40, 64)
    kw = dict(causal=True)
    o_j, lse_j = jax_fwd(_j(q), _j(k), _j(v), **kw)
    want = jax_bwd(_j(q), _j(k), _j(v), o_j, lse_j, _j(do), fused=fused,
                   **kw)
    o = torch.from_numpy(np.asarray(o_j, np.float32)).half()
    lse = torch.from_numpy(np.asarray(lse_j, np.float32))
    got = flash_attention_backward(_t(q), _t(k), _t(v), o, lse, _t(do),
                                   fused=fused, **kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        assert g.dtype == torch.float16 and w.dtype == jnp.float16, name
        assert _diff(g, w) <= GRAD_GATE * _top(w), name


def test_fa1_fp16_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v = (_u(rng, 1, 2, 96, 64, peak=p) for p in (4.0, 2.0, 1.0))
    o_j = jax_fa1(_j(q), _j(k), _j(v), causal=True, block_q=64, block_k=64)
    o = fa1_attention(_t(q), _t(k), _t(v), causal=True, block_q=64,
                      block_k=64)
    assert o.dtype == torch.float16
    assert _diff(o, o_j) <= O_GATE * _top(o_j)


def _example_07():
    """examples/07_device_ring.py as a module, untouched."""
    import importlib.util
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / "examples"
    sys.path.insert(0, str(root))
    try:
        spec = importlib.util.spec_from_file_location(
            "example_07_device_ring_fp16", root / "07_device_ring.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(root))
    return mod


def test_device_ring_plain_fp16_matches_the_jax_example():
    """fp16 x and w through the ring's plain version against the JAX
    example's ring: o in fp32 on both sides."""
    from cuda_flashattention_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from cuda_flashattention_torch.parallel.device_ring import (
        ring_matmul_plain)
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(7)
    n, rows, d = 2, 64, 64
    x, w = _u(rng, n * rows, d), _u(rng, d, d)
    want = _example_07().xla_ring_matmul(
        _j(x), _j(w), jax_make_mesh((n,), ("sp",), jax.devices()[:n]))
    got = ring_matmul_plain(_t(x), _t(w),
                            make_mesh((n,), ("sp",), ["cpu"] * n))
    assert got.dtype == torch.float32
    assert _diff(got, want) <= 1e-4 * _top(want)


# ---- an fp16 model ---------------------------------------------------------

_SIZES = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
              n_kv_heads=1, d_head=64, d_ff=128, max_seq=64)
JCFG = jtf.TransformerConfig(**_SIZES, dtype=jnp.float16)
TCFG = ttf.TransformerConfig(**_SIZES, dtype=torch.float16)
PROMPT, CHUNK, STEPS, MAX_LEN = 7, 3, 3, 16


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(jax.random.PRNGKey(0), JCFG)


def _model(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           TCFG)


@pytest.mark.parametrize("qtype", [None, "int8", "fp8"])
def test_fp16_model_serves_like_jax(jparams, qtype):
    """`prefill_chunked` (chunk 3 over a 7-token prompt) then `decode_one`
    over fp16, int8 and fp8 caches: logits within the gate, greedy tokens
    equal."""
    model = _model(jparams)
    prompt = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, (2, PROMPT)).astype(np.int32)
    jc = tuple(jkv.init_cache(2, JCFG.n_kv_heads, MAX_LEN, JCFG.d_head,
                              qtype=qtype, dtype=jnp.float16)
               for _ in range(JCFG.n_layers))
    tc = tuple(tkv.init_cache(2, TCFG.n_kv_heads, MAX_LEN, TCFG.d_head,
                              qtype=qtype, dtype=torch.float16, device="cpu")
               for _ in range(TCFG.n_layers))
    lj, jc = jtf.prefill_chunked(jparams, jnp.asarray(prompt), JCFG, jc,
                                 chunk=CHUNK)
    lt, tc = ttf.prefill_chunked(model, torch.from_numpy(prompt), tc,
                                 chunk=CHUNK)
    pairs = [(lj, lt)]
    tok_j, tok_t = jnp.argmax(lj, -1), torch.argmax(lt, -1)
    for i in range(STEPS):
        assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
        lj, jc = jtf.decode_one(jparams, tok_j.astype(jnp.int32),
                                PROMPT + i, JCFG, jc)
        lt, tc = ttf.decode_one(model, tok_t.to(torch.int32), PROMPT + i,
                                tc)
        tok_j, tok_t = jnp.argmax(lj, -1), torch.argmax(lt, -1)
        pairs.append((lj, lt))
    for a, b in pairs:
        assert _diff(b.float(), a) <= LOGIT_GATE * _top(a)


def test_fp16_model_trains_like_jax(jparams):
    """`loss_fn` and its gradients against `jax.value_and_grad`."""
    tokens = np.random.default_rng(2).integers(
        0, JCFG.vocab_size, (2, 24)).astype(np.int32)
    loss_j, grads_j = jax.value_and_grad(jtf.loss_fn)(
        jparams, jnp.asarray(tokens), JCFG)
    m = _model(jparams)
    loss_t = ttf.loss_fn(m, torch.from_numpy(tokens))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-3
    got = jax.tree_util.tree_leaves_with_path(params_to_jax(m, grads=True))
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, grads_j))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        scale = float(np.max(np.abs(np.asarray(w, np.float32))))
        assert _diff(g, w) <= 5e-2 * max(scale, 1e-6), jax.tree_util.keystr(
            path)
