"""Parity of the torch port's flash forward with the JAX package's.

The same numpy inputs go through `cuda_flashattention_tpu`'s
`flash_attention_forward` (its Pallas kernels in interpret mode on the CPU)
and through `cuda_flashattention_torch`'s, which on CPU tensors runs its
plain PyTorch version. `softmax` is PINNED to the same strategy on both
sides (the bound and the online softmax round differently, so "auto" is
never held against a pinned strategy). Gates on O and LSE, port against
JAX: fp32 1e-4, bf16 5e-3 (fp8 keys under a bf16 Q included: there the
JAX side flushes the 14 e4m3 subnormals and the port does not). Against
the fp32 oracle on the unquantized K/V: int8 1e-3, fp8 1e-2, mixed 5e-3,
as the JAX package's own tests hold them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops import flash_fwd as jax_flash_fwd
from cuda_flashattention_tpu.ops.flash_fwd import (
    flash_attention_forward as jax_fwd,
)
from cuda_flashattention_tpu.ops.quant import quantize_kv as jax_quantize_kv
from cuda_flashattention_torch.ops import flash_fwd as torch_flash_fwd
from cuda_flashattention_torch.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_torch.ops.naive import naive_attention
from cuda_flashattention_torch.ops.quant import quantize_kv

GATES = {"float32": 1e-4, "bfloat16": 5e-3}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, b, h, h_kv, nq, nk, d):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, (b, h, nq, d)).astype(np.float32)
    k = rng.uniform(-1.0, 1.0, (b, h_kv, nk, d)).astype(np.float32)
    v = rng.uniform(-1.0, 1.0, (b, h_kv, nk, d)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype, qtype=None, softmax="online", **kw):
    """The JAX and the port's (O, LSE) on the same inputs. With `qtype`
    K and V are quantized from their fp32 values on each side (the two
    quantizers give the same codes; tests/test_torch_quant.py)."""
    q, k, v = arrays
    ja = [jnp.asarray(q, JAX_DT[dtype]), jnp.asarray(k, JAX_DT[dtype]),
          jnp.asarray(v, JAX_DT[dtype])]
    ta = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrays]
    jkw, tkw = {}, {}
    if qtype is not None:
        jkv = jax_quantize_kv(jnp.asarray(k), jnp.asarray(v), qtype)
        tkv = quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qtype)
        ja[1:], ta[1:] = [jkv.k_q, jkv.v_q], [tkv.k_q, tkv.v_q]
        jkw = dict(k_scale=jkv.k_scale, v_scale=jkv.v_scale)
        tkw = dict(k_scale=tkv.k_scale, v_scale=tkv.v_scale)
    for name, x in kw.items():
        if name == "out_dtype":
            jkw[name], tkw[name] = JAX_DT[x], TORCH_DT[x]
        elif name.endswith("segment_ids"):
            jkw[name], tkw[name] = jnp.asarray(x), torch.from_numpy(x)
        else:
            jkw[name] = tkw[name] = x
    jx = jax_fwd(*ja, softmax=softmax, **jkw)
    th = flash_attention_forward(*ta, softmax=softmax, **tkw)
    return jx, th


def _max_diff(jx, th):
    return float(np.max(np.abs(np.asarray(jx, np.float32)
                               - th.float().numpy())))


def _assert_parity(jx, th, gate):
    (o_j, lse_j), (o_t, lse_t) = jx, th
    assert tuple(o_t.shape) == o_j.shape and tuple(lse_t.shape) == lse_j.shape
    assert lse_t.dtype == torch.float32
    assert _max_diff(o_j, o_t) <= gate
    assert _max_diff(lse_j, lse_t) <= gate


# (b, h, h_kv, nq, nk, d, causal, kv_offset, dtype, out_dtype)
CASES = [
    (1, 4, 2, 64, 64, 32, True, 0, "float32", None),
    (1, 4, 2, 37, 53, 32, False, 0, "float32", None),
    (1, 4, 2, 37, 53, 32, True, 16, "float32", None),
    (1, 2, 2, 24, 24, 32, True, -8, "float32", None),  # empty first rows
    (2, 4, 4, 64, 64, 64, True, 0, "bfloat16", None),
    (1, 4, 2, 37, 53, 64, True, 16, "bfloat16", "float32"),
    (1, 4, 2, 48, 96, 32, False, 0, "bfloat16", "float32"),
]


@pytest.mark.parametrize(
    "b,h,h_kv,nq,nk,d,causal,kv_offset,dtype,out_dtype", CASES)
def test_forward_matches_jax(b, h, h_kv, nq, nk, d, causal, kv_offset,
                             dtype, out_dtype):
    arrays = _inputs(nq * 7 + nk, b, h, h_kv, nq, nk, d)
    kw = dict(causal=causal, kv_offset=kv_offset)
    if out_dtype is not None:
        kw["out_dtype"] = out_dtype
    jx, th = _both(arrays, dtype, **kw)
    assert th[0].dtype == TORCH_DT[out_dtype or dtype]
    assert tuple(th[0].shape) == (b, h, nq, d)
    assert tuple(th[1].shape) == (b, h, nq)
    _assert_parity(jx, th, GATES[dtype])


# (b, h, h_kv, nq, nk, d, window, kv_offset): GQA, ragged, a window
# shorter than the rows, rows before the shard, a prefix slice where only
# the window cuts, and a window that misses every key
WINDOW_CASES = [
    (1, 4, 2, 64, 64, 32, 16, 0),
    (1, 4, 2, 37, 53, 32, 8, 16),
    (2, 2, 1, 40, 100, 32, 16, 60),
    (1, 2, 2, 24, 40, 32, 8, -4),
    (1, 2, 2, 24, 20, 32, 8, 30),
]


@pytest.mark.parametrize("softmax", ["online", "bound", "bound_unchecked"])
@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,window,kv_offset", WINDOW_CASES)
def test_window_matches_jax(b, h, h_kv, nq, nk, d, window, kv_offset,
                            softmax):
    """Bound + causal is what the JAX function gives its K-major kernel."""
    arrays = _inputs(nq + nk + window, b, h, h_kv, nq, nk, d)
    jx, th = _both(arrays, "float32", softmax=softmax, causal=True,
                   window=window, kv_offset=kv_offset)
    _assert_parity(jx, th, GATES["float32"])


@pytest.mark.parametrize("softmax", ["online", "bound"])
def test_window_matches_jax_bf16(softmax):
    arrays = _inputs(5, 1, 4, 2, 37, 53, 64)
    jx, th = _both(arrays, "bfloat16", softmax=softmax, causal=True,
                   window=8, kv_offset=16, out_dtype="float32")
    _assert_parity(jx, th, GATES["bfloat16"])


@pytest.mark.parametrize("softmax", ["online", "bound"])
@pytest.mark.parametrize("kw,empty", [
    (dict(causal=True, kv_offset=-8), slice(0, 8)),
    (dict(causal=True, window=8, kv_offset=30), slice(0, 24)),
    (dict(causal=True, window=4, kv_offset=22), slice(1, 24)),
])
def test_fully_masked_rows(kw, empty, softmax):
    """Rows before the shard, or whose window lies past its 20 keys: O = 0,
    LSE = NEG_INF (finite), in both strategies; the bound form's
    loose-bound check leaves such rows alone."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 2, 24, 20, 32))
    o, lse = flash_attention_forward(q, k, v, softmax=softmax, **kw)
    assert torch.all(o[:, :, empty] == 0)
    assert torch.all(lse[:, :, empty] == -1e30)
    assert torch.isfinite(lse).all() and torch.isfinite(o).all()
    keep = torch.ones(24, dtype=torch.bool)
    keep[empty] = False
    assert torch.all(lse[:, :, keep] > -1e29)


def _segment_ids(b, n, lengths):
    """[B, n] ids of packed segments; each batch row rotates the
    lengths."""
    out = np.zeros((b, n), np.int32)
    for i in range(b):
        ls = lengths[i % len(lengths):] + lengths[:i % len(lengths)]
        out[i] = np.repeat(np.arange(len(ls)), ls)[:n]
    return out


@pytest.mark.parametrize("b,h,h_kv,nq,nk,d,kw,dtype", [
    (2, 4, 2, 64, 64, 32, dict(causal=True), "float32"),
    (2, 4, 2, 50, 50, 32, dict(causal=False), "float32"),
    (1, 2, 2, 37, 53, 32, dict(causal=True, kv_offset=16), "float32"),
    (1, 4, 1, 48, 48, 32, dict(causal=True, window=12), "float32"),
    (1, 4, 2, 64, 64, 64, dict(causal=True), "bfloat16"),
])
def test_segments_match_jax(b, h, h_kv, nq, nk, d, kw, dtype):
    """Packed sequences: "auto" is online on both sides under segment
    ids."""
    arrays = _inputs(nq + 3 * nk, b, h, h_kv, nq, nk, d)
    kseg = _segment_ids(b, nk, [20, 7, 30, 43])
    off = kw.get("kv_offset", 0)
    qseg = np.stack([kseg[i, off:off + nq] for i in range(b)])
    jx, th = _both(arrays, dtype, softmax="auto", q_segment_ids=qseg,
                   kv_segment_ids=kseg, **kw)
    _assert_parity(jx, th, GATES[dtype])


def test_segments_with_no_match_leave_empty_rows():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 1, 2, 2, 16, 16, 32))
    qseg = torch.tensor([[0] * 8 + [1] * 8])
    kseg = torch.zeros(1, 16, dtype=torch.long)
    o, lse = flash_attention_forward(q, k, v, q_segment_ids=qseg,
                                     kv_segment_ids=kseg)
    assert torch.all(o[:, :, 8:] == 0) and torch.all(lse[:, :, 8:] == -1e30)
    assert torch.all(lse[:, :, :8] > -1e29)


# masks of the quantized cases: the non-causal prefix read, a causal
# shard with an offset, and the windowed prefix slice
QUANT_MASKS = [
    dict(causal=False),
    dict(causal=True, kv_offset=60),
    dict(causal=True, window=16, kv_offset=60),
]


@pytest.mark.parametrize("softmax", ["online", "bound", "bound_unchecked"])
@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
@pytest.mark.parametrize("mask", QUANT_MASKS)
def test_quantized_matches_jax(qtype, mask, softmax):
    """fp32 Q over int8 / fp8 / mixed K/V, GQA, ragged. Under "bound" the
    JAX function runs its Q-major kernel for the non-causal masks and its
    K-major kernel for the causal ones."""
    arrays = _inputs(11, 1, 4, 2, 40, 100, 32)
    jx, th = _both(arrays, "float32", qtype=qtype, softmax=softmax, **mask)
    _assert_parity(jx, th, GATES["float32"])


@pytest.mark.parametrize("softmax", ["online", "bound"])
@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
@pytest.mark.parametrize("mask", QUANT_MASKS[::2])
def test_quantized_matches_jax_bf16(qtype, mask, softmax):
    """A bf16 Q: the form the kernels take. fp8 keys under it are the JAX
    function's K-major case even without a causal mask."""
    arrays = _inputs(12, 1, 4, 2, 40, 100, 64)
    jx, th = _both(arrays, "bfloat16", qtype=qtype, softmax=softmax,
                   out_dtype="float32", **mask)
    _assert_parity(jx, th, GATES["bfloat16"])


@pytest.mark.parametrize("qtype,dtype", [
    ("int8", "float32"), ("mixed", "float32"), ("int8", "bfloat16"),
    ("fp8", "bfloat16"),   # re-gridded onto int8
    ("fp8", "float32"),    # dropped: no re-grid without a bf16 Q
])
@pytest.mark.parametrize("mask", QUANT_MASKS)
def test_quantize_q_matches_jax(qtype, dtype, mask):
    """int8 Q · int8 K with per-query-head scale rows (GQA: 4 heads over
    2), pinned to "bound" on both sides."""
    arrays = _inputs(13, 1, 4, 2, 40, 100, 32)
    jx, th = _both(arrays, dtype, qtype=qtype, softmax="bound",
                   quantize_q=True, out_dtype="float32", **mask)
    _assert_parity(jx, th, GATES[dtype])


@pytest.mark.parametrize("qtype,tol", [("int8", 1e-3), ("fp8", 1e-2),
                                       ("mixed", 5e-3)])
@pytest.mark.parametrize("softmax", ["online", "bound"])
def test_quantized_accuracy_vs_oracle(qtype, tol, softmax):
    """Against the fp32 oracle on the UNquantized K/V, values in
    [-0.5, 0.5], seq 256, d 64."""
    rng = np.random.default_rng(42)
    q, k, v = (torch.from_numpy(
        rng.uniform(-0.5, 0.5, (1, 1, 256, 64)).astype(np.float32))
        for _ in range(3))
    kv = quantize_kv(k, v, qtype)
    o, _ = flash_attention_forward(q, kv.k_q, kv.v_q, k_scale=kv.k_scale,
                                   v_scale=kv.v_scale, softmax=softmax)
    o_ref, _ = naive_attention(q, k, v)
    assert torch.max(torch.abs(o - o_ref)).item() < tol


def _adversarial_qkv(slack_log2, n=128, d=32, jitter=0.0, seed=3):
    """Anti-aligned huge-norm Q/K whose score bound is loose by about
    `slack_log2` log2 units: q rides e0, k rides e1, so every score is
    about 0 while ‖q‖·‖k‖·scale·log2e is about slack_log2. `jitter`
    spreads the true scores over [-jitter, 0]."""
    rng = np.random.default_rng(seed)
    scale, log2e = 1.0 / np.sqrt(d), 1.4426950408889634
    a = np.sqrt(slack_log2 / (scale * log2e))
    q = np.zeros((1, 1, n, d), np.float32)
    k = np.zeros((1, 1, n, d), np.float32)
    q[..., 0] = a
    k[..., 1] = a
    if jitter:
        u = rng.uniform(0.0, 1.0, n)
        k[0, 0, :, 0] = -u * jitter / (a * scale * log2e)
    v = rng.uniform(-0.5, 0.5, (1, 1, n, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("slack,jitter,causal", [
    (160.0, 0.0, False),   # every weight underflows: l = 0
    (160.0, 0.0, True),    # the same on the K-major form
    (124.0, 3.0, False),   # l > 0 but under 2^-96: the widened trigger
])
def test_loose_bound_fallback_matches_jax(slack, jitter, causal):
    """A loose bound: "bound" must return the online result on both sides
    (the JAX side with its fallback switched on in interpret mode).
    "bound_unchecked" gives the degraded result: O = 0, LSE = NEG_INF at
    slack 160, past the smallest fp32 subnormal on either side; at slack
    124 the rows keep l > 0 (XLA flushes those subnormal weights on the
    CPU and PyTorch keeps them, so the two unchecked results are not
    held against each other there)."""
    arrays = _adversarial_qkv(slack, jitter=jitter)
    kw = dict(causal=causal)
    q, k, v = (jnp.asarray(a) for a in arrays)
    want = jax_fwd(q, k, v, softmax="bound", _fallback_in_interpret=True,
                   **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in arrays)
    got = flash_attention_forward(tq, tk, tv, softmax="bound", **kw)
    online = flash_attention_forward(tq, tk, tv, softmax="online", **kw)
    assert torch.equal(got[0], online[0]) and torch.equal(got[1], online[1])
    _assert_parity(want, got, GATES["float32"])
    jx, th = _both(arrays, "float32", softmax="bound_unchecked", **kw)
    if jitter == 0.0:
        assert torch.all(th[1] == -1e30) and torch.all(th[0] == 0)
        assert np.all(np.asarray(jx[1]) < -1e29)
        assert torch.max(torch.abs(online[0])).item() > 1e-2
    else:
        assert torch.all(th[1] > -1e29)


def test_moderate_slack_stays_on_the_bound_result():
    """Slack about 60 log2 units, under the 96 trigger: no fallback, and
    the bound result is accurate on its own."""
    q, k, v = (torch.from_numpy(a)
               for a in _adversarial_qkv(60.0, jitter=3.0, seed=11))
    checked = flash_attention_forward(q, k, v, softmax="bound")
    unchecked = flash_attention_forward(q, k, v, softmax="bound_unchecked")
    online = flash_attention_forward(q, k, v, softmax="online")
    assert torch.equal(checked[0], unchecked[0])
    assert torch.max(torch.abs(checked[0] - online[0])).item() < 1e-4


_META = dict(device="meta")


@pytest.mark.parametrize("softmax", ["auto", "online", "bound",
                                     "bound_unchecked"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("storage", [None, "int8", "fp8", "mixed"])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_routing_matches_reference(softmax, causal, storage, q_dtype):
    """The port's decision table against the JAX function's: its
    `_resolve_use_bound`, and its K-major rule `use_bound and (causal or
    fp8 keys under a bf16 Q)`, here without the on-chip state budget that
    rule also carries on the TPU. Rows 512, 5120 (online for a short
    unquantized causal call) and 5121; with and without segment ids."""
    k_dtype = {None: q_dtype, "int8": torch.int8, "fp8": torch.float8_e4m3fn,
               "mixed": torch.int8}[storage]
    for nq in (512, 5120, 5121):
        for segmented in (False, True):
            q = torch.empty(1, 2, nq, 64, dtype=q_dtype, **_META)
            k = torch.empty(1, 2, 64, 64, dtype=k_dtype, **_META)
            sc = (None if storage is None
                  else torch.empty(1, 2, 64, **_META))
            seg = (torch.empty(1, nq, **_META), torch.empty(1, 64, **_META))
            want = jax_flash_fwd._resolve_use_bound(
                softmax, causal=causal, quantized=storage is not None,
                segmented=segmented, nq=nq)
            args = (q, k, k, None, causal, 0, 0, None, sc, sc,
                    *(seg if segmented else (None, None)), softmax, False)
            if want and segmented:
                with pytest.raises(ValueError, match="segment"):
                    torch_flash_fwd._plan(*args)
                continue
            plan = torch_flash_fwd._plan(*args)
            fp8_fast = storage == "fp8" and q_dtype == torch.bfloat16
            assert plan.use_bound == want
            assert plan.use_kmajor == (want and (causal or fp8_fast))
            assert plan.checked == (want and softmax != "bound_unchecked")
    assert (torch_flash_fwd._ONLINE_SHORT_NQ
            == jax_flash_fwd._ONLINE_SHORT_NQ)
    assert (torch_flash_fwd._FALLBACK_SLACK_LOG2
            == jax_flash_fwd._FALLBACK_SLACK_LOG2)


def test_empty_rows_report_finite_neg_inf():
    """Rows that see no key give O = 0 and LSE = -1e30 (not -inf)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 2, 24, 24, 32))
    o, lse = flash_attention_forward(q, k, v, causal=True, kv_offset=-8)
    assert torch.all(o[:, :, :8] == 0)
    assert torch.all(lse[:, :, :8] == -1e30)
    assert torch.isfinite(lse).all()


def test_forward_matches_oracle_fp32():
    """The plain path agrees with the dense oracle (GQA by repetition)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 2, 4, 2, 40, 40, 32))
    o, lse = flash_attention_forward(q, k, v, causal=True)
    o_ref, lse_ref = naive_attention(q, k.repeat_interleave(2, 1),
                                     v.repeat_interleave(2, 1), causal=True)
    assert torch.max(torch.abs(o - o_ref)) <= 1e-5
    assert torch.max(torch.abs(lse - lse_ref)) <= 1e-5


@pytest.mark.parametrize("kw", [
    dict(block_sizes=object()),                                # TPU tiling
    dict(window=4),                                            # not causal
    dict(k_scale=torch.ones(1, 2, 8)),                         # no v_scale
    dict(q_segment_ids=torch.zeros(1, 8), kv_segment_ids=torch.zeros(1, 8),
         softmax="bound"),
    dict(quantize_q=True),                                     # bf16 K/V
    dict(softmax="nope"),
])
def test_unported_options_raise(kw):
    """Explicit block sizes are the one option not ported; the rest are
    the argument combinations the JAX function refuses too."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 2, 8, 8, 32))
    with pytest.raises(NotImplementedError if "block_sizes" in kw
                       else ValueError):
        flash_attention_forward(q, k, v, **kw)


def test_scale_shapes_and_storage_are_checked():
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 2, 8, 8, 32))
    kv = quantize_kv(k, v, "int8")
    with pytest.raises(ValueError, match="scale shape"):
        flash_attention_forward(q, kv.k_q, kv.v_q, k_scale=kv.k_scale[:, :1],
                                v_scale=kv.v_scale)
    with pytest.raises(ValueError, match="need k_scale"):
        flash_attention_forward(q, kv.k_q, kv.v_q)
    with pytest.raises(ValueError, match="quantized k must be"):
        flash_attention_forward(q, k, v, k_scale=kv.k_scale,
                                v_scale=kv.v_scale)
    with pytest.raises(ValueError, match="quantize_q requires the bound"):
        flash_attention_forward(q, kv.k_q, kv.v_q, k_scale=kv.k_scale,
                                v_scale=kv.v_scale, softmax="online",
                                quantize_q=True)


def test_no_plain_fallback_off_the_cpu():
    """Only CPU tensors take the plain version; other devices raise."""
    q = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_forward(q, q, q, causal=True)
