"""Which CUDA build an fp32 call reaches, on the CPU: the host functions
that launch the kernels (`ops/flash_fwd._fwd_cuda`, `ops/flash_bwd.
_bwd_cuda`, `ops/fa1._fa1_cuda`, `parallel/device_ring._launch`) run with
the kernels' library replaced by a recorder of the C calls, so that what
they hand each entry point (the storage codes, the q type, quantize_q's
int8 Q, the split path's pair of kernels, the f32 flags) is checked where
no card is. The kernels themselves are held to their plain versions on
the card (tests/test_torch_kernels_cuda.py)."""

import contextlib
import types

import numpy as np
import pytest
import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops import fa1 as tfa1
from cuda_flashattention_torch.ops import flash_bwd as fb
from cuda_flashattention_torch.ops import flash_fwd as ff
from cuda_flashattention_torch.ops.quant import quantize_kv
from cuda_flashattention_torch.parallel import device_ring as dr

CODES = {torch.int8: 1, torch.float8_e4m3fn: 2, torch.float32: 3}
# the argument after the strides in the forward entry points: k_type,
# v_type, q_f32, then (bound forms) qq
FWD_STRIDES_AT = 7


class _Lib:
    """The kernels' library as the host code sees it: every entry point
    records its arguments and returns 0 (no CUDA error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("cfa_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry

    def names(self):
        return [n for n, _ in self.calls]


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *_: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *_: types.SimpleNamespace(
                            multi_processor_count=132))
    return fake


def _qkv(qtype, b=2, h=8, h_kv=2, nq=40, nk=300, d=128, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
    q, k, v = mk(b, h, nq, d), mk(b, h_kv, nk, d), mk(b, h_kv, nk, d)
    if qtype is None:
        return q, k, v, {}
    kv = quantize_kv(k, v, qtype)
    return q, kv.k_q, kv.v_q, dict(k_scale=kv.k_scale, v_scale=kv.v_scale)


def _forward(q, k, v, kw, softmax, quantize_q=False, causal=False,
             window=0):
    plan = ff._plan(q, k, v, None, causal, window, 0, None,
                    kw.get("k_scale"), kw.get("v_scale"), None, None,
                    softmax, quantize_q)
    return plan, ff._fwd_cuda(q, k, v, plan, torch.float32,
                              kw.get("k_scale"), kw.get("v_scale"), None,
                              None)


def _types(args):
    """(k_type, v_type, q_f32) of a forward entry point's arguments."""
    return args[FWD_STRIDES_AT + 1:FWD_STRIDES_AT + 4]


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
@pytest.mark.parametrize("softmax,entry", [
    ("online", "cfa_flash_fwd"), ("bound_unchecked", "cfa_flash_fwd_bound")])
def test_fp32_q_over_codes_reaches_the_fp32_build(lib, qtype, softmax,
                                                  entry):
    """An fp32 Q over int8, fp8 or mixed K/V launches the fp32-Q build of
    the pinned form with K's and V's storage codes and q_f32 = 1: it no
    longer raises."""
    q, k, v, kw = _qkv(qtype)
    _forward(q, k, v, kw, softmax)
    assert lib.names() == [entry]
    k_type, v_type, q_f32 = _types(lib.calls[0][1])
    assert (k_type, v_type, q_f32) == (CODES[k.dtype], CODES[v.dtype], 1)
    if entry == "cfa_flash_fwd_bound":
        assert lib.calls[0][1][FWD_STRIDES_AT + 4] == 0  # qq


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_fp32_q_over_codes_routes_as_fp32_under_auto(lib, qtype):
    """"auto" routes as for any fp32 Q: the bound form on the Q-major walk
    (an fp32 Q is not fp8's fast path), K5 under causal, and behind each
    bound launch the guarded online one of the same build."""
    q, k, v, kw = _qkv(qtype)
    _forward(q, k, v, kw, "auto")
    assert lib.names() == ["cfa_flash_fwd_bound", "cfa_flash_fwd"]
    assert all(_types(a)[2] == 1 for _, a in lib.calls)
    lib.calls.clear()
    plan, _ = _forward(q, k, v, kw, "auto", causal=True, window=64)
    assert plan.use_kmajor
    assert lib.names() == ["cfa_flash_fwd_kmajor", "cfa_flash_fwd"]
    span = lib.calls[0][1][-2]
    assert 1 <= span <= ff._KMAJOR_MAX_SPAN_F32Q[128]


@pytest.mark.parametrize("b,h_kv,nk,d", [
    (8, 4, 3584, 128), (8, 4, 1024, 128), (1, 4, 4096, 128), (1, 1, 64, 64),
    (2, 2, 257, 64)])
def test_kmajor_span_of_the_fp32_q_build(b, h_kv, nk, d):
    """An fp32 Q over codes keeps exact bf16 K/V tiles beside its split Q
    ring: a longer span than the fp32 K/V build, and always its longest
    (its producer splits each Q tile once per span), where the other
    builds keep two waves."""
    assert ff._KMAJOR_MAX_SPAN_F32[d] < ff._KMAJOR_MAX_SPAN_F32Q[d]
    span = ff._kmajor_span(b, h_kv, nk, d, 132, True, True)
    assert span == ff._KMAJOR_MAX_SPAN_F32Q[d]
    assert ff._kmajor_span(8, 4, 3584, 128, 132, True, False) == 1
    assert ff._kmajor_span(8, 4, 3584, 128, 132) == ff._KMAJOR_MAX_SPAN[128]


@pytest.mark.parametrize("qtype", ["int8", "mixed"])
def test_quantize_q_on_an_fp32_q_over_int8_keys_runs_the_int8_build(
        lib, monkeypatch, qtype):
    """quantize_q stays on over int8 keys: the host quantizes the fp32 Q
    to int8 and the bound launch reads that int8 Q (q_f32 = 0, qq = 1),
    with no guarded online launch behind it."""
    q, k, v, kw = _qkv(qtype)
    made = []
    real = ff._quantize_q
    monkeypatch.setattr(ff, "_quantize_q",
                        lambda *a: made.append(real(*a)) or made[-1])
    plan, _ = _forward(q, k, v, kw, "auto", quantize_q=True)
    assert plan.qq and not plan.regrid and not plan.checked
    assert lib.names() == ["cfa_flash_fwd_bound"]
    args = lib.calls[0][1]
    assert _types(args)[2] == 0 and args[FWD_STRIDES_AT + 4] == 1
    assert len(made) == 1 and made[0][0].dtype == torch.int8
    assert args[0][0] == made[0][0].data_ptr()


def test_quantize_q_on_an_fp32_q_over_fp8_keys_is_dropped(lib, monkeypatch):
    """Over fp8 keys quantize_q needs a bf16 Q (the JAX function's
    `q.dtype != bfloat16` drop): an fp32 Q runs the fp32-Q build, checked,
    and no int8 Q is made."""
    q, k, v, kw = _qkv("fp8")
    monkeypatch.setattr(ff, "_quantize_q", lambda *a: pytest.fail("made"))
    plan, _ = _forward(q, k, v, kw, "auto", quantize_q=True)
    assert not plan.qq and plan.checked
    assert lib.names() == ["cfa_flash_fwd_bound", "cfa_flash_fwd"]
    assert _types(lib.calls[0][1]) == (2, 2, 1)
    assert lib.calls[0][1][FWD_STRIDES_AT + 4] == 0


def test_fp32_q_over_bf16_k_still_raises(lib):
    """What this test once saw refused, an fp32 Q over fp16 K/V or over
    bf16 K with fp32 V, now runs: JAX computes such products on exactly
    upcast operands, so the 2-byte K/V are upcast to fp32 and the fp32
    builds run them (storage codes 3, q_f32 = 1: an fp32 Q's P is not
    rounded)."""
    q, k, v, _ = _qkv(None)
    for kk, vv in ((k.half(), v.half()), (k.to(torch.bfloat16), v)):
        lib.calls.clear()
        _, (o, _) = _forward(q, kk, vv, {}, "online")
        assert lib.names() == ["cfa_flash_fwd"]
        assert _types(lib.calls[0][1]) == (3, 3, 1)
        assert o.dtype == torch.float32


@pytest.mark.parametrize("softmax,causal,entries", [
    ("online", False, ["cfa_flash_fwd"]),
    ("bound_unchecked", False, ["cfa_flash_fwd_bound"]),
    ("auto", False, ["cfa_flash_fwd_bound", "cfa_flash_fwd"]),
    ("auto", True, ["cfa_flash_fwd_kmajor", "cfa_flash_fwd"])])
def test_fp32_q_over_bf16_kv_reaches_its_build(lib, softmax, causal,
                                               entries):
    """An fp32 Q over bf16 K/V launches the fp32-Q builds with storage
    code 0 for K and V and q_f32 = 1 (behind a bound launch, the guarded
    online one of the same build); K5 takes its longest span, as over
    codes (the exact-K/V rule of `kmajor_span`)."""
    q, k, v, _ = _qkv(None, nq=5200 if causal else 40)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    plan, _ = _forward(q, k, v, {}, softmax, causal=causal)
    assert lib.names() == entries
    assert all(_types(a) == (0, 0, 1) for _, a in lib.calls)
    if causal:
        assert plan.use_kmajor
        assert lib.calls[0][1][-2] == ff._KMAJOR_MAX_SPAN_F32Q[128]


@pytest.mark.parametrize("out_dtype,code", [
    (torch.bfloat16, 0), (torch.float32, 1), (torch.float16, 2),
    (torch.int32, 1), (torch.bool, 1)])
@pytest.mark.parametrize("entry", ["cfa_flash_fwd", "cfa_flash_fwd_bound",
                                   "cfa_flash_fwd_kmajor"])
def test_out_dtype_reaches_the_epilogue(lib, out_dtype, code, entry):
    """bf16, fp32 and fp16 O are the kernels' epilogues (the code before
    the key tile or span); any other type the JAX function takes is the
    fp32 epilogue's O cast on the host."""
    q, k, v, _ = _qkv(None)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    softmax = "online" if entry == "cfa_flash_fwd" else "bound_unchecked"
    plan = ff._plan(q, k, v, None, True, 0, 0, None, None, None, None, None,
                    softmax, False)
    plan = ff.dataclasses.replace(plan,
                                  use_kmajor=entry == "cfa_flash_fwd_kmajor")
    o, _ = ff._fwd_cuda(q, k, v, plan, out_dtype, None, None, None, None)
    (name, args), = lib.calls
    assert name == entry and args[-3] == code
    assert o.dtype == out_dtype and o.shape == q.shape


@pytest.mark.parametrize("d", [128, 32, 256, 200])
@pytest.mark.parametrize("seg", [False, True])
def test_split_backward_on_fp32_plans_k2_then_k3(lib, d, seg):
    """fused=False on fp32 launches the prologue (D, no accumulator to
    zero), then K2's and K3's fp32 builds (f32 = 1), and counts them;
    narrow heads run at d = 64, widths past 128 at d = 256."""
    q, k, v, _ = _qkv(None, nq=70, nk=70, d=d)
    o, do = torch.zeros_like(q), torch.ones_like(q)
    lse = torch.zeros(q.shape[:3])
    kw = {}
    if seg:
        ids = torch.zeros((2, 70), dtype=torch.int32)
        kw = dict(q_seg=ids, kv_seg=ids)
    before = dict(fb.flash_attention_backward.launches)
    dq, dk, dv = fb._bwd_cuda(q, k, v, o, lse, do, None, True, 0, 0,
                              kw.get("q_seg"), kw.get("kv_seg"), False)
    assert lib.names() == ["cfa_bwd_delta", "cfa_flash_bwd_kv",
                           "cfa_flash_bwd_q"]
    delta_args, kv_args, q_args = (a for _, a in lib.calls)
    assert delta_args[3] is None and delta_args[9:11] == (1, 1)
    assert kv_args[5] == delta_args[2]  # K2 and K3 read the prologue's D
    assert q_args[5] == delta_args[2]
    assert kv_args[10] is None and kv_args[-2] == 1      # K2, f32
    assert q_args[-2] == 1 and q_args[14] == {128: 128, 32: 64, 256: 256,
                                               200: 256}[d]
    assert all(g.dtype == torch.float32 for g in (dq, dk, dv))
    assert dq.shape == q.shape and dk.shape == k.shape
    after = fb.flash_attention_backward.launches
    assert after["dkdv"] == before["dkdv"] + 1
    assert after["dq"] == before["dq"] + 1
    assert after["delta"] == before["delta"] + 1


@pytest.mark.parametrize("d", [256, 200])
def test_fused_backward_on_fp32_wide_heads_launches_k4(lib, d):
    """The fused fp32 backward at d = 256 (and 200, on heads zero-padded
    to 256) launches the prologue, which zeroes K4's fp32 accumulator,
    then K4's fp32 build (f32 = 1, the accumulator given) at d = 256; the
    gradients come back fp32 at width d."""
    q, k, v, _ = _qkv(None, nq=70, nk=90, d=d)
    o, do = torch.zeros_like(q), torch.ones_like(q)
    lse = torch.zeros(q.shape[:3])
    before = dict(fb.flash_attention_backward.launches)
    dq, dk, dv = fb._bwd_cuda(q, k, v, o, lse, do, None, True, 0, 0, None,
                              None, True)
    assert lib.names() == ["cfa_bwd_delta", "cfa_flash_bwd_kv"]
    (_, delta_args), (_, kv_args) = lib.calls
    assert delta_args[3] is not None and delta_args[7] == 256
    assert kv_args[10] == delta_args[3]  # K4 adds into the zeroed dq_acc
    assert kv_args[16] == 256 and kv_args[-2] == 1
    assert all(g.dtype == torch.float32 for g in (dq, dk, dv))
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    after = fb.flash_attention_backward.launches
    assert after["fused"] == before["fused"] + 1
    assert after["delta"] == before["delta"] + 1


def test_split_backward_on_bf16_passes_f32_0(lib):
    q, k, v, _ = _qkv(None, nq=70, nk=70)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    fb._bwd_cuda(q, k, v, q, torch.zeros(q.shape[:3]), q, None, True, 0, 0,
                 None, None, False)
    # the prologue's do_f32, then K2's and K3's f32
    assert [a[-2] for _, a in lib.calls] == [0, 0, 0]


@pytest.mark.parametrize("d,d_run", [(128, 128), (64, 64), (32, 64),
                                     (16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fa1_reaches_its_build_at_any_narrow_head(lib, d, d_run, dtype):
    """fa1_attention's host part hands the kernel f32 = 1 for fp32 inputs
    and heads zero-padded to the kernel's d; O comes back at d."""
    q = torch.ones((1, 2, 64, d), dtype=dtype)
    before = tfa1.fa1_attention.launches
    o = tfa1._fa1_cuda(q, q, q, None, False, 64, 64)
    (name, args), = lib.calls
    assert name == "cfa_fa1"
    assert args[8] == d_run and args[-2] == int(dtype == torch.float32)
    assert o.shape == q.shape and o.dtype == dtype
    assert tfa1.fa1_attention.launches == before + 1


def test_fa1_refuses_mixed_dtypes(lib):
    """Mixed float types, once refused, run K8's fp32 build on exactly
    upcast operands with P rounded to v's type (f32 = 1 + its round code:
    1 fp32, 2 bf16), O back in q's dtype; fp16 inputs run the fp16 unit
    (`cfa_fa1_f16`, f32 = 0); an integer input is still refused."""
    q = torch.ones((1, 2, 64, 64))
    for k, v, code in ((q.to(torch.bfloat16), q, 1),
                       (q, q.to(torch.bfloat16), 2),
                       (q.half(), q.half(), 3)):
        lib.calls.clear()
        o = tfa1._fa1_cuda(q, k, v, None, False, 64, 64)
        (name, args), = lib.calls
        assert name == "cfa_fa1" and args[-2] == code
        assert o.dtype == torch.float32
    lib.calls.clear()
    h = q.half()
    o = tfa1._fa1_cuda(h, h, h, None, False, 64, 64)
    (name, args), = lib.calls
    assert name == "cfa_fa1_f16" and args[-2] == 0 and o.dtype == h.dtype
    lib.calls.clear()
    with pytest.raises(NotImplementedError, match="bf16, fp16 or fp32"):
        tfa1._fa1_cuda(q.to(torch.int8), q, q, None, False, 64, 64)
    assert lib.calls == []


@pytest.mark.parametrize("f32", [0, 1])
def test_device_ring_launch_names_its_build(lib, f32):
    """`_launch` hands the kernel the workspace's type (f32 beside the
    scope), and the fp32 build walks one tile per round at d = 128."""
    dev = torch.device("cuda", 0)
    ws = types.SimpleNamespace(
        cards={dev: [0, 1]}, bufs=None, flags=None, n=2, local={dev: None},
        rows=128, d=128, grid=4, sys=0, f32=f32)
    x = torch.zeros(1)
    dr._launch(lib, ws, dev, x, x, x, 1, types.SimpleNamespace(cuda_stream=0))
    (name, args), = lib.calls
    assert name == "cfa_device_ring" and args[12:14] == (0, f32)
    assert dr.rounds_of(5, 128, f32=bool(f32)) == (5 if f32 else 3)
    assert dr.rounds_of(5, 64, f32=bool(f32)) == 2


def test_device_ring_wide_geometry():
    """At d = 256 a round is one tile in both builds (a tile's o alone is
    128 registers a thread), and the fp32 build's span is two CTAs, one
    per column half of W; other widths keep one CTA a span."""
    assert dr.rounds_of(5, 256) == 5 and dr.rounds_of(5, 256, f32=True) == 5
    assert dr.column_parts(256, True) == 2
    assert [dr.column_parts(d, f32) for d in (64, 128) for f32 in
            (False, True)] + [dr.column_parts(256, False)] == [1] * 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_ring_takes_any_width_up_to_256(dtype):
    """Any d from 1 to 256 passes the width check (x and W are zero-padded
    to the next build and then need the mesh on a card); past 256 it
    raises naming the form, before any card is touched."""
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    mesh = make_mesh((2,), ("sp",), ["cpu"] * 2)
    for d in (8, 100, 200, 256):
        x, w = torch.zeros((128, d), dtype=dtype), torch.zeros((d, d),
                                                               dtype=dtype)
        with pytest.raises(ValueError, match="every rank on a card"):
            dr._device_ring_cuda(x, w, mesh, "sp")
    x, w = torch.zeros((128, 300), dtype=dtype), torch.zeros((300, 300),
                                                             dtype=dtype)
    with pytest.raises(ValueError, match="ring takes d from 1 to 256"):
        dr._device_ring_cuda(x, w, mesh, "sp")


def test_device_ring_refuses_what_it_does_not_take():
    """The dtype check comes before any card is touched: int8 raises; fp32
    x and w, fp16 ones and x and w of two float types (upcast to the fp32
    build, JAX's promotion) pass it (and then need the mesh on a card)."""
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    mesh = make_mesh((2,), ("sp",), ["cpu"] * 2)
    x, w = torch.zeros((128, 64)), torch.zeros((64, 64))
    with pytest.raises(NotImplementedError, match="bf16, fp16 or fp32"):
        dr._device_ring_cuda(x.to(torch.int8), w.to(torch.int8), mesh, "sp")
    for xx, ww in ((x, w), (x, w.to(torch.bfloat16)), (x.half(), w.half()),
                   (x.half(), w.to(torch.bfloat16))):
        with pytest.raises(ValueError, match="every rank on a card"):
            dr._device_ring_cuda(xx, ww, mesh, "sp")
