"""FlashAttention-2 forward: host function, CUDA kernel launches, plain
version.

Counterpart of cuda_flashattention_tpu/ops/flash_fwd.py
(`flash_attention_forward`), with its three kernel forms:

  online   K1: running max and rescale (csrc/flash_fwd.cu), on the
           Q-major walk of K1b: a CTA packs the query heads of one KV head
           into a 128-row tile, the walk bounded by the causal and window
           frontiers; under causal the Q tiles are issued heaviest first.
  bound    K1b: the score-bound softmax on a Q-major walk
           (csrc/flash_fwd_bound.cu). The host computes
           c[b,h,i] = ‖q̂_i‖₂ · max_j ‖k_j‖₂ (Cauchy–Schwarz, log2 units)
           and the kernel evaluates p = 2^(s − c) with no running max and
           no rescale; a CTA packs the query heads of one KV head.
  kmajor   K5: the same function split over keys
           (csrc/flash_fwd_kmajor.cu): a CTA keeps a span of key tiles
           resident (dequantised once) and the Q tiles of its group stream
           past; each (Q tile, span) pair's l and acc are added with fp32
           atomics, so O differs in its last fp32 bits from run to run.
           `_kmajor_span` sizes the span so that the grid fills the card,
           unless `block_sizes.block_k` (tile · span) names it.

`block_sizes` picks the key tile among those the routed kernel is built
for (`ops.common.BUILT_TILES`): 64 keys everywhere, or 128 in the bf16
builds of K1 and K1b at d <= 128, and 32 for an fp32 Q over fp32 K/V at
d = 256 (`ops.common.fwd_key_tile`); K5's span; the query tile is 128
rows. Any other
request runs at the nearest built tile below it (`ops.common.check_tiles`,
which logs the mapping once); on the CPU the plain version ignores the
tile (every tile computes the same function).

All three run on one Hopper body, csrc/flash_fwd_bound_sm90.cuh (wgmma,
TMA). `softmax="auto"` routes as the JAX function does (`_resolve_use_bound`,
and K-major for a bound call that is causal or reads fp8 keys), without its
environment knobs and without its on-chip memory budgets, which are TPU
sizes; "online", "bound" and "bound_unchecked" pin the strategy.

The bound can be loose (anti-aligned Q and K of huge norm): a row that
provably has visible keys but whose l falls below 2^-96 is counted by the
kernel, and unless the call is "bound_unchecked" or `quantize_q` the online
kernel is launched after it behind a device-side guard: it exits at once
when the count is 0 and otherwise overwrites O and LSE. No host round trip
is involved; the guarded launch is counted under "fallback".

K and V may be int8 or float8_e4m3fn with per-token fp32 scales (K and V
each in its own type), masks are causal with `kv_offset`, a sliding
`window`, segment ids and the ragged tail, and `quantize_q` runs Q·Kᵀ on
int8 (fp8 keys re-gridded to int8 in the kernel). On a CPU tensor the call
runs `flash_attention_forward_plain`, a dense PyTorch version of the same
arithmetic with the same rounding points; the CPU tests and the on-card
comparisons use it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import (
    KMAJOR_MAX_SPAN,
    KMAJOR_MAX_SPAN_F32,
    KMAJOR_MAX_SPAN_F32Q,
    NEG_INF,
    ONLINE_SHORT_NQ,
    ROUND_CODES,
    built_tiles,
    check_qkv,
    check_tiles,
    fwd_key_tile,
    kernel_operand,
    kmajor_span,
    pad_heads,
    quantize_q_per_head,
    resolve_scale,
    run_dim,
    tile_type,
)

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453

# Below this many query rows "auto" keeps unquantized causal forwards on
# the online softmax, as the JAX function does (ops/common.py).
_ONLINE_SHORT_NQ = ONLINE_SHORT_NQ
# A bound-softmax row with visible keys whose l < 2^-96 has a loose bound.
_FALLBACK_SLACK_LOG2 = 96.0

_SOFTMAX_MODES = ("auto", "bound", "bound_unchecked", "online")
# storage codes of the C entry points: 0 is the unit's 2-byte type (bf16,
# or fp16 in the fp16 unit's entry points, `_f16`)
_STORAGE_CODES = {torch.bfloat16: 0, torch.float16: 0, torch.int8: 1,
                  torch.float8_e4m3fn: 2, torch.float32: 3}
_FLOATS = (torch.bfloat16, torch.float16, torch.float32)
# the quantized (K, V) storage pairs: one type for both, or the "mixed"
# cache's int8 K with fp8 V, under any float Q
_CODE_PAIRS = ((torch.int8, torch.int8),
               (torch.float8_e4m3fn, torch.float8_e4m3fn),
               (torch.int8, torch.float8_e4m3fn))
# The output types the kernels' epilogues write (their C code): O in any
# other type the JAX function takes is the fp32 epilogue's O cast on the
# host (`_resolve_out_dtype`).
_OUT_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def _resolve_out_dtype(q, out_dtype) -> torch.dtype:
    """O's dtype: q's by default. The JAX function casts its fp32 O to any
    `out_dtype` but float64 (refused without 64-bit mode, which the JAX
    package does not enable) and the complex types; so does this one:
    ValueError for those."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if not isinstance(out_dtype, torch.dtype) or out_dtype.is_complex or (
            out_dtype == torch.float64):
        raise ValueError(f"out_dtype {out_dtype}: the forward writes O in a "
                         f"real type of at most 32 bits")
    return out_dtype


def _prescale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Q · scale · log2(e), rounded in Q's dtype: the kernel then works in
    log2 units with exp2. For an fp16 Q the factor is first rounded to
    fp16, as JAX's weakly typed scalar is, so that each product is rounded
    once from the same two operands in both packages (at fp16's precision
    the factor's rounding shows in the LSE). A bf16 Q keeps the factor
    unrounded, as the port always has: JAX's bf16 rounding of it moves the
    scores by up to 2^-9 relative, inside the bf16 gates, and differently
    from FA1's factor (`ops/fa1.py`), which the FA2 forward is held to on
    the card."""
    if q.dtype == torch.float16:
        return q * torch.tensor(scale * _LOG2E, dtype=q.dtype)
    return (q * (scale * _LOG2E)).to(q.dtype)


def _resolve_use_bound(softmax: str, *, causal: bool, quantized: bool,
                       segmented: bool, nq: int) -> bool:
    """Route `softmax="auto"` between the bound and online strategies, as
    the JAX function does: segmented inputs and short unquantized causal
    forwards go online, everything else bound."""
    if softmax in ("bound", "bound_unchecked"):
        return True
    if softmax != "auto" or segmented:
        return False
    if causal and not quantized and nq <= _ONLINE_SHORT_NQ:
        return False
    return True


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What one call resolved to, after validation."""
    d: int            # the caller's head dim (the kernels may run padded)
    scale: float
    causal: bool
    window: int
    kv_offset: int
    quantized: bool
    segmented: bool
    use_bound: bool
    use_kmajor: bool  # the bound form on the K-major walk
    qq: bool          # int8 Q · int8 K
    regrid: bool      # qq over fp8 keys: re-grid them to int8
    checked: bool     # run the loose-bound fallback
    block_k: Optional[int] = None  # the routed kernel's key tile (K5: its
                                   # tile · span); None: the default rule
    fallback_k: int = 64  # the guarded online launch's key tile


def _plan(q, k, v, scale, causal, window, kv_offset, block_sizes, k_scale,
          v_scale, q_segment_ids, kv_segment_ids, softmax,
          quantize_q) -> _Plan:
    check_qkv(q, k, v)
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    quantized = k_scale is not None
    if quantized and v_scale is None:
        raise ValueError("k_scale given without v_scale")
    if v_scale is not None and not quantized:
        raise ValueError("v_scale given without k_scale")
    segmented = q_segment_ids is not None
    if segmented and kv_segment_ids is None:
        raise ValueError("q_segment_ids given without kv_segment_ids")
    if kv_segment_ids is not None and not segmented:
        raise ValueError("kv_segment_ids given without q_segment_ids")
    window = int(window or 0)
    causal = bool(causal)
    if window and not causal:
        raise ValueError("window requires causal=True (causal sliding "
                         "window attention)")
    if softmax not in _SOFTMAX_MODES:
        raise ValueError(f"softmax must be auto|bound|bound_unchecked|"
                         f"online, got {softmax!r}")
    use_bound = _resolve_use_bound(softmax, causal=causal,
                                   quantized=quantized, segmented=segmented,
                                   nq=nq)
    if use_bound and segmented:
        raise ValueError("softmax='bound' is unsupported with segment "
                         "ids; use 'auto' or 'online'")
    qq = bool(quantize_q)
    if qq and not quantized:
        raise ValueError("quantize_q requires quantized KV "
                         "(k_scale/v_scale)")
    if qq and not use_bound:
        raise ValueError("quantize_q requires the bound softmax "
                         "(softmax='auto'/'bound', no segment ids)")
    if quantized:
        for name, x, sc in (("k", k, k_scale), ("v", v, v_scale)):
            if x.dtype not in (torch.int8, torch.float8_e4m3fn):
                raise ValueError(f"quantized {name} must be int8 or "
                                 f"float8_e4m3fn, got {x.dtype}")
            if tuple(sc.shape) != (b, h_kv, nk):
                raise ValueError(
                    f"scale shape {tuple(sc.shape)} != {(b, h_kv, nk)}")
    elif not (k.dtype.is_floating_point and v.dtype.is_floating_point
              and k.dtype.itemsize > 1 and v.dtype.itemsize > 1):
        raise ValueError(f"k {k.dtype} / v {v.dtype} need k_scale/v_scale")
    if segmented and (tuple(q_segment_ids.shape) != (b, nq)
                      or tuple(kv_segment_ids.shape) != (b, nk)):
        raise ValueError(
            f"segment ids {tuple(q_segment_ids.shape)} / "
            f"{tuple(kv_segment_ids.shape)} != {(b, nq)} / {(b, nk)}")
    # fp8 keys under a bf16 Q: the form the JAX function gives the K-major
    # walk to, and the only one whose keys quantize_q can re-grid
    fp8_fast = (quantized and k.dtype == torch.float8_e4m3fn
                and q.dtype == torch.bfloat16)
    if qq and k.dtype == torch.float8_e4m3fn and not fp8_fast:
        qq = False
    use_kmajor = use_bound and (causal or fp8_fast)
    ty = tile_type(q.dtype, k.dtype, v.dtype)
    block_k, fallback_k = None, fwd_key_tile(ty, run_dim(d))
    if block_sizes is not None:
        kernel = "K5" if use_kmajor else "K1b" if use_bound else "K1"
        block_k = check_tiles(kernel, ty, d, block_sizes,
                              "flash_attention_forward block_sizes")
        # the guarded online launch behind a bound one keeps the tile
        # where K1 is built for it
        k1 = built_tiles("K1", ty, d)
        if k1 is not None and block_k in k1[1]:
            fallback_k = block_k
    return _Plan(
        d=d, scale=resolve_scale(scale, d), causal=causal, window=window,
        kv_offset=int(kv_offset), quantized=quantized, segmented=segmented,
        use_bound=use_bound, use_kmajor=use_kmajor,
        qq=qq, regrid=qq and fp8_fast,
        checked=use_bound and not qq and softmax != "bound_unchecked",
        block_k=block_k, fallback_k=fallback_k)


def _quantize_q(q, plan: _Plan):
    """quantize_q's host part: per-(batch, head) int8 Q. Returns (q8
    [B,H,Nq,d] int8, factor [B,H,1] restoring q8 to log2 score units, the
    per-head factor of the K scale rows: `factor`, times 448/127 for the
    fp8 → int8 re-grid)."""
    q8, sq = quantize_q_per_head(q, (2, 3))            # sq [B,H,1,1]
    factor = sq[:, :, :, 0] * (plan.scale * _LOG2E)    # [B,H,1]
    return q8, factor, factor * (448.0 / 127.0) if plan.regrid else factor


def _row_norms(x):
    """‖x_i‖₂ over the last dim, fp32: one fp32-accumulating reduction
    with no fp32 copy (one-byte codes are read through bf16, which holds
    every int8 and e4m3 value exactly)."""
    if x.element_size() == 1:
        x = x.to(torch.bfloat16)
    return torch.linalg.vector_norm(x, dim=-1, dtype=torch.float32)


def _score_bound(q_hat, k, k_scale, *, factor=None, regrid=False, d=None):
    """c [B,H,Nq] fp32 = ‖q̂_i‖₂ · max_j ‖k_j‖₂ in log2 units. q_hat is the
    prescaled ROUNDED Q (a score computed from it cannot exceed c), or
    under quantize_q the int8 Q with `factor` restoring real units; a
    quantized key's norm is its codes' norm times its scale, inflated by
    the re-grid's worst rounding √d·(224/127)·scale under `regrid` (d:
    the caller's head dim, which k's zero columns past it do not
    change; default k's)."""
    group = q_hat.shape[1] // k.shape[1]
    k_norms = _row_norms(k)                                  # [B,Hkv,Nk]
    if k_scale is not None:
        ks = k_scale.float()
        k_norms = k_norms * ks
        if regrid:
            d = k.shape[-1] if d is None else d
            k_norms = k_norms + ks * (math.sqrt(d) * 224.0 / 127.0)
    kmax = k_norms.amax(dim=-1)                              # [B,Hkv]
    qn = _row_norms(q_hat)                                   # [B,H,Nq]
    if factor is not None:
        qn = qn * factor
    b, h, nq = qn.shape
    return (qn.view(b, h // group, group, nq)
            * kmax[:, :, None, None]).view(b, h, nq)


def _visible(nq, nk, plan: _Plan, q_seg, kv_seg, device):
    """Boolean mask broadcastable to [B,Hkv,G,Nq,Nk], or None."""
    ok = None
    if plan.causal:
        rows = torch.arange(nq, device=device)[:, None] + plan.kv_offset
        cols = torch.arange(nk, device=device)[None, :]
        ok = cols <= rows
        if plan.window:
            ok = ok & (cols > rows - plan.window)
    if plan.segmented:
        same = (q_seg[:, :, None] == kv_seg[:, None, :])[:, None, None]
        ok = same if ok is None else ok & same
    return ok


def _forward_plain(q, k, v, plan: _Plan, out_dtype, k_scale, v_scale, q_seg,
                   kv_seg, bound: bool):
    """One strategy of the dense version. Returns (O, LSE, loose-bound
    flags [B,H,Nq] bool or None)."""
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    group = h // h_kv
    zero = torch.zeros((), device=q.device)
    if bound and plan.qq:
        q8, factor, row_factor = _quantize_q(q, plan)
        rows = k_scale.float()
        if group > 1:
            rows = rows.repeat_interleave(group, dim=1)      # [B,H,Nk]
        rows = rows * row_factor
        qs, krow = q8.float(), rows.view(b, h_kv, group, 1, nk)
        kf = k.float()
        if plan.regrid:
            kf = torch.clamp(torch.round(kf * (127.0 / 448.0)), -127, 127)
        c = _score_bound(q8, k, k_scale, factor=factor, regrid=plan.regrid,
                         d=plan.d)
        p_dtype = torch.bfloat16
    else:
        q_hat = _prescale_q(q, plan.scale)
        qs, kf = q_hat.float(), k.float()
        krow = (k_scale.float().view(b, h_kv, 1, 1, nk) if plan.quantized
                else None)
        c = _score_bound(q_hat, k, k_scale) if bound else None
        p_dtype = q.dtype
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs.view(b, h_kv, group, nq, d), kf)
    if krow is not None:
        s = s * krow
    ok = _visible(nq, nk, plan, q_seg, kv_seg, q.device)
    if ok is not None:
        s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    if bound:
        ref = c.view(b, h_kv, group, nq, 1)
        p = torch.exp2(s - ref)
        if ok is not None:
            p = torch.where(ok, p, zero)
    else:
        ref = s.amax(dim=-1, keepdim=True)
        p = torch.where(s > NEG_INF * 0.5, torch.exp2(s - ref), zero)
    l = p.sum(dim=-1, keepdim=True)
    if plan.quantized:  # rounded AFTER the scale
        p = p * v_scale.float().view(b, h_kv, 1, 1, nk)
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(p_dtype).float(), v.float())
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    o = torch.where(empty, zero, pv / l_safe)
    lse = torch.where(empty, torch.full_like(l, NEG_INF),
                      ref * _LN2 + torch.log(l_safe))
    flags = None
    if bound:
        # rows that provably have visible keys (an empty row's l = 0 is
        # legitimate) whose weights all sit 96 log2 units under the bound
        flags = l.reshape(b, h, nq) < 2.0 ** (-_FALLBACK_SLACK_LOG2)
        if plan.causal:
            g = torch.arange(nq, device=q.device) + plan.kv_offset
            vis = g >= 0
            if plan.window:
                vis = vis & (g - plan.window + 1 <= nk - 1)
            flags = flags & vis
    return (o.reshape(b, h, nq, d).to(out_dtype), lse.reshape(b, h, nq),
            flags)


def flash_attention_forward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    block_sizes=None,
    out_dtype: Optional[torch.dtype] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax: str = "auto",
    quantize_q: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense PyTorch version of the kernels' arithmetic, on any device,
    with `flash_attention_forward`'s arguments and routing.

    Scores in fp32 log2 units from the prescaled Q (or the int8 Q and,
    over fp8 keys, the re-gridded int8 K), times the per-token K scale;
    masked entries at NEG_INF with probability 0; online p = 2^(s − m),
    bound p = 2^(s − c) with the same c the kernels are given; P·v_scale
    rounded to the input dtype (bf16 under quantize_q) before P·V with
    fp32 accumulation; LSE = m·ln2 + ln l (c for m when bound); empty
    rows O = 0 and LSE = NEG_INF. The K-major and Q-major bound kernels
    share this version: they compute one function. The loose-bound flags
    and the online re-run they trigger are part of it."""
    plan = _plan(q, k, v, scale, causal, window, kv_offset, block_sizes,
                 k_scale, v_scale, q_segment_ids, kv_segment_ids, softmax,
                 quantize_q)
    return _fwd_plain(q, k, v, plan, _resolve_out_dtype(q, out_dtype),
                      k_scale, v_scale, q_segment_ids, kv_segment_ids)


def _fwd_plain(q, k, v, plan: _Plan, *rest):
    """The plain version of a resolved call (the arguments of
    `_forward_plain`): the routed strategy, then the online one if the
    call is checked and the bound was loose on any row."""
    o, lse, flags = _forward_plain(q, k, v, plan, *rest,
                                   bound=plan.use_bound)
    if plan.checked and bool(flags.any()):
        o, lse, _ = _forward_plain(q, k, v, plan, *rest, bound=False)
    return o, lse


def _ptrs(*tensors):
    """A C array of the tensors' device pointers (NULL for None)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


# key tiles a K5 CTA keeps resident at each head dim, and the rule that
# picks its span (ops/common.py); `utils/kmajor_spans.py`
# replaces `_kmajor_span` to time each span
_KMAJOR_MAX_SPAN = KMAJOR_MAX_SPAN
_KMAJOR_MAX_SPAN_F32 = KMAJOR_MAX_SPAN_F32
_KMAJOR_MAX_SPAN_F32Q = KMAJOR_MAX_SPAN_F32Q
_kmajor_span = kmajor_span


def _fwd_cuda(q, k, v, plan: _Plan, out_dtype, k_scale, v_scale, q_seg,
              kv_seg):
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    d_run, padded = pad_heads("forward", q, k, v)
    if d_run != d:
        # the next build up on zero-padded heads; plan.scale is d's
        o, lse = _fwd_cuda(*padded, plan, out_dtype, k_scale, v_scale,
                           q_seg, kv_seg)
        return o[..., :d], lse
    for name, x in (("k", k), ("v", v), ("k_scale", k_scale),
                    ("v_scale", v_scale), ("q_segment_ids", q_seg),
                    ("kv_segment_ids", kv_seg)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    # a bf16 or fp16 Q over K/V of its type, or over one-byte codes, runs
    # the unit of its type (fp16: the `_f16` entry points); an fp32 Q the
    # fp32 builds, which read it as it is and split each tile into bf16 hi
    # and lo parts: over fp32 K/V split the same way, or over bf16 K/V
    # (read by TMA as they are) or one-byte K/V (converted exactly to
    # bf16); under quantize_q the int8 Q of the host runs the bf16 unit's
    # int8 build whatever Q's type (its P·V is bf16, as JAX's). Mixed float
    # types follow JAX's promotion: each product on exactly upcast
    # operands, P rounded to Q's type before P·V; so Q (prescaled in its
    # own type) and, unless both are bf16, K and V are upcast to fp32 and
    # the fp32 builds round P (`ROUND_CODES`)
    ty = tile_type(q.dtype, k.dtype, v.dtype)
    if q.dtype not in _FLOATS:
        raise NotImplementedError(
            f"the CUDA forward takes a bf16, fp16 or fp32 Q, got {q.dtype}")
    if plan.quantized and (k.dtype, v.dtype) not in _CODE_PAIRS:
        raise NotImplementedError(
            f"the CUDA forward takes quantized K/V stored as one of "
            f"{_CODE_PAIRS}, got k {k.dtype} / v {v.dtype}")
    if not plan.quantized and not (k.dtype in _FLOATS and v.dtype in _FLOATS):
        raise NotImplementedError(
            f"the CUDA forward takes bf16, fp16 or fp32 K/V, got k {k.dtype} "
            f"/ v {v.dtype}")
    mixed = ty in ("fp32", "fp32/bf16") and q.dtype != torch.float32
    if ty == "fp32":
        k, v = k.float(), v.float()
    f32 = q.dtype == torch.float32 or mixed
    # the fp16 unit's builds, unless only quantize_q's int8 Q is read
    half = (q.dtype == torch.float16 and not mixed
            and not (plan.use_bound and plan.qq))
    if out_dtype not in _OUT_CODES:
        # the fp32 epilogue, cast as the JAX function casts its fp32 O
        o, lse = _fwd_cuda(q, k, v, plan, torch.float32, k_scale, v_scale,
                           q_seg, kv_seg)
        return o.to(out_dtype), lse
    k_type, v_type = _STORAGE_CODES[k.dtype], _STORAGE_CODES[v.dtype]
    k, v = kernel_operand(k), kernel_operand(v)
    ksc = vsc = None
    if plan.quantized:
        ksc, vsc = k_scale.float().contiguous(), v_scale.float().contiguous()
    if plan.segmented:
        q_seg = q_seg.to(torch.int32).contiguous()
        kv_seg = kv_seg.to(torch.int32).contiguous()
    # the prescaled Q (rounded in Q's type, then exactly upcast where the
    # call is mixed), unless only the int8 Q of quantize_q is read
    q_hat = None
    if not (plan.use_bound and plan.qq):
        q_hat = _prescale_q(q, plan.scale)
        q_hat = kernel_operand(q_hat.float() if mixed else q_hat)
    o = torch.empty((b, h, nq, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    counts = flash_attention_forward.form_launches
    tail = (int(plan.causal), plan.window, plan.kv_offset,
            _OUT_CODES[out_dtype])
    # the Q the kernel reads is fp32 unless it is quantize_q's int8 Q: code
    # 1, or under a mixed call 2 / 3, P rounded to bf16 / fp16
    q_f32 = (1 + ROUND_CODES[q.dtype]
             if f32 and not (plan.use_bound and plan.qq) else 0)
    # the key tile a call runs at by default: 64, or 32 for an fp32 Q over
    # fp32 K/V at d = 256 (that build's only tile)
    tile = fwd_key_tile(ty, d)

    def strides(q_op):
        return (ctypes.c_longlong * 9)(
            *q_op.stride()[:3], *k.stride()[:3], *v.stride()[:3])

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _build.library()
        unit = "_f16" if half else ""

        def online(guard):
            kn = (plan.block_k or tile) if guard is None else plan.fallback_k
            err = getattr(lib, "cfa_flash_fwd" + unit)(
                _ptrs(q_hat, k, v, ksc, vsc, q_seg, kv_seg, guard, o, lse),
                b, h, h_kv, nq, nk, d, strides(q_hat), k_type, v_type, q_f32,
                *tail, kn, stream)
            _build.check(err, "flash_attention_forward online kernel launch")
            counts["online" if guard is None else "fallback"] += 1
            flash_attention_forward.launches += 1
            if kn == 128:
                flash_attention_forward.key128_launches[
                    "online" if guard is None else "fallback"] += 1

        if not plan.use_bound:
            online(None)
            return o, lse

        if plan.qq:
            q8, factor, row_factor = _quantize_q(q, plan)
            q_op = kernel_operand(q8)
            q_factor = row_factor[:, :, 0].contiguous()
            c = _score_bound(q8, k, k_scale, factor=factor,
                             regrid=plan.regrid, d=plan.d)
        else:
            q_op, q_factor = q_hat, None
            c = _score_bound(q_hat, k, k_scale)
        c = c.contiguous()
        shape = (b, h, h_kv, nq, nk, d, strides(q_op), k_type, v_type,
                 q_f32, int(plan.qq), *tail)
        if plan.use_kmajor:
            # one zeroed buffer: each (Q tile, span) pair's partial sums,
            # added with atomics (acc, then l), then the loose-row count
            n_acc = b * h * nq * d
            scratch = torch.zeros(n_acc + b * h * nq + 1,
                                  dtype=torch.float32, device=q.device)
            o_acc = scratch[:n_acc]
            l_acc = scratch[n_acc:-1]
            n_loose = scratch[-1:].view(torch.int32)
            if plan.block_k is not None:
                span = plan.block_k // tile
            else:
                sms = torch.cuda.get_device_properties(
                    q.device).multi_processor_count
                span = _kmajor_span(b, h_kv, nk, d, sms, bool(q_f32),
                                    k.dtype != torch.float32)
            err = getattr(lib, "cfa_flash_fwd_kmajor" + unit)(
                _ptrs(q_op, k, v, ksc, vsc, q_factor, c, l_acc, o_acc,
                      n_loose, o, lse), *shape, span, stream)
            _build.check(err, "flash_attention_forward K-major kernel launch")
            counts["kmajor"] += 1
        else:
            n_loose = torch.zeros(1, dtype=torch.int32, device=q.device)
            err = getattr(lib, "cfa_flash_fwd_bound" + unit)(
                _ptrs(q_op, k, v, ksc, vsc, q_factor, c, n_loose, o, lse),
                *shape, plan.block_k or tile, stream)
            _build.check(err, "flash_attention_forward bound kernel launch")
            counts["bound"] += 1
            if plan.block_k == 128:
                flash_attention_forward.key128_launches["bound"] += 1
        flash_attention_forward.launches += 1
        if plan.checked:
            online(n_loose)
    return o, lse


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    block_sizes=None,
    out_dtype: Optional[torch.dtype] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax: str = "auto",
    quantize_q: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FA2 forward. q [B,H,Nq,d], k/v [B,Hkv,Nk,d] → (O [B,H,Nq,d],
    LSE [B,H,Nq] fp32, natural log).

    H must be a multiple of Hkv (GQA: head h reads KV head h // (H/Hkv)).
    `causal` masks key j for query i when j > i + kv_offset; `window`
    (requires causal) also when j <= i + kv_offset − window;
    `q_segment_ids` [B,Nq] / `kv_segment_ids` [B,Nk] mask pairs whose ids
    differ. A row that sees no key gives O = 0, LSE = NEG_INF. Quantized
    K/V: int8 or float8_e4m3fn values with per-token fp32 `k_scale` /
    `v_scale` [B,Hkv,Nk], dequantisation folded into the products.
    `softmax`: "auto", "online", "bound" or "bound_unchecked" (module
    docstring). `block_sizes` (`ops.common.BlockSizes`): block_q 128 and
    the routed kernel's key tile, 64, or 128 over bf16 Q/K/V in K1 and
    K1b at d <= 128, 32 for an fp32 Q over fp32 K/V at d = 256, or K5's
    tile · span; another tile runs at the nearest built one below it
    (`ops.common.check_tiles`). `quantize_q` (quantized K/V,
    bound softmax): Q·Kᵀ on
    per-head int8 Q; it waives the loose-bound fallback, and over fp8 keys
    it takes a bf16 Q (else it is dropped, as in the JAX function, whose
    further gate by on-chip memory is not ported). O is in `out_dtype`
    (default: q's dtype; the kernels write fp32, bf16 or fp16, and any
    other real type of at most 32 bits is the fp32 O cast, as the JAX
    function casts; float64 and complex types raise ValueError, as they
    do there). On the card the kernels take d in {64, 128, 256}, and
    any other d below 256 on zero-padded heads (`ops.common.pad_heads`:
    the next of 64, 128 and 256, O sliced back; at a d that is no build
    each call copies Q, K and V), and a bf16 or fp16 Q over K/V of its
    type or the quantized K/V above (the bf16 and fp16 builds; quantize_q
    runs the bf16 unit's int8-Q build, P·V in bf16, for either), or an
    fp32 Q over fp32 or bf16 K/V or
    over the quantized K/V above (their fp32 builds: each fp32 tile split
    into bf16 hi and lo parts, each product three bf16 products with fp32
    sums, two over bf16 or one-byte K/V, which are exact bf16 tiles; P ·
    v_scale is not rounded), and Q, K, V of mixed float types as JAX
    promotes them (the 2-byte operands upcast exactly to fp32, bf16 K/V
    read as they are, the fp32 builds rounding P to Q's type before P·V);
    `flash_attention_forward.launches` counts
    their launches and `.form_launches` the same per form: "online",
    "bound", "kmajor", and "fallback" for the guarded online launch behind
    a checked bound call; `.key128_launches` counts those of the 128-key
    builds of K1 ("online", and "fallback" for its guarded launches) and
    K1b ("bound")."""
    plan = _plan(q, k, v, scale, causal, window, kv_offset, block_sizes,
                 k_scale, v_scale, q_segment_ids, kv_segment_ids, softmax,
                 quantize_q)
    out_dtype = _resolve_out_dtype(q, out_dtype)
    args = (q, k, v, plan, out_dtype, k_scale, v_scale, q_segment_ids,
            kv_segment_ids)
    if q.device.type == "cpu":
        return _fwd_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _fwd_cuda(*args)


flash_attention_forward.launches = 0
flash_attention_forward.form_launches = {"online": 0, "bound": 0,
                                         "kmajor": 0, "fallback": 0}
flash_attention_forward.key128_launches = {"online": 0, "bound": 0,
                                           "fallback": 0}
