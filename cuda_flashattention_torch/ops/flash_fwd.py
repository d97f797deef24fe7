"""FlashAttention-2 forward: host function, CUDA kernel launches, plain
version.

Counterpart of cuda_flashattention_tpu/ops/flash_fwd.py
(`flash_attention_forward`), with its three kernel forms:

  online   K1: running max and rescale (csrc/flash_fwd.cu), one CTA per
           64-row Q tile, the walk bounded by the causal and window
           frontiers, GQA through `h // group` with no repeat materialised.
  bound    K1b: the score-bound softmax on a Q-major walk
           (csrc/flash_fwd_bound.cu, wgmma + TMA). The host computes
           c[b,h,i] = ‖q̂_i‖₂ · max_j ‖k_j‖₂ (Cauchy–Schwarz, log2 units)
           and the kernel evaluates p = 2^(s − c) with no running max and
           no rescale; a CTA packs the query heads of one KV head.
  kmajor   K5: the same function split over keys
           (csrc/flash_fwd_kmajor.cu): a CTA keeps a span of key tiles
           resident (dequantised once) and the Q tiles of its group stream
           past; each (Q tile, span) pair's l and acc are added with fp32
           atomics, so O differs in its last fp32 bits from run to run.
           `_kmajor_span` sizes the span so that the grid fills the card.

`softmax="auto"` routes as the JAX function does (`_resolve_use_bound`,
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
comparisons use it. Only explicit `block_sizes` still raise
NotImplementedError (the kernels' tiles are fixed).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import (
    KERNEL_HEAD_DIMS,
    NEG_INF,
    cdiv,
    check_qkv,
    kernel_operand,
    quantize_q_per_head,
    resolve_scale,
)

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453

# Below this many query rows "auto" keeps unquantized causal forwards on
# the online softmax, as the JAX function does.
_ONLINE_SHORT_NQ = 5120
# A bound-softmax row with visible keys whose l < 2^-96 has a loose bound.
_FALLBACK_SLACK_LOG2 = 96.0

_SOFTMAX_MODES = ("auto", "bound", "bound_unchecked", "online")
_STORAGE_CODES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
# (K, V) storage pairs the kernels take: one type for both, or the "mixed"
# cache's int8 K with fp8 V
_STORAGE_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.int8, torch.int8),
                  (torch.float8_e4m3fn, torch.float8_e4m3fn),
                  (torch.int8, torch.float8_e4m3fn))


def _prescale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Q · scale · log2(e), rounded in Q's dtype: the kernel then works in
    log2 units with exp2."""
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
    if block_sizes is not None:
        raise NotImplementedError("block_sizes: the kernels' tiles are fixed")
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
    return _Plan(
        scale=resolve_scale(scale, d), causal=causal, window=window,
        kv_offset=int(kv_offset), quantized=quantized, segmented=segmented,
        use_bound=use_bound,
        use_kmajor=use_bound and (causal or fp8_fast),
        qq=qq, regrid=qq and fp8_fast,
        checked=use_bound and not qq and softmax != "bound_unchecked")


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


def _score_bound(q_hat, k, k_scale, *, factor=None, regrid=False):
    """c [B,H,Nq] fp32 = ‖q̂_i‖₂ · max_j ‖k_j‖₂ in log2 units. q_hat is the
    prescaled ROUNDED Q (a score computed from it cannot exceed c), or
    under quantize_q the int8 Q with `factor` restoring real units; a
    quantized key's norm is its codes' norm times its scale, inflated by
    the re-grid's worst rounding √d·(224/127)·scale under `regrid`."""
    group = q_hat.shape[1] // k.shape[1]
    k_norms = _row_norms(k)                                  # [B,Hkv,Nk]
    if k_scale is not None:
        ks = k_scale.float()
        k_norms = k_norms * ks
        if regrid:
            k_norms = k_norms + ks * (math.sqrt(k.shape[-1]) * 224.0 / 127.0)
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
        c = _score_bound(q8, k, k_scale, factor=factor, regrid=plan.regrid)
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
    return _fwd_plain(q, k, v, plan, q.dtype if out_dtype is None
                      else out_dtype, k_scale, v_scale, q_segment_ids,
                      kv_segment_ids)


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


# key tiles (of 64) a K5 CTA keeps resident at each head dim: what fits
# beside its Q ring (csrc/flash_fwd_kmajor.cu, max_span)
_KMAJOR_MAX_SPAN = {64: 8, 128: 4}
_KMAJOR_TILE = 64


def _kmajor_span(b: int, h_kv: int, nk: int, d: int, sms: int) -> int:
    """Key tiles per K5 CTA: the longest span the CTA can keep resident
    whose grid (one CTA per span, KV head and batch) still holds two waves
    of `sms` CTAs; 1, the most CTAs, when none does. Longer spans add each
    query row's partial sums fewer times."""
    tiles = cdiv(nk, _KMAJOR_TILE)
    for span in range(_KMAJOR_MAX_SPAN[d], 1, -1):
        if cdiv(tiles, span) * h_kv * b >= 2 * sms:
            return span
    return 1


def _fwd_cuda(q, k, v, plan: _Plan, out_dtype, k_scale, v_scale, q_seg,
              kv_seg):
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA forward takes d in {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA forward takes bf16 inputs, got q {q.dtype}")
    for name, x in (("k", k), ("v", v), ("k_scale", k_scale),
                    ("v_scale", v_scale), ("q_segment_ids", q_seg),
                    ("kv_segment_ids", kv_seg)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if (k.dtype, v.dtype) not in _STORAGE_PAIRS:
        raise NotImplementedError(
            f"the CUDA forward takes bf16 inputs, or K/V stored as one of "
            f"{_STORAGE_PAIRS[1:]} with scales, got k {k.dtype} / v "
            f"{v.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"out_dtype {out_dtype} on the card")
    k_type, v_type = _STORAGE_CODES[k.dtype], _STORAGE_CODES[v.dtype]
    k, v = kernel_operand(k), kernel_operand(v)
    ksc = vsc = None
    if plan.quantized:
        ksc, vsc = k_scale.float().contiguous(), v_scale.float().contiguous()
    if plan.segmented:
        q_seg = q_seg.to(torch.int32).contiguous()
        kv_seg = kv_seg.to(torch.int32).contiguous()
    # the prescaled Q, unless only the int8 Q of quantize_q is read
    q_hat = (None if plan.use_bound and plan.qq
             else kernel_operand(_prescale_q(q, plan.scale)))
    o = torch.empty((b, h, nq, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    counts = flash_attention_forward.form_launches
    tail = (int(plan.causal), plan.window, plan.kv_offset,
            int(out_dtype == torch.float32))

    def strides(q_op):
        return (ctypes.c_longlong * 9)(
            *q_op.stride()[:3], *k.stride()[:3], *v.stride()[:3])

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _build.library()

        def online(guard):
            err = lib.cfa_flash_fwd(
                _ptrs(q_hat, k, v, ksc, vsc, q_seg, kv_seg, guard, o, lse),
                b, h, h_kv, nq, nk, d, strides(q_hat), k_type, v_type, *tail,
                stream)
            _build.check(err, "flash_attention_forward online kernel launch")
            counts["online" if guard is None else "fallback"] += 1
            flash_attention_forward.launches += 1

        if not plan.use_bound:
            online(None)
            return o, lse

        if plan.qq:
            q8, factor, row_factor = _quantize_q(q, plan)
            q_op = kernel_operand(q8)
            q_factor = row_factor[:, :, 0].contiguous()
            c = _score_bound(q8, k, k_scale, factor=factor,
                             regrid=plan.regrid)
        else:
            q_op, q_factor = q_hat, None
            c = _score_bound(q_hat, k, k_scale)
        c = c.contiguous()
        shape = (b, h, h_kv, nq, nk, d, strides(q_op), k_type, v_type,
                 int(plan.qq), *tail)
        if plan.use_kmajor:
            # one zeroed buffer: each (Q tile, span) pair's partial sums,
            # added with atomics (acc, then l), then the loose-row count
            n_acc = b * h * nq * d
            scratch = torch.zeros(n_acc + b * h * nq + 1,
                                  dtype=torch.float32, device=q.device)
            o_acc = scratch[:n_acc]
            l_acc = scratch[n_acc:-1]
            n_loose = scratch[-1:].view(torch.int32)
            sms = torch.cuda.get_device_properties(
                q.device).multi_processor_count
            span = _kmajor_span(b, h_kv, nk, d, sms)
            err = lib.cfa_flash_fwd_kmajor(
                _ptrs(q_op, k, v, ksc, vsc, q_factor, c, l_acc, o_acc,
                      n_loose, o, lse), *shape, span, stream)
            _build.check(err, "flash_attention_forward K-major kernel launch")
            counts["kmajor"] += 1
        else:
            n_loose = torch.zeros(1, dtype=torch.int32, device=q.device)
            err = lib.cfa_flash_fwd_bound(
                _ptrs(q_op, k, v, ksc, vsc, q_factor, c, n_loose, o, lse),
                *shape, stream)
            _build.check(err, "flash_attention_forward bound kernel launch")
            counts["bound"] += 1
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
    docstring). `quantize_q` (quantized K/V, bound softmax): Q·Kᵀ on
    per-head int8 Q; it waives the loose-bound fallback, and over fp8 keys
    it takes a bf16 Q (else it is dropped, as in the JAX function, whose
    further gate by on-chip memory is not ported). O is in `out_dtype`
    (default: q's dtype). On the card the kernels take a bf16 Q with d in
    {64, 128}; `flash_attention_forward.launches` counts their launches
    and `.form_launches` the same per form: "online", "bound", "kmajor",
    and "fallback" for the guarded online launch behind a checked bound
    call."""
    plan = _plan(q, k, v, scale, causal, window, kv_offset, block_sizes,
                 k_scale, v_scale, q_segment_ids, kv_segment_ids, softmax,
                 quantize_q)
    out_dtype = q.dtype if out_dtype is None else out_dtype
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
