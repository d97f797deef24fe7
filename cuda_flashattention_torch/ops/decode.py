"""Single-token decode attention over a (possibly quantized) KV cache.

Counterpart of cuda_flashattention_tpu/ops/decode.py (`decode_attention`).
On a CUDA tensor it launches the hand-written Hopper kernel of
csrc/decode.cu (one CTA per (split of the context, tile of up to 8 query
rows, KV head, batch), natural-exp online softmax, keys outside
[length − window, length) never attended, the splits merged in the same
launch). On a CPU tensor it runs `decode_attention_plain`, a dense PyTorch
version of the same numerics. `split_size`, `decode_splits`, `key_tile`,
`tile_runs` and `slice_keys` state the kernels' partition of the context
into splits and key tiles and the order in which each tile's keys are
added, which the paged kernel shares; `row_copy` states how a call's rows
reach the key slots (every shape runs the one walk).

Q may be bf16, fp16 or fp32 (two translation units of the kernel each:
csrc/decode.cu, decode_f16.cu, decode_f32.cu over the float and fp8
caches, their `_i8` units over the int8-K ones) and the head dim any d from
1 to 256: the kernel reads the cache in place at its own row width on the
build for the next of 16, 32, 64, 128 and 256 (lanes mask the columns
past d). The cache may be bf16, fp16, fp32, int8, fp8 e4m3 or mixed (int8
K, fp8 V), the quantized ones with per-token scales `k_scale`/`v_scale`
[B,Hkv,max_N]; `window` and per-sequence `windows` restrict attention to
the newest tokens; `quantize_q` runs Q·Kᵀ as an integer dot over an
int8-K cache; H/Hkv may be any size. `block_k` is the kernel's split size
C (keys per split of the context): any int from 1 on, clamped to the
cache's capacity (one split), as the JAX function clamps it
(`check_block_k`). Unset, `split_size` picks it (`default_decode_block_k`
is that rule under the JAX name).
"""

from __future__ import annotations

import numbers
from typing import List, Optional, Tuple

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import (
    ROUND_CODES,
    DECODE_HEAD_DIMS,
    NEG_INF,
    cdiv,
    quantize_q_per_head,
    resolve_scale,
    run_dim,
)

# storage type codes of the C interface (csrc/decode_body.cuh)
_TYPE_CODES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2,
               torch.float32: 3, torch.float16: 4}
_QUANT_PAIRS = ((1, 1), (2, 2), (1, 2))
_FLOATS = (torch.bfloat16, torch.float16, torch.float32)
# the q type of each translation unit's entry points (`_f16`, `_f32`)
_UNITS = {torch.bfloat16: "", torch.float16: "_f16", torch.float32: "_f32"}

# The split of the context shared by K6 and K7 (csrc/decode_body.cuh):
# keys per split at d = 128, eight of the tile walk's 32-key tiles, so that
# a CTA's ring of three stages runs full for most of its walk (the sweep
# of `utils/ab_kernels.py decode-sweep` at B=8 × Hkv=4 on an H100: 256
# keys beat 128 and 512 at 640 and at 4224 live keys); at d = 256 half as
# many keys, so a split reads as many bytes; at d <= 64 twice as many (the
# tiles there hold 64 or 128 keys and a key costs little); and the grid of
# B·Hkv·row tiles CTAs at which a call already fills the card (three
# tile-walk CTAs, up to ~70 KB of shared memory each, per SM of 132) and
# is walked unsplit.
SPLIT_KEYS = 256
SPLIT_FILL_CTAS = 396
NO_SPLIT = 1 << 30  # a split size no cache reaches: one split
# The tile walk (csrc/decode_body.cuh, TileWalk): its consumer threads,
# which score a tile's keys and add them; the K tile's byte budget.
TILE_CONSUMERS = 256
TILE_BYTES = 8192


def tile_rows(rows: int) -> int:
    """Query rows per CTA for `rows` rows per KV head: 1, 4 or 8, as
    csrc/decode_body.cuh's `tile_rows` picks them."""
    return 1 if rows == 1 else 4 if rows <= 4 else 8


def split_size(b: int, h_kv: int, row_tiles: int, d: int) -> int:
    """C, the keys of one split of a decode walk, from the call's shape
    alone (never from the cache's capacity or the lengths), so that the
    contiguous (K6) and the paged (K7) kernels split alike: unsplit once
    b·h_kv·row_tiles CTAs fill the card, else SPLIT_KEYS·128/max(d, 64)
    keys (256 at d = 128, 128 at d = 256, 512 at d ≤ 64)."""
    if b * h_kv * row_tiles >= SPLIT_FILL_CTAS:
        return NO_SPLIT
    return SPLIT_KEYS * 128 // max(d, 64)


def decode_splits(first: int, length: int, split: int,
                  capacity: int) -> List[Tuple[int, int, int]]:
    """(s, lo, hi) of each live split of a walk over keys [first, length)
    of a cache holding `capacity` keys per sequence, as the kernels' grid
    finds them: split s covers [s·split, (s+1)·split) ∩ [first, length);
    the grid's ceil(capacity / split) splits sit beyond every live one,
    so the partition is the key index's alone. Empty when no key is
    visible (split 0 then writes O = 0, LSE = NEG_INF)."""
    n = max(1, cdiv(capacity, split))
    out = []
    for s in range(n):
        lo, hi = max(first, s * split), min(length, (s + 1) * split)
        if lo < hi:
            out.append((s, lo, hi))
    return out


def key_tile(d: int, elem_bytes: int) -> int:
    """T, the keys of one tile of the tile walk at row width d over a
    cache of `elem_bytes`-byte elements (`geom` in csrc/decode_body.cuh):
    128 while a row of the build D (the next of DECODE_HEAD_DIMS) holds at
    most 64 bytes, else as many as fit TILE_BYTES of K (32 at d = 128 in
    bf16, 16 at d = 256, 8 for an fp32 cache at d = 256)."""
    slot = run_dim(d, DECODE_HEAD_DIMS) * elem_bytes
    return 128 if slot <= 64 else TILE_BYTES // slot


def key_slices(d: int) -> int:
    """The key slices of P·V at row width d: 2·TILE_CONSUMERS / D (each
    consumer thread owns two of the build D's columns)."""
    return 2 * TILE_CONSUMERS // run_dim(d, DECODE_HEAD_DIMS)


def tile_runs(lo: int, hi: int, tile: int,
              page: int = 0) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """The key tiles a CTA walks over split [lo, hi), in order: (t0, runs)
    for the tile of keys [t0, t0 + tile) (t0 a multiple of `tile`, so the
    tiles are the key index's alone), `runs` the (first, end) stretches of
    its live keys [max(lo, t0), min(hi, t0 + tile)) that the producer warp
    copies as consecutive rows: the whole live range for a contiguous cache
    (`page` 0), one stretch per page it touches for pools of `page`-token
    pages. Key j lands in slot j − t0 either way, so both walks hand the
    consumers the same slots."""
    out = []
    for t0 in range(lo // tile * tile, hi, tile):
        j0, j1 = max(lo, t0), min(hi, t0 + tile)
        if page <= 0:
            runs = [(j0, j1)]
        else:
            runs = [(max(j0, ip * page), min(j1, (ip + 1) * page))
                    for ip in range(j0 // page, (j1 - 1) // page + 1)]
        out.append((t0, runs))
    return out


def slice_keys(j0: int, j1: int, t0: int, d: int, ks: int) -> List[int]:
    """The live keys [j0, j1) of the tile at t0 that P·V's key slice `ks`
    adds, in its order: slots j − t0 ≡ ks (mod `key_slices(d)`); the
    slices' sums add in slice order once the walk is over."""
    return [j for j in range(j0, j1) if (j - t0) % key_slices(d) == ks]


def row_copy(d: int, k: torch.Tensor, v: torch.Tensor) -> int:
    """How the producer warp brings a call's K and V rows into the key
    slots (K6 and K7 alike; `copy_granularity` in csrc/decode_body.cuh):
    the bytes of one cp.async, 16, 8 or 4, the largest that divides the
    row's bytes (d · the element size) and both bases' addresses (at 16,
    TMA boxes where the layout allows); 0 where none does, for rows read
    as aligned words shifted into place: an odd d over a 2-byte cache (d =
    7, 91), d not a multiple of 4 over a one-byte one (d = 90 over int8),
    a cache view whose base is off 4 bytes. Each way fills the same slots,
    which the consumers read alike, so the result does not depend on it."""
    row = d * k.element_size()
    for g in (16, 8, 4):
        if row % g == 0 and k.data_ptr() % g == 0 and v.data_ptr() % g == 0:
            return g
    return 0


def entry_point(name: str, unit: str, k_code: int) -> str:
    """The C entry point of a call: `name` ("cfa_decode",
    "cfa_paged_decode") with the q type's unit suffix ("", "_f16",
    "_f32"), and "_i8" over an int8-K cache (code 1), whose builds are
    units of their own (csrc/*_i8.cu) so that no unit's nvcc outlasts the
    others by far."""
    return name + unit + ("_i8" if k_code == _TYPE_CODES[torch.int8] else "")


def default_decode_block_k(k_dtype, v_dtype, q_dtype, qq: bool, window: int,
                           has_windows: bool, max_n: int, *, batch: int = 1,
                           kv_heads: int = 1, rows: int = 1,
                           d: int = 128) -> int:
    """The split size a call with `block_k=None` runs at (the counterpart
    of the JAX rule, under its name and arguments): `split_size` for
    `batch` × `kv_heads` × the row tiles of `rows` query rows per KV head
    at head dim d, and `max_n`, one split, where that rule leaves the
    context unsplit. The types, `qq` and the windows do not enter it (the
    JAX rule's widths are TPU block sizes)."""
    del k_dtype, v_dtype, q_dtype, qq, window, has_windows
    split = split_size(batch, kv_heads, cdiv(rows, tile_rows(rows)), d)
    return max(1, min(split, max_n))


def check_block_k(block_k, capacity: int, what: str) -> int:
    """`block_k` as the decode kernels take it: a split size, clamped to
    the cache's capacity (one split holds every key), as the JAX function
    clamps its block to the cache. ValueError where the JAX function
    fails too: a block_k that is not an int (2.5, True, "8": the JAX
    grid takes only ints) or below 1 (0 divides by zero there, a
    negative one gives a negative grid)."""
    if isinstance(block_k, bool) or not isinstance(block_k, numbers.Integral):
        raise ValueError(f"{what}: block_k is the decode kernel's split size, "
                         f"an int, got {block_k!r}")
    if block_k < 1:
        raise ValueError(f"{what}: block_k is the decode kernel's split size, "
                         f"at least 1, got {block_k}")
    return min(int(block_k), max(1, capacity))


def split_scratch(b: int, h_kv: int, rows: int, d: int, capacity: int,
                  device, split: Optional[int] = None
                  ) -> Tuple[int, Optional[torch.Tensor],
                             Optional[torch.Tensor]]:
    """(split size, partials, tickets) of one kernel call, the scratch
    from the caching allocator on the current stream (the kernel's entry
    point zeroes the tickets there), or None when the grid has one split
    per row tile. `split`: the caller's split size (an explicit
    `block_k`), else `split_size`'s; the partials are sized from the one
    used."""
    r = tile_rows(rows)
    tiles = cdiv(rows, r)
    if split is None:
        split = split_size(b, h_kv, tiles, d)
    n = max(1, cdiv(capacity, split))
    if n == 1:
        return split, None, None
    part = torch.empty(b * h_kv * tiles * n * r * (d + 2),
                       dtype=torch.float32, device=device)
    tickets = torch.empty(b * h_kv * tiles, dtype=torch.int32, device=device)
    return split, part, tickets


def effective_windows(b: int, window: int, windows: Optional[torch.Tensor],
                      device) -> Optional[torch.Tensor]:
    """Per-sequence windows [B] int64, or None when nothing is windowed:
    `window` alone applies to every sequence, `windows` alone is honoured
    as it is (one ≥ its length means no window), and both together give
    min(windows[i], window)."""
    window = int(window or 0)
    if windows is None:
        if window <= 0:
            return None
        return torch.full((b,), window, dtype=torch.long, device=device)
    win = windows.to(device=device, dtype=torch.long).reshape(b)
    return win.clamp_max(window) if window > 0 else win


def decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: int = 0,
    windows: Optional[torch.Tensor] = None,
    quantize_q: bool = False,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense PyTorch version of the kernel's arithmetic, on any device
    (`block_k`, the kernel's split size, is taken and ignored: every
    split computes the same function).

    fp32 scores `(q · k_q) · scale · k_scale[j]` — under `quantize_q` on
    an int8-K cache `float(q8 · k8) · (σ_q·scale) · k_scale[j]`, the
    integer sum being exact in fp32 — with key j visible when
    length − win ≤ j < length; natural exp; l sums the unrounded P;
    `P · v_scale[j]` is rounded to the compute dtype (q's; bf16 under
    `quantize_q`) before it weights `v_q` with fp32 accumulation; O in q's
    dtype, LSE = m + ln l in fp32, and a sequence with no visible key
    gets O = 0 and LSE = NEG_INF."""
    del block_k
    b, h, d = q.shape
    h_kv, max_n = k.shape[1], k.shape[2]
    group = h // h_kv
    scale = resolve_scale(scale, d)
    quantized = k_scale is not None
    qq = bool(quantize_q) and quantized and k.dtype == torch.int8
    cd = torch.bfloat16 if qq else q.dtype
    zero = torch.zeros((), device=q.device)

    if qq:
        q8, sq = quantize_q_per_head(q, (-1,))  # sq [B,H,1]
        s = torch.einsum("bhgd,bhkd->bhgk",
                         q8.float().view(b, h_kv, group, d), k.float())
        s = s * (sq * scale).view(b, h_kv, group, 1)
    else:
        # q · k on exactly upcast operands, as JAX promotes them (a
        # quantized cache's codes are exact in any float type)
        s = torch.einsum("bhgd,bhkd->bhgk",
                         q.float().view(b, h_kv, group, d),
                         k.float()) * scale
    if quantized:
        s = s * k_scale.float()[:, :, None, :]
    cols = torch.arange(max_n, device=q.device)[None, :]
    lens = lengths.to(q.device).view(b, 1).long()
    live = cols < lens
    win = effective_windows(b, window, windows, q.device)
    if win is not None:
        live = live & (cols >= lens - win.view(b, 1))
    live = live[:, None, None, :]
    s = torch.where(live, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m), zero)
    l = p.sum(dim=-1, keepdim=True)
    if quantized:
        # rows past the live context may hold anything, NaN included
        p = torch.where(live, p * v_scale.float()[:, :, None, :], zero)
    vf = torch.where(live[:, :, 0, :, None], v.float(), zero)
    pv = torch.einsum("bhgk,bhkd->bhgd", p.to(cd).float(), vf)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    o = torch.where(empty, zero, pv / l_safe)
    lse = torch.where(empty, torch.full_like(l, NEG_INF),
                      m + torch.log(l_safe))
    return o.reshape(b, h, d).to(q.dtype), lse.reshape(b, h)


def kernel_inputs(q, k, v, k_scale, v_scale, windows, quantize_q, scale,
                  what: str):
    """Check and prepare what the contiguous and the paged decode kernels
    share. Returns (q or its int8 codes, q_sigma or None, k, v, k_scale,
    v_scale, windows int32 or None, k code, v code, qq, unit, p_round):
    `unit` the entry points' suffix of the q type they are built for ("",
    "_f16", "_f32"), whose type O comes in, and `p_round` the fp32 unit's
    rounding of P. A bf16 or fp16 q over a cache of its type, or over
    one-byte codes, runs its own unit; an fp32 q the fp32 unit over any
    float cache or the codes; a bf16 or fp16 q over another float cache
    (fp32, or the other 2-byte type) the fp32 unit on q upcast exactly,
    P rounded to q's type (JAX's promotion). K and V of two float types
    are upcast to fp32 (a copy of the cache per call)."""
    d = q.shape[-1]
    if run_dim(d, DECODE_HEAD_DIMS) is None:
        raise ValueError(
            f"the CUDA {what} takes d from 1 to {max(DECODE_HEAD_DIMS)} "
            f"(read in place on the build for the next of "
            f"{DECODE_HEAD_DIMS}), got {d}")
    if q.dtype not in _FLOATS:
        raise NotImplementedError(
            f"the CUDA {what} takes a bf16, fp16 or fp32 q, got {q.dtype}")
    quantized = k_scale is not None
    pair = (_TYPE_CODES.get(k.dtype), _TYPE_CODES.get(v.dtype))
    floats = k.dtype in _FLOATS and v.dtype in _FLOATS
    if (pair in _QUANT_PAIRS) != quantized or not (quantized or floats):
        raise NotImplementedError(
            f"the CUDA {what} takes a bf16, fp16 or fp32 cache without "
            f"scales, or an int8, fp8 or int8-K/fp8-V cache with scales; "
            f"got k {k.dtype} v {v.dtype}, scales "
            f"{'given' if quantized else 'absent'}")
    for name, x in (("k", k), ("v", v), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if x is None:
            continue
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"the CUDA {what} reads a contiguous {name}")
    if quantized:
        if k_scale.shape != k.shape[:-1] or v_scale.shape != v.shape[:-1]:
            raise ValueError(
                f"scales {tuple(k_scale.shape)}/{tuple(v_scale.shape)} do "
                f"not match the cache {tuple(k.shape)}")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise ValueError("per-token scales must be fp32")
    elif k.dtype != v.dtype:
        k, v = k.float(), v.float()
        pair = (_TYPE_CODES[torch.float32],) * 2
    qq = bool(quantize_q) and quantized and k.dtype == torch.int8
    unit, p_round = _UNITS[q.dtype], 0
    if not quantized and k.dtype != q.dtype and q.dtype != torch.float32:
        unit, p_round = _UNITS[torch.float32], ROUND_CODES[q.dtype]
        q = q.float()
    q_sigma = None
    if qq:
        q, sq = quantize_q_per_head(q, (-1,))
        q_sigma = (sq * resolve_scale(scale, d)).reshape(q.shape[:-1])
        q_sigma = q_sigma.contiguous()
    if windows is not None:
        windows = windows.to(device=q.device, dtype=torch.int32).reshape(
            q.shape[0]).contiguous()
    return (q.contiguous(), q_sigma, k, v, k_scale, v_scale, windows, *pair,
            qq, unit, p_round)


# the O type of each unit's kernels
UNIT_DTYPES = {u: t for t, u in _UNITS.items()}


def optional_ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    """The tensor's address for the C interface, or None (a null pointer)
    for an absent optional argument."""
    return None if x is None else x.data_ptr()


def _decode_cuda(q, k, v, lengths, k_scale, v_scale, scale, window, windows,
                 quantize_q, block_k=None):
    b, h, d = q.shape
    h_kv, max_n = k.shape[1], k.shape[2]
    out_dtype = q.dtype
    q, q_sigma, k, v, k_scale, v_scale, windows, kt, vt, qq, unit, p_round = (
        kernel_inputs(q, k, v, k_scale, v_scale, windows, quantize_q, scale,
                      "decode"))
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} != ({b},)")
    o = torch.empty((b, h, d), dtype=UNIT_DTYPES[unit], device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        split, part, tickets = split_scratch(b, h_kv, h // h_kv, d, max_n,
                                             q.device, block_k)
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(),
                      entry_point("cfa_decode", unit, kt))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            optional_ptr(k_scale), optional_ptr(v_scale),
            optional_ptr(q_sigma), lengths.data_ptr(), optional_ptr(windows),
            o.data_ptr(), lse.data_ptr(), optional_ptr(part),
            optional_ptr(tickets), b, h, h_kv, max_n, d, kt, vt, int(qq),
            p_round, resolve_scale(scale, d), int(window or 0), split,
            stream)
    _build.check(err, "decode_attention kernel launch")
    decode_attention.launches += 1
    return o.to(out_dtype), lse


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_k: Optional[int] = None,
    window: int = 0,
    windows: Optional[torch.Tensor] = None,
    quantize_q: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: q [B,H,d] attends to cache k/v [B,Hkv,max_N,d].

    `lengths` [B] int gives each sequence's live context; cache rows at or
    past it are neither read nor attended. A quantized cache (int8, fp8
    e4m3, or int8 K with fp8 V) passes its per-token scales
    [B,Hkv,max_N] fp32.

    `window` > 0 restricts attention to the last `window` live tokens;
    cache rows before them are not read. `windows` [B] int gives
    per-sequence windows (one ≥ its length means none). With both, each
    effective window is min(windows[i], window).

    `quantize_q=True` quantizes Q per (batch, head) to int8 and runs Q·Kᵀ
    as an exact integer dot, on an int8-K cache only (int8 or mixed); an
    fp8-K or unquantized cache ignores the flag.

    Returns (o [B,H,d] in q's dtype, lse [B,H] fp32). On the card the
    kernel takes a bf16, fp16 or fp32 q, any d from 1 to 256 (the cache
    read as it lies, never copied, but for K and V of two float types),
    and a bf16, fp16 or fp32 cache or an int8, fp8 or int8-K/fp8-V one; P
    weights V rounded to q's dtype (unrounded for an fp32 q; bf16 under
    `quantize_q`), as in the JAX body, whose compute dtype is q's (a q
    over a float cache of another type runs the fp32 build on q upcast,
    `kernel_inputs`). `block_k`: the split size
    (module docstring; clamped to the capacity); every size gives the
    same result up to the order of the splits' merge. Every shape runs
    the one walk (rows that no cp.async can take, `row_copy` 0, come in
    by shifted loads into the same slots; a launch error raises). The
    count of its launches is `decode_attention.launches`."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,d] and k/v [B,Hkv,N,d], got q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2]:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if block_k is not None:
        block_k = check_block_k(block_k, k.shape[2], "decode_attention")
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, lengths, k_scale=k_scale, v_scale=v_scale, scale=scale,
            window=window, windows=windows, quantize_q=quantize_q)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _decode_cuda(q, k, v, lengths, k_scale, v_scale, scale, window,
                        windows, quantize_q, block_k)


decode_attention.launches = 0
