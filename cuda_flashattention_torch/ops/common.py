"""Shared helpers of the attention ops (counterpart of
cuda_flashattention_tpu/ops/common.py, without its TPU-only parts: the
VMEM arithmetic of its block-size heuristic, interpret-mode selection and
the fp8 bit casts, which Hopper's hardware conversion of e4m3 makes
needless).

`BlockSizes` keeps the JAX fields, and `BUILT_TILES` states the tiles
each CUDA kernel is compiled for: a tile is a build on the card, not a
run-time size. A requested tile that no build has runs at the largest
built tile of that kernel not above it (the smallest where none is), as
the JAX kernels take any tile and a tile only sets their speed
(`check_tiles`); on the CPU the plain versions ignore the tile (every
tile computes the same function)."""

from __future__ import annotations

import dataclasses
import math
import numbers
from typing import Dict, Optional, Tuple

import torch

# A finite stand-in for -inf: exp(x - NEG_INF) == 0 in fp32 while avoiding
# inf - inf = nan in the running-max updates. Empty rows report it as LSE.
NEG_INF = -1e30

# Head dims the CUDA kernels are instantiated for, by family, each in bf16,
# fp16 and fp32: the forward (K1, K1b, K5: csrc/flash_fwd*.cu); the backward
# (K2, K3, K4 and its prologue); FA1 (K8: csrc/fa1.cu); the device ring
# (K9: csrc/device_ring.cu); decode (K6, K7: csrc/decode_body.cuh), which
# reads any d up to its largest build in place on the next build up. The
# forward, backward, FA1 and ring families run a narrower d on zero-padded
# heads (`pad_heads`; the ring pads its own x and W).
FWD_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)
FA1_HEAD_DIMS = (64, 128, 256)
RING_HEAD_DIMS = (64, 128, 256)
DECODE_HEAD_DIMS = (16, 32, 64, 128, 256)
# the head dims of the forward's fp32-Q builds (F32, BF16KV and over
# one-byte K/V)
FWD_F32_HEAD_DIMS = (64, 128, 256)


def run_dim(d: int, dims: Tuple[int, ...] = FWD_HEAD_DIMS) -> Optional[int]:
    """The build of `dims` a head dim d runs on: the smallest not below d,
    or None past the largest (and for d < 1)."""
    return next((x for x in dims if d <= x), None) if d >= 1 else None


# The forward kernels' query tile (K1, K1b, K5: two warpgroups of 64 rows
# of packed heads) and their key tiles: 64 everywhere, 128 in the bf16
# builds of K1 and K1b at d <= 128 (csrc/flash_fwd.cu,
# csrc/flash_fwd_bound.cu), and 32 for an fp32 Q over fp32 K/V at d = 256
# (`fwd_key_tile`: a 64-key split K + V stage, 128 KB, does not fit beside
# the 128 KB split Q tile). K5 keeps `block_k` = tile · span keys resident
# (a span of key tiles, up to what its shared memory holds beside its Q
# ring; fp32 tiles are split in two bf16 tiles, and an fp32 Q over bf16 or
# one-byte K/V keeps exact bf16 K/V tiles beside a split Q ring:
# csrc/flash_fwd_kmajor.cu) where its build takes an fp32 Q. Under a
# 2-byte or int8 Q, K5 runs K1b's Q-major walk over 2-byte K/V, and over
# one-byte K/V wherever that walk's grid fills the card (`kmajor_q_walk`),
# so its `block_k` names K1b's key tile; below that, over one-byte K/V,
# its key split keeps the span the rule picks (`kmajor_span`) on tiles of
# the same 64 keys.
FWD_BLOCK_Q = 128
KMAJOR_TILE = 64
# (at d = 256 a span of one tile: under an fp32 Q one tile pair beside
# one split 128 KB Q tile; a 2-byte or int8 Q always takes the Q-major
# walk there)
KMAJOR_MAX_SPAN = {64: 8, 128: 4, 256: 1}
KMAJOR_MAX_SPAN_F32 = {64: 4, 128: 1, 256: 1}
KMAJOR_MAX_SPAN_F32Q = {64: 8, 128: 3, 256: 1}
# K2 and K4's pair (csrc/flash_bwd_kv.cu: 128-key CTAs stream 64-row Q
# tiles; 64-key CTAs at d = 256, streaming 32-row tiles in fp32); K3 runs
# at its own tile (128 rows, 64 keys; 32 in fp32 and at d = 256; 64 rows
# and 16 keys in fp32 at d = 256) under it
BWD_BLOCK_Q, BWD_BLOCK_K = 64, 128
BWD_BLOCK_K_WIDE = 64
BWD_BLOCK_Q_WIDE_F32 = 32
# Below this many query rows "auto" keeps unquantized causal forwards on
# the online softmax (K1), as the JAX function does; past it they take
# the bound softmax on the K-major walk (K5).
ONLINE_SHORT_NQ = 5120

# Operand types of the table: "bf16" (bf16 Q, K, V, dO), "fp16" (fp16
# ones: the fp16 units' builds, bf16's tiles), "fp32" (fp32 ones, and the
# mixed float types a call upcasts to them), "codes" (one-byte K/V: int8,
# fp8 or int8 K with fp8 V, under a bf16 Q), "fp16/codes" and "fp32/codes"
# (the same under an fp16 or fp32 Q) and "fp32/bf16" (an fp32 Q, or an
# fp16 one upcast, over bf16 K/V).
TILE_TYPES = ("bf16", "fp16", "fp32", "codes", "fp16/codes", "fp32/codes",
              "fp32/bf16")
# the 2-byte operand types, whose builds share their tiles
HALF_TYPES = ("bf16", "fp16")
# round_to's codes of the fp32 builds (csrc/flash_fwd_bound_sm90.cuh): the
# type a mixed-type call's P (or dS) is rounded to before a product, as
# JAX rounds it; 0 for fp32, which leaves it as it is
ROUND_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fwd_key_tile(ty: str, d: int) -> int:
    """The key tile of the forward builds (K1, K1b, K5) over operands of
    type `ty` at head dim d that takes the 64-key tile's place: 32 for an
    fp32 Q over fp32 K/V at d = 256, 64 everywhere else."""
    return 32 if ty == "fp32" and d == 256 else KMAJOR_TILE


def _kmajor_tiles(spans: Dict[int, int], ty: str,
                  d: int) -> Tuple[int, ...]:
    return tuple(fwd_key_tile(ty, d) * s for s in range(1, spans[d] + 1))


# (kernel, operand type, head dim the kernel runs at) -> (block_q choices,
# block_k choices): the tiles each kernel is built for. The wrappers
# validate a request against it; utils/autotune.py enumerates it. At d =
# 256 the forward keeps 64-key tiles (32 for an fp32 Q over fp32 K/V), and
# K2 / K4 take 64-key CTAs (streaming 32-row Q tiles in fp32).
BUILT_TILES: Dict[Tuple[str, str, int], Tuple[Tuple[int, ...],
                                              Tuple[int, ...]]] = {
    **{(kn, ty, d): ((FWD_BLOCK_Q,),
                     (64, 128) if ty in HALF_TYPES and d < 256
                     else (fwd_key_tile(ty, d),))
       for kn in ("K1", "K1b") for ty in TILE_TYPES for d in FWD_HEAD_DIMS
       if d in FWD_F32_HEAD_DIMS or not ty.startswith("fp32")},
    # K5 under a 2-byte or int8 Q: K1b's tiles (its Q-major walk)
    **{("K5", ty, d): ((FWD_BLOCK_Q,),
                       (64, 128) if ty in HALF_TYPES and d < 256 else (64,))
       for ty in ("bf16", "fp16", "codes", "fp16/codes")
       for d in FWD_HEAD_DIMS},
    **{("K5", ty, d): ((FWD_BLOCK_Q,), _kmajor_tiles(spans, ty, d))
       for ty, spans in (("fp32", KMAJOR_MAX_SPAN_F32),
                         ("fp32/codes", KMAJOR_MAX_SPAN_F32Q),
                         ("fp32/bf16", KMAJOR_MAX_SPAN_F32Q))
       for d in spans},
    **{(kn, ty, d): ((BWD_BLOCK_Q_WIDE_F32 if (ty, d) == ("fp32", 256)
                      else BWD_BLOCK_Q,),
                     (BWD_BLOCK_K_WIDE if d == 256 else BWD_BLOCK_K,))
       for kn in ("K2", "K4") for ty in ("bf16", "fp16", "fp32")
       for d in BWD_HEAD_DIMS},
}


def tile_type(q_dtype: torch.dtype, k_dtype: torch.dtype,
              v_dtype: Optional[torch.dtype] = None) -> str:
    """The operand type of a forward call, as `BUILT_TILES` names it: its
    own 2-byte or fp32 type where Q, K and V share one; over one-byte
    codes Q's; and where the float types differ, the fp32 builds the call
    is upcast to (`fwd_operands`): over bf16 K/V "fp32/bf16", else
    "fp32"."""
    v_dtype = k_dtype if v_dtype is None else v_dtype
    if k_dtype.itemsize == 1:
        return {torch.float32: "fp32/codes",
                torch.float16: "fp16/codes"}.get(q_dtype, "codes")
    if q_dtype == k_dtype == v_dtype:
        return {torch.float32: "fp32", torch.float16: "fp16"}.get(q_dtype,
                                                                  "bf16")
    return "fp32/bf16" if k_dtype == v_dtype == torch.bfloat16 else "fp32"


def bwd_tile_type(*dtypes: torch.dtype) -> str:
    """The operand type of a backward call (q, k, v, dO): "bf16" or
    "fp16" where all four share it, else "fp32" (fp32 operands, and mixed
    ones, which run the fp32 builds upcast)."""
    if len(set(dtypes)) == 1 and dtypes[0] in (torch.bfloat16,
                                               torch.float16):
        return "bf16" if dtypes[0] == torch.bfloat16 else "fp16"
    return "fp32"


def tile_dim(kernel: str, d: int) -> Optional[int]:
    """The head dim `kernel` runs a call of head dim d at (narrower heads
    run padded, `pad_heads`), or None past its family's builds."""
    return run_dim(d, FWD_HEAD_DIMS if kernel in ("K1", "K1b", "K5")
                   else BWD_HEAD_DIMS)


def built_tiles(kernel: str, ty: str,
                d: int) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """(block_q choices, block_k choices) of `kernel` over operands of type
    `ty` at head dim d (narrow heads run padded, `pad_heads`), or None
    where no build takes that type at d (a forward type the backward
    never sees, or d past 256)."""
    return BUILT_TILES.get((kernel, ty, tile_dim(kernel, d)))


def nearest_built(requested, built: Tuple[int, ...]) -> int:
    """The built tile a request runs at: the largest of `built` not above
    `requested`, or the smallest of them where none is."""
    below = [t for t in built if t <= requested]
    return max(below) if below else min(built)


# (kernel, operand type, head dim, requested pair, built pair) of every
# mapping already logged
_LOGGED_MAPPINGS = set()


def check_tiles(kernel: str, ty: str, d: int, block_sizes, what: str,
                bwd: bool = False) -> int:
    """The key tile `kernel` runs at for `block_sizes` (the backward's pair
    with `bwd`): a (block_q, block_k) pair the kernel is built for over
    operands of type `ty` at head dim d is kept, any other number is
    mapped field by field to `nearest_built` (the JAX kernels take any
    tile: a tile sets their speed, not their result), and each mapping is
    logged once. TypeError when `block_sizes` has not the four fields of
    `BlockSizes`, or a field is not a real number, which the JAX functions
    refuse too (the JAX class has the fields). None, with no mapping,
    where no build of `kernel` takes `ty` at d (`built_tiles`): the plain
    version ignores the tile and the card refuses the call."""
    names = ("block_q_bwd", "block_k_bwd") if bwd else ("block_q", "block_k")
    try:
        requested = tuple(getattr(block_sizes, n) for n in names)
    except AttributeError:
        raise TypeError(f"{what}: expected a BlockSizes (fields block_q, "
                        f"block_k, block_q_bwd, block_k_bwd), got "
                        f"{block_sizes!r}") from None
    for n, x in zip(names, requested):
        if isinstance(x, bool) or not isinstance(x, numbers.Real):
            raise TypeError(f"{what}: {n} must be a number, got {x!r}")
    built = built_tiles(kernel, ty, d)
    if built is None:
        return None
    qs, ks = built
    used = (nearest_built(requested[0], qs), nearest_built(requested[1], ks))
    if used != requested:
        key = (kernel, ty, tile_dim(kernel, d), requested, used)
        if key not in _LOGGED_MAPPINGS:
            _LOGGED_MAPPINGS.add(key)
            from cuda_flashattention_torch.utils.log import get_logger
            get_logger(__name__).info(
                "%s: the CUDA kernel %s over %s operands at d=%d is built "
                "for %s in %s and %s in %s; (%s, %s) runs as (%s, %s)",
                what, kernel, ty, key[2], names[0], qs, names[1], ks,
                *requested, *used)
    return used[1]


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile sizes of the attention kernels, under the JAX fields: the
    forward's query and key tiles, and the backward's (the 64-row Q tiles
    that K2 / K4 stream past each 128-key CTA, 64-key at d = 256, where
    the fp32 build streams 32-row tiles). The
    defaults are the card's default tiles; `BUILT_TILES` lists every other
    choice. On the card a tile is a template instance, not a run-time
    size: any built tile runs any problem size (the kernels mask the
    ragged tail)."""

    block_q: int = FWD_BLOCK_Q
    block_k: int = 64
    block_q_bwd: int = BWD_BLOCK_Q
    block_k_bwd: int = BWD_BLOCK_K

    def with_bwd_like(self, nq: int, nk: int) -> "BlockSizes":
        """The JAX version shrinks the backward's tiles with a small
        problem; the card's backward has one built pair, which runs any
        size, so it is the one kept."""
        del nq, nk
        return dataclasses.replace(self, block_q_bwd=BWD_BLOCK_Q,
                                   block_k_bwd=BWD_BLOCK_K)

    def clamp(self, nq: int, nk: int) -> "BlockSizes":
        """The JAX version shrinks each tile to the problem. A built tile
        runs a problem smaller than itself masked, and a shrunk tile need
        not be built, so nothing changes: the kernels map the request as
        they would have (`check_tiles`)."""
        del nq, nk
        return self


def kmajor_span(b: int, h_kv: int, nk: int, d: int, sms: int,
                f32: bool = False, exact_kv: bool = False) -> int:
    """Key tiles per K5 CTA: the longest span the CTA can keep resident
    (`f32`: in its build for an fp32 Q, over fp32 K/V or, `exact_kv`,
    over K/V that are exact bf16 tiles: one-byte codes or bf16) whose
    grid (one CTA per span, KV head and batch) still holds two waves of
    `sms` CTAs; 1, the most CTAs, when none does. Longer spans add each
    query row's partial sums fewer times. An fp32 Q over exact K/V takes
    the longest span whatever the grid: its producer reads and splits
    every Q tile once per span, which a short span repeats
    (`utils/kmajor_spans.py` times each span)."""
    d = run_dim(d)
    tiles = cdiv(nk, KMAJOR_TILE)
    if f32 and exact_kv:
        return KMAJOR_MAX_SPAN_F32Q.get(d, 1)
    longest = (KMAJOR_MAX_SPAN_F32 if f32 else KMAJOR_MAX_SPAN).get(d, 1)
    for span in range(longest, 1, -1):
        if cdiv(tiles, span) * h_kv * b >= 2 * sms:
            return span
    return 1


def kv_converted(d: int, q_f32: bool, quantized: bool) -> bool:
    """Whether the bound forward (K1b, K5) at run dim d converts one-byte
    K/V to exact 2-byte copies in a pass of its own before its walk (the
    PRE builds of csrc/flash_fwd_bound_sm90.cuh, `pre_converted`): at d =
    256 under a 2-byte Q or quantize_q's int8 Q (`q_f32` false: the
    entry points' code 0); the fp32-Q builds and d <= 128 convert each key
    tile in shared memory."""
    return quantized and not q_f32 and d == 256


def packed_heads(group: int) -> int:
    """Query heads of one KV head that a 128-row tile of the forward packs
    (csrc/flash_fwd_bound_sm90.cuh::packed_heads): the largest divisor of
    the group size up to 16."""
    return max(g for g in range(1, min(group, 16) + 1) if group % g == 0)


def q_major_grid(b: int, h: int, h_kv: int, nq: int) -> int:
    """CTAs of the Q-major walk (K1, K1b): a 128-row tile of Gp packed
    heads, R = 128 / Gp positions each, per (Q tile, head group, batch)."""
    gp = packed_heads(h // h_kv)
    return cdiv(nq, FWD_BLOCK_Q // gp) * (h // gp) * b


# The crossing of K5's two walks under a 2-byte or int8 Q at d <= 128 over
# one-byte K/V: the Q-major walk once its grid holds this share of a wave
# of CTAs. It lies between 64 and 128 CTAs (PERF.md §6: a sweep of
# one 512-row chunk per sequence over a 16384-token fp8 cache: at B=1, 64
# CTAs, the Q-major walk takes 0.45 ms against the key split's 0.31; at
# B=2, 128 CTAs, 0.45 against 0.50; at B=8 1.76 against 1.89). Over 2-byte
# K/V the Q-major walk led at every grid measured, 64 CTAs and up (the
# same call: 0.22 against 0.28 ms at B=1 over a bf16 cache, 0.013 against
# 0.069 at [1, 16/4, 512, 128] causal), so no 2-byte K/V take the split.
KMAJOR_Q_WALK_MIN_WAVES = 0.75


def kmajor_q_walk(d: int, q_f32: bool, *, b: int, h: int, h_kv: int,
                  nq: int, sms: int, codes: bool = False) -> bool:
    """Whether K5 at run dim d runs K1b's Q-major walk (through K1b's
    entry point: no key split, no partial sums or finalise, no zeroed
    scratch; its O does not vary from run to run) rather than its key
    split: under a 2-byte or int8 Q (`q_f32` false), over 2-byte K/V and
    at d = 256 always (no span longer than one 64-key tile fits there),
    and over one-byte K/V (`codes`) at d <= 128 where the Q-major grid
    (`q_major_grid`) holds `KMAJOR_Q_WALK_MIN_WAVES` of a wave of `sms`
    CTAs. A rule on shapes alone. The fp32-Q builds keep the key split."""
    if q_f32:
        return False
    return (d == 256 or not codes
            or q_major_grid(b, h, h_kv, nq) >= KMAJOR_Q_WALK_MIN_WAVES * sms)


def kv_copy_bytes(b: int, h_kv: int, nk: int, d: int, *, qq: bool,
                  k_int8: bool) -> Tuple[int, int]:
    """Bytes of the copies of K and V that a `kv_converted` call writes
    before its walk ([B,Hkv,Nk,d] each): V as 2-byte values; K as 2-byte
    values, or under quantize_q as int8 codes (re-gridded from e4m3), and
    none under quantize_q over int8 keys, whose codes the walk reads."""
    n = b * h_kv * nk * d
    return (0 if qq and k_int8 else n if qq else 2 * n), 2 * n


def auto_block_sizes(nq: int, nk: int, d: int, causal: bool = False,
                     fp8: bool = False, *, batch: int = 1,
                     kv_heads: int = 1, sms: int = 132,
                     f32: bool = False) -> BlockSizes:
    """The tiles the card's kernels take when a call names none: 128
    query rows and 64 keys, the backward's (64, 128), and, where "auto"
    routes an fp32 Q (`f32`) to the K-major walk K5 (fp8 keys, or causal
    past `ONLINE_SHORT_NQ` rows), block_k = 64 · `kmajor_span` for `batch`
    × `kv_heads` over an H100's 132 SMs. Under a 2-byte Q, K5's `block_k`
    is K1b's key tile (64 by default). None of the JAX version's VMEM
    arithmetic applies."""
    block_k = 64
    if f32 and (fp8 or (causal and nq > ONLINE_SHORT_NQ)):
        block_k = KMAJOR_TILE * kmajor_span(batch, kv_heads, nk, d, sms, f32,
                                            fp8)
    return BlockSizes(block_k=block_k)


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def resolve_scale(scale: Optional[float], d: int) -> float:
    """Softmax scale: 1/sqrt(d) unless given."""
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def resolve_device(device=None) -> torch.device:
    """The device an entry point allocates on: `None` means the card (the
    current CUDA device), and raises RuntimeError when there is none —
    it never falls back to the CPU. Ask for the CPU with `device="cpu"`."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present: this allocates on the card by "
            "default; pass device=\"cpu\" to allocate on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def pad_heads(what: str, *xs: Optional[torch.Tensor],
              dims: Tuple[int, ...] = FWD_HEAD_DIMS):
    """A kernel family's head dim for these tensors (their last dim d,
    which they share) and the tensors as its kernels take them: d itself
    when a build has it (`dims`: the forward's `FWD_HEAD_DIMS`, the
    backward's `BWD_HEAD_DIMS`, K8's `FA1_HEAD_DIMS`), with no
    copy; else, for any d from 1 to the largest build, each tensor copied
    with zero columns up to the next build. Zero columns of Q and K add
    nothing to a score, nor to a row norm or an absmax; zero columns of V
    and dO give zero columns of O, dQ, dK and dV, which the caller slices
    away. The softmax scale must be resolved from d before
    (`resolve_scale`).
    Returns (d_run, [tensors]), None kept as None; ValueError past the
    largest build."""
    d = next(x for x in xs if x is not None).shape[-1]
    if d in dims:
        return d, list(xs)
    d_run = run_dim(d, dims)
    if d_run is None:
        raise ValueError(
            f"the CUDA {what} takes d from 1 to {max(dims)} (builds at "
            f"{dims}; a narrower d runs at the next of them with zero "
            f"columns), got {d}")
    padded = []
    for x in xs:
        if x is not None:
            out = x.new_zeros((*x.shape[:-1], d_run))
            # one-byte codes (fp8) are copied as bytes
            if x.element_size() == 1:
                out.view(torch.uint8)[..., :d] = x.view(torch.uint8)
            else:
                out[..., :d] = x
            x = out
        padded.append(x)
    return d_run, padded


def quantize_q_per_head(q: torch.Tensor,
                        axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-head absmax int8 quantisation of Q for the integer Q·Kᵀ path
    (`quantize_q`): absmax over `axes`, sigma = max(absmax, 1e-12) / 127,
    codes round(q / sigma) (half to even) clipped to ±127. Returns
    (q_int8, sigma fp32, broadcastable against q)."""
    qf = q.float()
    sq = qf.abs().amax(dim=axes, keepdim=True).clamp_min(1e-12) / 127.0
    q8 = torch.clamp(torch.round(qf / sq), -127, 127).to(torch.int8)
    return q8, sq


def check_qkv(q, k, v) -> None:
    """Raise ValueError unless q [B,H,Nq,d] and k/v [B,Hkv,Nk,d] fit
    together, with Hkv dividing H (GQA)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected [B,H,N,d] inputs, got q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or (
            k.shape[3] != q.shape[3]):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")


def kernel_operand(x):
    """Tensor x as the attention kernels read it: unit stride on d and
    16-byte aligned rows (every other stride a multiple of the elements in
    16 bytes: 8 for bf16, 16 for int8 and fp8). Copies only when x is
    not."""
    vec = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % vec == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()
