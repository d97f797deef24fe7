"""FlashAttention-2 backward: host function, CUDA kernel launches, plain
version.

Counterpart of cuda_flashattention_tpu/ops/flash_bwd.py
(`flash_attention_backward`). On a CUDA tensor it launches the
hand-written Hopper kernels: the fused single pass K4 (dK/dV per 128-key
tile, dQ added into an fp32 buffer by TMA reduces) by default, or the
split pair K2 (dK/dV) + K3 (dQ) with `fused=False`, on bf16, fp16 or
fp32 inputs (the fp16 builds are the `_f16` entry points; each kernel's
fp32 build splits every tile into bf16 hi and lo parts), or inputs of
mixed float types upcast to the fp32 builds, which round P and dS where
JAX rounds them (`ROUND_CODES`), at d up to 256 (at d = 256 64-key
tiles, the two warpgroups splitting d, dQ added by atomics; in fp32 there
K2 / K4 stream 32-row Q tiles and K3 walks 16-key tiles with 64-row
CTAs). K2 and K4 are one
wgmma + TMA kernel (csrc/flash_bwd_kv.cu), K3 the Q-major wgmma + TMA
kernel of csrc/flash_bwd.cu. On a CPU tensor it runs
`flash_attention_backward_plain`, a dense PyTorch version of the same
numerics; the CPU tests and the on-card comparisons use it.

D = rowsum(dO ⊙ O) and the zeroing of K4's fp32 dQ accumulator are the
work of a hand-written prologue kernel (`cfa_bwd_delta` in
csrc/flash_bwd_kv.cu: the `_delta` and `_init_dq` steps of the JAX fused
kernel's `fuse_delta` form), one launch before K4 or K2 + K3 that reads
each row of O and dO once; K2, K3 and K4 read its D. Its plain version
is the PyTorch reduction of `flash_attention_backward_plain`.

Masks are the forward's: causal with `kv_offset`, a sliding `window`,
segment ids and the ragged tail. `block_sizes` names the backward's
tiles (`block_q_bwd`, `block_k_bwd`): K2 and K4 are built for (64, 128)
only ((64, 64) at d = 256, (32, 64) there in fp32), and K3 runs at its
own tile under that pair;
any other pair runs at that one (`ops.common.check_tiles` logs the
mapping once), as the JAX kernels take any tile.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import (
    BWD_BLOCK_K,
    BWD_BLOCK_K_WIDE,
    BWD_BLOCK_Q,
    BWD_BLOCK_Q_WIDE_F32,
    BWD_HEAD_DIMS,
    NEG_INF,
    ROUND_CODES,
    bwd_tile_type,
    cdiv,
    check_qkv,
    check_tiles,
    kernel_operand,
    packed_heads,
    pad_heads,
    resolve_scale,
    run_dim,
)

_LOG2E = 1.4426950408889634

# K2/K4's tiles (csrc/flash_bwd_kv.cu): a CTA owns BK keys, two warpgroups
# of 64 (64 keys, both warpgroups, at d = 256), and streams the query rows
# that see them BQ at a time (32 in the fp32 d = 256 build)
_BWD_BK = BWD_BLOCK_K
_BWD_BQ = BWD_BLOCK_Q


def _bwd_key_tile(d: int) -> int:
    """Keys of a K2/K4 CTA for a call of head dim d: 128, or 64 where the
    call runs on a d = 256 build."""
    return BWD_BLOCK_K_WIDE if run_dim(d, BWD_HEAD_DIMS) == 256 else _BWD_BK


def _bwd_q_tile(d: int, f32: bool = False) -> int:
    """Query rows of a K2/K4 stage for a call of head dim d (`f32`: fp32
    operands): 64, or 32 where an fp32 call runs on the d = 256 build."""
    wide = run_dim(d, BWD_HEAD_DIMS) == 256
    return BWD_BLOCK_Q_WIDE_F32 if f32 and wide else _BWD_BQ


def _bwd_q_tiles(c0: int, nq: int, nk: int, causal: bool, window: int,
                 kv_offset: int, bk: int = _BWD_BK,
                 bq: int = _BWD_BQ) -> Tuple[int, int]:
    """The `bq`-row Q tiles [first, last] that the K2/K4 CTA of the
    `bk`-key tile at c0 walks (for each query head of its group), as the
    kernel's `q_tiles` computes them: causal rows see keys <= row +
    kv_offset, so the first tile holds row c0 − kv_offset (none when that
    row lies past nq); with a window the last row that reaches the tile's
    last key is that key − kv_offset + window − 1. Empty when first >
    last. Exactly the tiles with a visible pair (segment ids aside, which
    mask inside the walk)."""
    first, last = 0, cdiv(nq, bq) - 1
    if causal:
        row0 = max(0, c0 - kv_offset)
        first = row0 // bq
        if row0 >= nq:
            last = -1
        if window > 0:
            last_row = min(nk, c0 + bk) - 2 + window - kv_offset
            last = -1 if last_row < 0 else min(last, last_row // bq)
    return first, last


def _bwd_cta_order(nk: int, h_kv: int, b: int,
                   bk: int = _BWD_BK) -> List[Tuple[int, int, int]]:
    """(key tile, KV head, batch) of each K2/K4 CTA in launch order, as the
    kernel's `cta_tile` maps its block index (`bk`-key tiles): key tiles
    slowest, so that under causal, where key tile 0 sees the most queries,
    the longest walks start in the first wave."""
    return [(kt, lin % h_kv, lin // h_kv)
            for kt in range(cdiv(nk, bk)) for lin in range(h_kv * b)]


# K3's tiles (csrc/flash_bwd.cu): a CTA owns 128 query rows, the Gp query
# heads of one KV head packed as K1 packs them (R = 128 / Gp positions
# each), and streams the key tiles they see, 64 keys at a time (32 in its
# fp32 build, whose split tiles take twice the shared memory, and in its d
# = 256 build, whose resident Q and dO take as much); its fp32 d = 256
# build owns 64 rows (one consumer warpgroup) and walks 16-key tiles
_DQ_BM = 128
_DQ_BM_WIDE_F32 = 64
_DQ_BN = 64
_DQ_BN_F32 = 32
_DQ_BN_WIDE_F32 = 16


def _dq_key_tile(d: int, f32: bool = False) -> int:
    """Keys of a K3 key tile for a call of head dim d (`f32`: fp32
    operands): 64 in bf16, or 32 where the call runs on the bf16 d = 256
    build (as in the fp32 build at d up to 128, `_DQ_BN_F32`); 16 in the
    fp32 d = 256 build."""
    wide = run_dim(d, BWD_HEAD_DIMS) == 256
    if f32:
        return _DQ_BN_WIDE_F32 if wide else _DQ_BN_F32
    return _DQ_BN_F32 if wide else _DQ_BN


def _dq_rows(d: int, f32: bool = False) -> int:
    """Query rows of a K3 CTA: 128, or 64 in the fp32 d = 256 build."""
    wide = run_dim(d, BWD_HEAD_DIMS) == 256
    return _DQ_BM_WIDE_F32 if f32 and wide else _DQ_BM


def _dq_packing(h: int, h_kv: int, bm: int = _DQ_BM) -> Tuple[int, int]:
    """(Gp, R): the query heads of one KV head that a K3 CTA of `bm`
    rows packs (the largest divisor of the group size up to 16) and the
    positions of each (bm / Gp)."""
    gp = packed_heads(h // h_kv)
    return gp, bm // gp


def _dq_key_tiles(q0: int, r: int, nq: int, nk: int, causal: bool,
                  window: int, kv_offset: int,
                  bn: int = _DQ_BN) -> Tuple[int, int]:
    """The key tiles [begin, end) of `bn` keys (`_dq_key_tile`: `_DQ_BN`,
    `_DQ_BN_F32` in the fp32 and d = 256 builds, `_DQ_BN_WIDE_F32` in the
    fp32 d = 256 one) that the K3 CTA of
    positions q0 .. q0 + r − 1
    walks, as the kernel's `key_tiles` computes them: causal rows see keys
    <= pos + kv_offset, so the walk ends at the tile holding the last
    row's; with a window it starts at the tile of the first row's first
    key, q0 + kv_offset − window + 1, and is empty when that lies past the
    last key. Exactly the tiles with a visible pair (segment ids aside,
    which mask inside the walk)."""
    end = cdiv(nk, bn)
    begin = 0
    if causal:
        q_hi = min(q0 + r, nq) - 1
        end = min(end, cdiv(min(nk, max(0, q_hi + kv_offset + 1)), bn))
        if window > 0:
            lo_key = q0 + kv_offset - window + 1
            begin = max(0, lo_key) // bn
            if lo_key >= nk:
                end = min(end, begin)
    return begin, end


def _dq_cta_order(nq: int, h: int, h_kv: int, b: int, causal: bool,
                  bm: int = _DQ_BM) -> List[Tuple[int, int, int]]:
    """(Q tile, head group, batch) of each K3 CTA of `bm` rows in launch
    order, as the kernel's `cta_tile` maps its block index (K1's order):
    the grid's own order, except under causal, where the Q tiles run from
    the last, which sees the most keys, to the first, all head groups and
    batches of a tile together."""
    gp, r = _dq_packing(h, h_kv, bm)
    n_qt, n_hg = cdiv(nq, r), h // gp
    order = []
    for lin in range(n_qt * n_hg * b):
        if causal:
            rest = lin % (n_hg * b)
            order.append((n_qt - 1 - lin // (n_hg * b), rest % n_hg,
                          rest // n_hg))
        else:
            order.append((lin % n_qt, lin // n_qt % n_hg,
                          lin // (n_qt * n_hg)))
    return order


def flash_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense PyTorch version of the kernels' arithmetic, on any device.

    S from the raw q in fp32 times scale·log2e; P = exp2(S − LSE·log2e),
    0 where masked (causal, window, segment ids) or where the row's
    LSE < NEG_INF/2; dS = P ⊙ (dP − D)
    ·scale; P rounded to dO's dtype before dV = Pᵀ·dO, dS to q's before
    dK = dSᵀ·Q and to k's before dQ = dS·K, each product accumulated in
    fp32. GQA sums dK/dV over the query heads of a group in fp32."""
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    group = h // h_kv
    scale = resolve_scale(scale, d)
    qf = q.float().reshape(b, h_kv, group, nq, d)
    dof = do.float().reshape(b, h_kv, group, nq, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * (scale * _LOG2E)
    lse = lse.float().reshape(b, h_kv, group, nq, 1)
    dead = lse < NEG_INF * 0.5
    if causal:
        rows = torch.arange(nq, device=q.device)[:, None] + kv_offset
        cols = torch.arange(nk, device=q.device)[None, :]
        dead = dead | (cols > rows)
        if window:
            dead = dead | (cols <= rows - window)
    if q_segment_ids is not None:
        dead = dead | (q_segment_ids[:, :, None]
                       != kv_segment_ids[:, None, :])[:, None, None]
    p = torch.where(dead, torch.zeros((), device=q.device),
                    torch.exp2(s - lse * _LOG2E))
    delta = delta_plain(o, do).reshape(b, h_kv, group, nq, 1)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - delta) * scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(do.dtype).float(), dof)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds.to(q.dtype).float(), qf)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds.to(k.dtype).float(), kf)
    return (dq.reshape(b, h, nq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def delta_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO ⊙ O) [B, H, Nq] in fp32: the prologue kernel's plain
    version (the expression `flash_attention_backward_plain` uses)."""
    return (do.float() * o.float()).sum(-1)


# the prologue's type codes of O and dO (csrc/flash_bwd_kv.cu)
_DELTA_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def _launch_delta(o, do, dq_acc=None):
    """The prologue on CUDA tensors: D [B, H, Nq] fp32 from O and dO
    (bf16, fp16 or fp32 each, at d 64, 128 or 256), and dq_acc zeroed
    when given; counted under `launches["delta"]`."""
    for name, x in (("o", o), ("do", do)):
        if x.dtype not in _DELTA_CODES:
            raise NotImplementedError(
                f"the CUDA backward's prologue takes a bf16, fp16 or fp32 "
                f"{name}, got {x.dtype}")
    o, do = kernel_operand(o), kernel_operand(do)
    b, h, nq, d = o.shape
    delta = torch.empty((b, h, nq), dtype=torch.float32, device=o.device)
    strides = (ctypes.c_longlong * 6)(*o.stride()[:3], *do.stride()[:3])
    with torch.cuda.device(o.device):
        err = _build.library().cfa_bwd_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(),
            None if dq_acc is None else dq_acc.data_ptr(), b, h, nq, d,
            strides, _DELTA_CODES[o.dtype], _DELTA_CODES[do.dtype],
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_attention_backward prologue (D) launch")
        flash_attention_backward.launches["delta"] += 1
    return delta


def _bwd_prepare(q, k, v, o, lse, do, scale, causal, window, kv_offset,
                 q_seg, kv_seg, dq_acc=None):
    """Check what the CUDA kernels take and lay out one call's arguments:
    (q, build, dk, dv, head, shape, keep), head and shape as the C entry
    points take them around the outputs (dk and dv allocated in the type
    the build writes), keep the tensors behind head's pointers. D comes
    from the prologue (on O and dO as they are), which also zeroes
    `dq_acc` (K4's accumulator) when given; build is the call's
    `_BwdBuild`."""
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    build = _BwdBuild.of(q.dtype, k.dtype, v.dtype, do.dtype)
    for name, x in (("k", k), ("v", v), ("o", o), ("lse", lse), ("do", do),
                    ("q_segment_ids", q_seg), ("kv_segment_ids", kv_seg)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    lse = lse.float().contiguous()
    delta = _launch_delta(o, do, dq_acc)  # [B, H, Nq] fp32
    if build.mixed:
        q, k, v, do = (x.float() for x in (q, k, v, do))
    q, k, v, do = (kernel_operand(x) for x in (q, k, v, do))
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
    dk = torch.empty((b, h_kv, nk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h_kv, nk, d), dtype=v.dtype, device=q.device)
    if q_seg is not None:
        q_seg = q_seg.to(torch.int32).contiguous()
        kv_seg = kv_seg.to(torch.int32).contiguous()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if q_seg is None else q_seg.data_ptr(),
            None if kv_seg is None else kv_seg.data_ptr())
    shape = (b, h, h_kv, nq, nk, d, strides, resolve_scale(scale, d),
             int(bool(causal)), int(window), int(kv_offset))
    keep = (q, k, v, do, lse, delta, q_seg, kv_seg)
    return q, build, dk, dv, head, shape, keep


class _BwdBuild:
    """The builds a backward call runs: the unit of its 2-byte type
    (`unit`: "" bf16, "_f16" fp16) where q, k, v and dO share it, else the
    fp32 builds (`kv` / `dq`: the f32 codes of K2/K4 and of K3, 0 for the
    2-byte builds). A call of mixed float types (`mixed`, `out`: q's, k's,
    v's dtypes, those of dQ, dK, dV) runs them on exactly upcast operands,
    with P rounded to dO's type before dV, dS to q's before dK and to k's
    before dQ (`ROUND_CODES`), as JAX rounds them; K4 rounds dS once for
    both, so a call whose q and k types differ takes K2 + K3 (`split`)."""

    def __init__(self, unit, kv, dq, mixed, out):
        self.unit, self.kv, self.dq, self.mixed, self.out = (
            unit, kv, dq, mixed, out)
        self.split = mixed and out[0] != out[1]

    @classmethod
    def of(cls, q_dtype, k_dtype, v_dtype, do_dtype):
        """The builds of q, k, v, dO of these types; NotImplementedError
        for a type no build takes."""
        dtypes = (q_dtype, k_dtype, v_dtype, do_dtype)
        if any(t not in ROUND_CODES for t in dtypes):
            raise NotImplementedError(
                f"the CUDA backward takes bf16, fp16 or fp32 q/k/v/dO, got "
                f"{[str(t) for t in dtypes]}")
        out = (q_dtype, k_dtype, v_dtype)
        ty = bwd_tile_type(q_dtype, k_dtype, v_dtype, do_dtype)
        if ty != "fp32":
            return cls("_f16" if ty == "fp16" else "", 0, 0, False, out)
        mixed = {q_dtype, k_dtype, v_dtype, do_dtype} != {torch.float32}
        return cls("", 1 + ROUND_CODES[do_dtype] + 3 * ROUND_CODES[q_dtype],
                   1 + 3 * ROUND_CODES[k_dtype], mixed, out)


def _launch_dkdv(prep):
    """K2 on a prepared call (`_bwd_prepare`): (dK, dV) in k's and v's
    dtypes."""
    q, build, dk, dv, head, shape, _ = prep
    with torch.cuda.device(q.device):
        err = getattr(_build.library(), "cfa_flash_bwd_kv" + build.unit)(
            *head, dk.data_ptr(), dv.data_ptr(), None, *shape, build.kv,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_attention_backward dK/dV kernel launch")
        flash_attention_backward.launches["dkdv"] += 1
    return dk.to(build.out[1]), dv.to(build.out[2])


def _pad_bwd(q, k, v, o, do):
    """(d_run, [q, k, v, o, do]) as the backward's builds take them
    (`pad_heads` over `BWD_HEAD_DIMS`, bf16 or fp32 alike); ValueError
    past d = 256."""
    return pad_heads("backward", q, k, v, o, do, dims=BWD_HEAD_DIMS)


def _dkdv_cuda(q, k, v, o, lse, do, scale=None, causal=False, window=0,
               kv_offset=0, q_segment_ids=None, kv_segment_ids=None):
    """K2 alone on CUDA tensors, with `flash_attention_backward`'s
    arguments: (dK, dV) in k's dtype, counted under `launches["dkdv"]`:
    the split path's first kernel, timed on its own. Heads between the
    builds run padded, as in `_bwd_cuda`."""
    d = q.shape[-1]
    _, (q, k, v, o, do) = _pad_bwd(q, k, v, o, do)
    dk, dv = _launch_dkdv(_bwd_prepare(
        q, k, v, o, lse, do, resolve_scale(scale, d), causal, window,
        kv_offset, q_segment_ids, kv_segment_ids))
    return dk[..., :d], dv[..., :d]


def _bwd_cuda(q, k, v, o, lse, do, scale, causal, window, kv_offset, q_seg,
              kv_seg, fused):
    d = q.shape[-1]
    d_run, padded = _pad_bwd(q, k, v, o, do)
    if d_run != d:
        # the next build up (64, 128, 256) on zero-padded heads, at d's
        # scale
        q, k, v, o, do = padded
        grads = _bwd_cuda(q, k, v, o, lse, do, resolve_scale(scale, d),
                          causal, window, kv_offset, q_seg, kv_seg, fused)
        return tuple(g[..., :d] for g in grads)
    # K4's fp32 dQ accumulator, zeroed by the prologue (a mixed call whose
    # q and k types differ runs K2 + K3: `_BwdBuild.split`)
    fused = fused and not _BwdBuild.of(q.dtype, k.dtype, v.dtype,
                                       do.dtype).split
    dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if fused else None)
    prep = _bwd_prepare(q, k, v, o, lse, do, scale, causal, window,
                        kv_offset, q_seg, kv_seg, dq_acc)
    q, build, dk, dv, head, shape, _ = prep
    b, h, nq, d = q.shape
    launches = flash_attention_backward.launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _build.library()
        if fused:
            err = getattr(lib, "cfa_flash_bwd_kv" + build.unit)(
                *head, dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
                *shape, build.kv, stream)
            _build.check(err, "flash_attention_backward fused kernel launch")
            launches["fused"] += 1
            return (dq_acc.to(build.out[0]), dk.to(build.out[1]),
                    dv.to(build.out[2]))
        dk, dv = _launch_dkdv(prep)
        dq = torch.empty((b, h, nq, d), dtype=q.dtype, device=q.device)
        err = getattr(lib, "cfa_flash_bwd_q" + build.unit)(
            *head, dq.data_ptr(), *shape, build.dq, stream)
        _build.check(err, "flash_attention_backward dQ kernel launch")
        launches["dq"] += 1
    return dq.to(build.out[0]), dk, dv


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    block_sizes=None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    fused: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FA2 backward. q/o/do [B,H,Nq,d], k/v [B,Hkv,Nk,d], lse [B,H,Nq]
    (natural log, as the forward returns it) → (dQ [B,H,Nq,d],
    dK/dV [B,Hkv,Nk,d]) in the input dtypes.

    GQA: dK/dV sum the query heads of each group in fp32. `causal`,
    `window`, `kv_offset` and the segment ids mask as in the forward; a
    row that saw no key (LSE = NEG_INF) gives and gets zero gradients.
    `fused`: None
    and True run the single-pass kernel K4, False the split pair K2 + K3;
    all three give the same gradients. The JAX version picks fused only
    while its full-sequence state fits a TPU VMEM budget
    (`CFA_BWD_FUSED_BUDGET`, `CFA_BWD_FUSED`): that budget has no GPU
    counterpart (K4 keeps no full-sequence state on chip), so neither it
    nor the environment knobs are ported. `block_sizes`: its
    (`block_q_bwd`, `block_k_bwd`) runs at the built (64, 128), whatever
    it names (at d = 256 the built (64, 64), in fp32 (32, 64)); the
    forward's fields are not read here. On the card the kernels take d in
    {64, 128, 256} (any other d up to 256 on zero-padded heads, as the
    forward; d past 256 raises ValueError: no build) and bf16 or fp16
    q/k/v/dO (their own builds), or fp32 ones through the kernels' fp32
    builds (each tile split into bf16 hi and lo parts; the gradients come
    back fp32), fused or split; q/k/v/dO of mixed float types run the
    fp32 builds on exactly upcast operands, rounding P to dO's type and
    dS to q's (dK) and k's (dQ) as JAX does, the gradients cast to q's,
    k's and v's dtypes (a fused call whose q and k types differ runs K2 +
    K3, each rounding dS once).
    The counts of their launches are
    `flash_attention_backward.launches["dkdv"]`, `["dq"]` and `["fused"]`,
    and of the prologue before them (D, and K4's zeroed accumulator)
    `["delta"]`.
    """
    check_qkv(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or (
            lse.shape != q.shape[:3]):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    window = int(window or 0)
    if window and not causal:
        raise ValueError("window requires causal=True")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    if q_segment_ids is not None and (
            tuple(q_segment_ids.shape) != (q.shape[0], q.shape[2])
            or tuple(kv_segment_ids.shape) != (k.shape[0], k.shape[2])):
        raise ValueError(
            f"segment ids {tuple(q_segment_ids.shape)} / "
            f"{tuple(kv_segment_ids.shape)} do not match q "
            f"{tuple(q.shape)} / k {tuple(k.shape)}")
    if block_sizes is not None:
        ty = bwd_tile_type(q.dtype, k.dtype, v.dtype, do.dtype)
        check_tiles("K4" if fused is None or fused else "K2", ty, q.shape[-1],
                    block_sizes, "flash_attention_backward block_sizes",
                    bwd=True)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, o, lse, do, scale=scale, causal=causal, window=window,
            kv_offset=kv_offset, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _bwd_cuda(q, k, v, o, lse, do, scale, causal, window, kv_offset,
                     q_segment_ids, kv_segment_ids,
                     fused is None or bool(fused))


flash_attention_backward.launches = {"dkdv": 0, "dq": 0, "fused": 0,
                                     "delta": 0}
