"""Paged attention: decode over non-contiguous KV pages (block tables).

Counterpart of cuda_flashattention_tpu/ops/paged.py. A serving system
allocates the KV cache in fixed-size pages shared by all sequences
instead of one contiguous strip per sequence:

  * the page pool is one tensor [n_pages, Hkv, page_size, d] for K and one
    for V (plus per-token scale pools [n_pages, Hkv, page_size] when
    quantized),
  * each sequence's logical cache is a row of `page_table`
    [B, max_pages] holding physical page ids,
  * `PageAllocator`, on the host, hands pages out as sequences grow and
    takes them back when they finish.

On CUDA tensors `paged_decode_attention` launches the hand-written Hopper
kernel of csrc/paged.cu, which gathers through the table as it walks (no
copy is materialised: each key tile is copied into shared memory as the
runs of keys that lie in one page each, `ops/decode.py::tile_runs`) and
shares its arithmetic, its split of the context, its key tiles and the
splits' merge with the contiguous decode (csrc/decode_body.cuh,
ops/decode.py::split_size). On CPU tensors it runs
`paged_decode_attention_plain`, which gathers each sequence's live pages
and runs `decode_attention_plain` on them. The caches are updated in
place, as `KVCache` is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops.common import (
    cdiv,
    resolve_device,
    resolve_scale,
)
from cuda_flashattention_torch.ops.decode import (
    decode_attention_plain,
    UNIT_DTYPES,
    entry_point,
    kernel_inputs,
    optional_ptr,
    split_scratch,
)
from cuda_flashattention_torch.ops.quant import (
    pair_qtypes,
    qtype_of,
    storage_dtype,
    quantize_tensor,
)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """fp8 tensors are indexed through their bytes, which every indexing
    kernel takes."""
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def paged_decode_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: int = 0,
    windows: Optional[torch.Tensor] = None,
    quantize_q: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the paged kernel, on any device: gather
    each sequence's pages through the table into a contiguous
    [B, Hkv, max_pages·page_size, d] cache, then the arithmetic of
    `decode_attention_plain`. Table entries at or past a sequence's
    ceil(length / page_size) pages may hold anything and are not
    dereferenced: they are read as page 0, whose keys the length mask
    hides."""
    b = q.shape[0]
    n_pool, h_kv, ps, d = k_pages.shape
    max_pages = page_table.shape[1]
    lens = lengths.to(q.device).long().reshape(b).clamp(0, max_pages * ps)
    slots = torch.arange(max_pages, device=q.device)[None, :]
    live_pages = slots < ((lens + ps - 1) // ps)[:, None]
    table = torch.where(live_pages, page_table.to(q.device).long(),
                        torch.zeros((), dtype=torch.long, device=q.device))

    def gather(pool):  # [n_pages, Hkv, ps, ...] -> [B, Hkv, max_pages*ps, ...]
        g = _bytes(pool)[table].transpose(1, 2)  # [B,Hkv,max_pages,ps,...]
        g = g.reshape(b, h_kv, max_pages * ps, *pool.shape[3:])
        return g.view(pool.dtype)

    quantized = k_scale is not None
    return decode_attention_plain(
        q, gather(k_pages), gather(v_pages), lens,
        k_scale=gather(k_scale) if quantized else None,
        v_scale=gather(v_scale) if quantized else None,
        scale=scale, window=window, windows=windows, quantize_q=quantize_q)


def _paged_cuda(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale,
                scale, window, windows, quantize_q):
    b, h, d = q.shape
    _, h_kv, ps, _ = k_pages.shape
    max_pages = page_table.shape[1]
    out_dtype = q.dtype
    (q, q_sigma, k_pages, v_pages, k_scale, v_scale, windows, kt, vt, qq,
     unit, p_round) = kernel_inputs(q, k_pages, v_pages, k_scale, v_scale,
                                    windows, quantize_q, scale,
                                    "paged decode")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, h, d), dtype=UNIT_DTYPES[unit], device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        split, part, tickets = split_scratch(b, h_kv, h // h_kv, d,
                                             ps * max_pages, q.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(),
                      entry_point("cfa_paged_decode", unit, kt))(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            optional_ptr(k_scale), optional_ptr(v_scale),
            optional_ptr(q_sigma), table.data_ptr(), lengths.data_ptr(),
            optional_ptr(windows), o.data_ptr(), lse.data_ptr(),
            optional_ptr(part), optional_ptr(tickets), b, h, h_kv, ps,
            max_pages, k_pages.shape[0], d, kt, vt, int(qq), p_round,
            resolve_scale(scale, d), int(window or 0), split, stream)
    _build.check(err, "paged_decode_attention kernel launch")
    paged_decode_attention.launches += 1
    return o.to(out_dtype), lse


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: int = 0,
    windows: Optional[torch.Tensor] = None,
    quantize_q: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step over paged caches.

    q [B,H,d]; k_pages/v_pages [n_pages, Hkv, page_size, d] (the shared
    pools); page_table [B, max_pages] int physical page ids (entries
    beyond a sequence's ceil(length/page_size) pages are ignored and may
    hold anything); lengths [B] int live token counts. Optional per-token
    scale pools [n_pages, Hkv, page_size] fp32 for int8/fp8 storage.
    `window`, `windows` and `quantize_q` mean what they mean in
    `decode_attention`; pages before the window are not read.

    Returns (o [B,H,d] in q's dtype, lse [B,H] fp32). H may be any
    multiple of Hkv: rows beyond 8 per KV head go to further CTAs. On the
    card the kernel takes what `decode_attention`'s takes, at any
    page_size ≥ 1, walking the same key tiles as `decode_attention` with
    each key in the same slot (so K7 gives K6's bits); the count of its
    launches is `paged_decode_attention.launches`."""
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected q [B,H,d] and pools [n_pages,Hkv,page,d]"
                         f", got q {tuple(q.shape)} k_pages "
                         f"{tuple(k_pages.shape)} v_pages "
                         f"{tuple(v_pages.shape)}")
    b, h, d = q.shape
    n_pool, h_kv, ps, _ = k_pages.shape
    if k_pages.shape[3] != d:
        raise ValueError(f"pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % h_kv != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table {tuple(page_table.shape)} is not "
                         f"[{b}, max_pages]")
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} != ({b},)")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    for sc in (k_scale, v_scale):
        if sc is not None and tuple(sc.shape) != (n_pool, h_kv, ps):
            raise ValueError(f"scale pool shape {tuple(sc.shape)} != "
                             f"{(n_pool, h_kv, ps)}")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, lengths, k_scale=k_scale,
            v_scale=v_scale, scale=scale, window=window, windows=windows,
            quantize_q=quantize_q)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _paged_cuda(q, k_pages, v_pages, page_table, lengths, k_scale,
                       v_scale, scale, window, windows, quantize_q)


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# Paged cache management: pool + block tables + host-side page allocator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache of one attention layer.

    k_pages/v_pages: [n_pages, Hkv, page_size, d] shared pools (bf16,
    fp16, fp32, int8 or fp8). k_scale/v_scale: [n_pages, Hkv, page_size]
    fp32 pools or None. page_table: [B, max_pages] int32 physical ids.
    lengths: [B] int32 live tokens per sequence. All on one device; the
    appends and the allocator update them in place."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_table: torch.Tensor
    lengths: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


class PageAllocator:
    """Host-side free-list page allocator: hands out physical page ids as
    sequences grow and reclaims them when sequences finish.

    It tracks per sequence how many table slots it has filled, so that a
    reservation of several tokens is not allocated again (and so leaked)
    when fewer tokens were appended than reserved. `reserve_for` and
    `release_sequence` read the sequence's length from the cache: on the
    card that is one device synchronisation per call."""

    def __init__(self, n_pages: int):
        self.free = list(range(n_pages - 1, -1, -1))
        self._assigned: dict = {}  # batch_idx -> table slots allocated

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError("page pool exhausted")
        return self.free.pop()

    def release(self, page_ids) -> None:
        self.free.extend(int(p) for p in page_ids)

    def reserve_for(self, cache: PagedKVCache, batch_idx: int,
                    new_tokens: int = 1) -> PagedKVCache:
        """Ensure sequence `batch_idx` has pages for `new_tokens` more
        tokens, allocating pages and writing their ids into the table (in
        place) as needed. Raises ValueError when the sequence would exceed
        its max_pages·page_size capacity, and RuntimeError when the pool
        has too few free pages; either way nothing has been written or
        taken from the free list."""
        ps = cache.page_size
        max_pages = cache.page_table.shape[1]
        have = int(cache.lengths[batch_idx])
        pages_now = max(cdiv(have, ps), self._assigned.get(batch_idx, 0))
        pages_need = max(pages_now, cdiv(have + new_tokens, ps))
        if pages_need > max_pages:
            raise ValueError(
                f"sequence {batch_idx} needs {pages_need} pages for "
                f"{have + new_tokens} tokens but the table holds only "
                f"{max_pages} (capacity {max_pages * ps} tokens)")
        if pages_need - pages_now > len(self.free):
            # checked before any page leaves the free list, so a failed
            # reservation strands none
            raise RuntimeError(
                f"page pool exhausted: sequence {batch_idx} needs "
                f"{pages_need - pages_now} more pages, {len(self.free)} "
                f"free")
        if pages_need > pages_now:
            ids = [self.alloc() for _ in range(pages_now, pages_need)]
            cache.page_table[batch_idx, pages_now:pages_need] = torch.tensor(
                ids, dtype=cache.page_table.dtype,
                device=cache.page_table.device)
        self._assigned[batch_idx] = pages_need
        return cache

    def release_sequence(self, cache: PagedKVCache,
                         batch_idx: int) -> PagedKVCache:
        """Free all pages of a finished sequence (reserved but unfilled
        slots included) and set its length to 0."""
        ps = cache.page_size
        n = max(cdiv(int(cache.lengths[batch_idx]), ps),
                self._assigned.get(batch_idx, 0))
        self.release(cache.page_table[batch_idx, :n].tolist())
        self._assigned[batch_idx] = 0
        cache.lengths[batch_idx] = 0
        return cache


def init_paged_cache(n_pages: int, batch: int, max_pages: int,
                     heads_kv: int, page_size: int, d: int,
                     qtype: Optional[str] = None,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> PagedKVCache:
    """Allocate empty pools (zeroed values, scales of 1), a zeroed table
    and zero lengths. qtype in {None, "int8", "fp8", "mixed"} ("mixed" =
    int8 K pool, fp8 V pool). `device=None` means the card and raises
    without one (`resolve_device`)."""
    device = resolve_device(device)
    if qtype:
        kt, vt = pair_qtypes(qtype)
        k_store, v_store = storage_dtype(kt), storage_dtype(vt)
    else:
        k_store = v_store = dtype
    shape = (n_pages, heads_kv, page_size, d)

    def scales():
        if not qtype:
            return None
        return torch.ones(shape[:3], dtype=torch.float32, device=device)

    return PagedKVCache(
        torch.zeros(shape, dtype=k_store, device=device),
        torch.zeros(shape, dtype=v_store, device=device),
        scales(), scales(),
        torch.zeros((batch, max_pages), dtype=torch.int32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def paged_append(cache: PagedKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> PagedKVCache:
    """Append ONE token per sequence (k/v [B, Hkv, d]) at each write head,
    in place: one indexed write per pool. Quantized pools quantize here, K
    and V each onto its own grid (a mixed pool's int8 codes must not pass
    through an fp8 cast).

    The caller must have reserved a slot for the token of EVERY sequence
    (`PageAllocator.reserve_for`, which raises on a full table or pool
    before anything is written). Nothing is read back to the host, so an
    append without that reservation is not checked here and its result is
    undefined: a sequence at its table's capacity indexes past the table
    (an IndexError on the CPU, a device-side assert on the card, which
    leaves the CUDA context unusable), and one short of capacity writes
    through whatever stale page id its next table slot holds, possibly
    into another sequence's page."""
    b = k_new.shape[0]
    ps = cache.page_size
    lens = cache.lengths.long()
    rows = torch.arange(b, device=lens.device)
    pids = cache.page_table[rows, lens // ps].long()
    offs = lens % ps
    if cache.quantized:
        k_new, ks = quantize_tensor(k_new, qtype_of(cache.k_pages))
        v_new, vs = quantize_tensor(v_new, qtype_of(cache.v_pages))
        cache.k_scale[pids, :, offs] = ks
        cache.v_scale[pids, :, offs] = vs
    _bytes(cache.k_pages)[pids, :, offs] = _bytes(
        k_new.to(cache.k_pages.dtype))
    _bytes(cache.v_pages)[pids, :, offs] = _bytes(
        v_new.to(cache.v_pages.dtype))
    cache.lengths += 1
    return cache


def paged_decode_step(q: torch.Tensor, cache: PagedKVCache,
                      scale: Optional[float] = None,
                      window: int = 0,
                      windows: Optional[torch.Tensor] = None,
                      quantize_q: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attend one query token per sequence (q [B,H,d]) against the paged
    cache, with the whole surface of `paged_decode_attention` (windows,
    `quantize_q`)."""
    return paged_decode_attention(
        q, cache.k_pages, cache.v_pages, cache.page_table, cache.lengths,
        k_scale=cache.k_scale, v_scale=cache.v_scale, scale=scale,
        window=window, windows=windows, quantize_q=quantize_q)


def paged_bulk_append(cache: PagedKVCache, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> PagedKVCache:
    """Append T tokens per sequence (k/v [B, Hkv, T, d]), in place: the
    paged prefill write, one indexed write per pool and touched page
    slot. Every sequence's current length must be page-aligned (chunked
    prefill uses page-aligned chunks), else ValueError: a start inside a
    page would write the chunk at offset 0 of that page, over its live
    tokens. The check reads the lengths on the host. The caller must have
    reserved ceil(T/page_size) pages per sequence."""
    b, _, t, _ = k_new.shape
    ps = cache.page_size
    off = (cache.lengths % ps).tolist()
    if any(off):
        raise ValueError(
            f"paged_bulk_append requires page-aligned lengths "
            f"(page_size={ps}); got offsets {off}: prefill in page-aligned "
            f"chunks or use paged_append per token")
    base = cache.lengths.long() // ps  # first slot of the chunk, per sequence
    rows = torch.arange(b, device=base.device)
    for p in range(cdiv(t, ps)):
        w = min(ps, t - p * ps)
        pids = cache.page_table[rows, base + p].long()
        kc = k_new[:, :, p * ps:p * ps + w]
        vc = v_new[:, :, p * ps:p * ps + w]
        if cache.quantized:
            kc, ks = quantize_tensor(kc, qtype_of(cache.k_pages))
            vc, vs = quantize_tensor(vc, qtype_of(cache.v_pages))
            cache.k_scale[pids, :, :w] = ks
            cache.v_scale[pids, :, :w] = vs
        _bytes(cache.k_pages)[pids, :, :w] = _bytes(
            kc.to(cache.k_pages.dtype))
        _bytes(cache.v_pages)[pids, :, :w] = _bytes(
            vc.to(cache.v_pages.dtype))
    cache.lengths += t
    return cache


def paged_prefix_attention(q: torch.Tensor, cache: PagedKVCache,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attend a CHUNK of queries (q [B, H, C, d]) against the whole live
    paged cache: every cached token precedes the chunk, so the prefix is
    visible in full. Returns (o [B,H,C,d], lse [B,H,C]) for the log-space
    combination with the chunk's own causal self-attention
    (`parallel.ring.combine_partials`).

    The chunk's rows fold into the decode kernel's row dimension (row
    h·C + c still belongs to KV head h // group), since all rows share one
    visible key set."""
    b, h, c, d = q.shape
    o, lse = paged_decode_attention(
        q.reshape(b, h * c, d), cache.k_pages, cache.v_pages,
        cache.page_table, cache.lengths,
        k_scale=cache.k_scale, v_scale=cache.v_scale, scale=scale)
    return o.reshape(b, h, c, d), lse.reshape(b, h, c)
