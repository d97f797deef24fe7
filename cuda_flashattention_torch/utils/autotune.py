"""Measuring tuner of the kernels' tiles on the card (counterpart of
cuda_flashattention_tpu/utils/autotune.py, with its names, arguments and
command line).

On the card a tile is a template instance, so the candidates are the
tiles the kernels are built for (`ops.common.BUILT_TILES`), not the JAX
tuner's VMEM-sized lists:

  * "fwd": the key tiles of the kernel the call routes to: 64 and 128
    for K1 or K1b over bf16, 64 over fp32, K5's 64 · span (at d = 256
    64 keys alone, K5's one-tile span: bf16 only);
  * "bwd": the backward's one built pair: (64, 128) at d up to 128,
    (64, 64) at d = 256 in bf16 and (32, 64) there in fp32;
  * decode: K6's split sizes from 128 keys, doubling, up to the cache's
    capacity, and the capacity itself (one split);
  * page: the page sizes K7 takes, 16 to 1024 keys by doubling, that fit
    the context.

Each candidate is timed with `utils.timing.time_fn` (CUDA events, the
median of `iters` calls) on seeded inputs on the card. A candidate the
card refuses is logged and is no winner; a sweep with a failure is kept
in the process but never written to disk; when every candidate fails the
tuner returns the default rule (`auto_block_sizes`,
`default_decode_block_k`) and logs a warning. Winners are cached in the
process and in the JSON file `config.AUTOTUNE_CACHE` names, under a key
that carries the card's name and the hash of the kernel library
(`_build`), so that no winner outlives the kernels it was measured on.
`sweeps` keeps each measured sweep's (candidate, ms or None) pairs.

    bs = autotune_block_sizes(nq=4096, nk=4096, d=128, heads=16,
                              causal=True)
    o, lse = flash_attention_forward(q, k, v, causal=True, block_sizes=bs)

    python -m cuda_flashattention_torch.utils.autotune --mode fwd \\
        --seq 4096 --d 128 --heads 16 --causal
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from cuda_flashattention_torch import _build, config
from cuda_flashattention_torch.ops.common import (
    BlockSizes,
    auto_block_sizes,
    built_tiles,
    bwd_tile_type,
    resolve_device,
    round_up,
    tile_type,
)
from cuda_flashattention_torch.utils.log import get_logger
from cuda_flashattention_torch.utils.timing import time_fn

_VERSION = "v1"  # bumped whenever the timing method changes
_MEM_CACHE: Dict[str, object] = {}
sweeps: Dict[str, List[Tuple[object, Optional[float]]]] = {}

DECODE_MIN_SPLIT = 128
PAGE_SIZES = (16, 32, 64, 128, 256, 512, 1024)


def _disk_cache_load() -> dict:
    try:
        with open(config.AUTOTUNE_CACHE()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _disk_cache_store(cache: dict) -> None:
    path = config.AUTOTUNE_CACHE()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
    except OSError:
        pass  # caching is best-effort


def _key(device: torch.device, *parts) -> str:
    """The cache key: the card's name and the kernel library's hash (the
    winner belongs to those kernels on that card), then the problem."""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    lib = _build._library_path(_build.sources()).stem.rsplit("_", 1)[-1]
    return json.dumps([_VERSION, name, lib, *parts])


def _tune(key: str, cands: list, measure: Callable[[object], float],
          fallback: Callable[[], object], what: str, verbose: bool,
          encode=lambda c: c, decode=lambda c: c):
    """The sweep and its cache policy, shared by the tuners: the fastest
    candidate that ran, from the process's or the disk's cache when the
    key is there."""
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    disk = _disk_cache_load()
    if key in disk:
        _MEM_CACHE[key] = decode(disk[key])
        return _MEM_CACHE[key]
    log = get_logger(__name__)
    best, best_ms, failures, sweep = None, math.inf, [], []
    for cand in cands:
        try:
            ms = measure(cand)
        except Exception as e:  # noqa: BLE001: a refused candidate is a
            # non-winner, whatever the card said
            failures.append(f"{cand}: {type(e).__name__}: {str(e)[:160]}")
            log.warning("autotune %s: candidate %s failed: %s", what, cand,
                        failures[-1])
            sweep.append((cand, None))
            continue
        sweep.append((cand, ms))
        if verbose:
            print(f"  {cand} -> {ms:.4f} ms", flush=True)
        if ms < best_ms:
            best, best_ms = cand, ms
    sweeps[key] = sweep
    if failures:
        log.warning("autotune %s: %d/%d candidates failed (kept in this "
                    "process only, not written to disk)", what,
                    len(failures), len(cands))
    if best is None:
        best = fallback()
        log.warning("autotune %s: every candidate failed; the default rule "
                    "gives %s", what, best)
    elif not failures:
        disk[key] = encode(best)
        _disk_cache_store(disk)
    _MEM_CACHE[key] = best
    return best


def _rand(gen, shape, dtype, device):
    return (torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32) - 0.5).to(dtype)


def _fwd_route(nq: int, causal: bool, dtype) -> str:
    """The kernel "auto" routes an unquantized call to: K1 (online), K1b
    (bound, Q-major) or K5 (bound, causal: K-major)."""
    from cuda_flashattention_torch.ops.flash_fwd import _resolve_use_bound
    if not _resolve_use_bound("auto", causal=causal, quantized=False,
                              segmented=False, nq=nq):
        return "K1"
    return "K5" if causal else "K1b"


def candidate_blocks(nq: int, nk: int, d: int, causal: bool = False,
                     dtype=torch.bfloat16,
                     mode: str = "fwd") -> List[Tuple[int, int]]:
    """The (block_q, block_k) tiles that the kernel a call routes to is
    built for ("bwd": the backward's pair) and that fit the problem: key
    tiles past the keys rounded up to 64 are left out, the smallest
    always kept. NotImplementedError where no build takes the call (d
    past 256)."""
    if mode == "bwd":
        kernel, ty = "K4", bwd_tile_type(dtype, dtype, dtype, dtype)
    else:
        kernel, ty = _fwd_route(nq, causal, dtype), tile_type(dtype, dtype)
    built = built_tiles(kernel, ty, d)
    if built is None:
        raise NotImplementedError(
            f"no CUDA build of {kernel} takes {ty} operands at d = {d}: "
            f"nothing to tune")
    qs, ks = built
    if mode == "bwd":
        return [(q, k) for q in qs for k in ks]
    fit = [k for k in ks if k <= max(ks[0], round_up(nk, 64))]
    return [(q, k) for q in qs for k in fit]


def _bench_fwd(bs: BlockSizes, q, k, v, causal: bool, iters: int,
               window: int = 0) -> float:
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    return time_fn(flash_attention_forward, q, k, v, causal=causal,
                   window=window, block_sizes=bs, iters=iters)


def _bench_bwd(bs: BlockSizes, q, k, v, causal: bool, iters: int,
               window: int = 0) -> float:
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    o, lse = flash_attention_forward(q, k, v, causal=causal, window=window)
    return time_fn(flash_attention_backward, q, k, v, o, lse, o,
                   causal=causal, window=window, block_sizes=bs, iters=iters)


def autotune_block_sizes(
    nq: int,
    nk: int,
    d: int,
    batch: int = 1,
    heads: int = 1,
    dtype=torch.bfloat16,
    causal: bool = False,
    window: int = 0,
    mode: str = "fwd",
    iters: int = 5,
    candidates: Optional[List[Tuple[int, int]]] = None,
    verbose: bool = False,
    kv_heads: Optional[int] = None,
    device=None,
) -> BlockSizes:
    """Time the tiles the routed kernel is built for on the card; return
    the fastest as a `BlockSizes` (mode "fwd": block_q / block_k; "bwd":
    block_q_bwd / block_k_bwd; the other pair at its default). `window`
    implies causal. `kv_heads` (default `heads`): K/V heads of the
    problem. `device`: where the inputs are made (default the card)."""
    if window:
        causal = True
    if mode not in ("fwd", "bwd"):
        raise ValueError(f"mode must be fwd or bwd, got {mode!r}")
    device = resolve_device(device)
    kv_heads = kv_heads or heads
    key = _key(device, mode, batch, heads, kv_heads, nq, nk, d, str(dtype),
               causal, window)
    cands = candidates or candidate_blocks(nq, nk, d, causal, dtype, mode)
    base = BlockSizes()
    if mode == "bwd":
        tiles = [dataclasses.replace(base, block_q_bwd=bq, block_k_bwd=bk)
                 for bq, bk in cands]
    else:
        tiles = [dataclasses.replace(base, block_q=bq, block_k=bk)
                 for bq, bk in cands]
    gen = torch.Generator(device=device).manual_seed(0)
    q = _rand(gen, (batch, heads, nq, d), dtype, device)
    k = _rand(gen, (batch, kv_heads, nk, d), dtype, device)
    v = _rand(gen, (batch, kv_heads, nk, d), dtype, device)
    bench = _bench_bwd if mode == "bwd" else _bench_fwd
    return _tune(
        key, tiles,
        lambda bs: bench(bs, q, k, v, causal, iters, window=window),
        lambda: auto_block_sizes(nq, nk, d, causal=causal, batch=batch,
                                 kv_heads=kv_heads,
                                 f32=dtype == torch.float32),
        f"{mode} {batch}x{heads}x{nq}x{nk} d={d}", verbose,
        encode=dataclasses.asdict, decode=lambda c: BlockSizes(**c))


def decode_candidates(capacity: int) -> List[int]:
    """K6's split sizes to try over a cache of `capacity` keys: 128,
    doubling, below the capacity, then the capacity (one split)."""
    out, c = [], DECODE_MIN_SPLIT
    while c < capacity:
        out.append(c)
        c *= 2
    return out + [capacity]


def _kv(gen, shape, qtype, device):
    """Seeded bf16 K and V [B, Hkv, N, d], or their codes and scales."""
    k = _rand(gen, shape, torch.bfloat16, device)
    v = _rand(gen, shape, torch.bfloat16, device)
    if not qtype:
        return k, v, {}
    from cuda_flashattention_torch.ops.quant import quantize_kv
    kv = quantize_kv(k, v, qtype)
    return kv.k_q, kv.v_q, dict(k_scale=kv.k_scale, v_scale=kv.v_scale)


def autotune_decode_block_k(
    ctx: int,
    heads: int = 16,
    kv_heads: Optional[int] = None,
    d: int = 128,
    batch: int = 4,
    qtype: Optional[str] = None,
    window: int = 0,
    iters: int = 10,
    verbose: bool = False,
    live: Optional[int] = None,
    device=None,
) -> int:
    """Time K6's split sizes (`decode_candidates(ctx)`) on a cache of
    `ctx` keys per sequence, `live` of them live (default all), with a
    bf16 q; return the fastest, the `block_k` of `decode_attention` and
    `decode_step`."""
    from cuda_flashattention_torch.ops.decode import (
        decode_attention, default_decode_block_k)
    device = resolve_device(device)
    kv_heads = kv_heads or heads
    live = ctx if live is None else live
    key = _key(device, "decode", batch, heads, kv_heads, ctx, live, d,
               qtype or "bf16", window)
    gen = torch.Generator(device=device).manual_seed(0)
    k, v, scales = _kv(gen, (batch, kv_heads, ctx, d), qtype, device)
    q = _rand(gen, (batch, heads, d), torch.bfloat16, device)
    lengths = torch.full((batch,), live, dtype=torch.int32, device=device)
    return _tune(
        key, decode_candidates(ctx),
        lambda bk: time_fn(decode_attention, q, k, v, lengths, block_k=bk,
                           window=window, iters=iters, **scales),
        lambda: default_decode_block_k(
            k.dtype, v.dtype, q.dtype, False, window, False, ctx,
            batch=batch, kv_heads=kv_heads, rows=heads // kv_heads, d=d),
        f"decode ctx={ctx}", verbose)


def page_candidates(ctx: int) -> List[int]:
    """K7's page sizes to try over a context of `ctx` keys: 16 to 1024 by
    doubling, those no larger than the context (16 at least)."""
    return [p for p in PAGE_SIZES if p <= ctx] or [PAGE_SIZES[0]]


def autotune_page_size(
    ctx: int,
    heads: int = 16,
    d: int = 128,
    batch: int = 4,
    qtype: Optional[str] = None,
    iters: int = 10,
    verbose: bool = False,
    kv_heads: Optional[int] = None,
    live: Optional[int] = None,
    device=None,
) -> int:
    """Time K7 over page pools of each candidate size
    (`page_candidates(ctx)`), every sequence's table holding ceil(ctx /
    page) pages, `live` keys live (default ctx); return the fastest page
    size. It is a cache-layout choice: make it before the pools."""
    from cuda_flashattention_torch.ops.paged import paged_decode_attention
    device = resolve_device(device)
    kv_heads = kv_heads or heads
    live = ctx if live is None else live
    key = _key(device, "page", batch, heads, kv_heads, ctx, live, d,
               qtype or "bf16")
    gen = torch.Generator(device=device).manual_seed(0)
    q = _rand(gen, (batch, heads, d), torch.bfloat16, device)
    lengths = torch.full((batch,), live, dtype=torch.int32, device=device)
    cands = page_candidates(ctx)

    def measure(page):
        per_seq = -(-ctx // page)
        k, v, scales = _kv(gen, (batch * per_seq, kv_heads, page, d), qtype,
                           device)
        table = torch.arange(batch * per_seq, dtype=torch.int32,
                             device=device).reshape(batch, per_seq)
        return time_fn(paged_decode_attention, q, k, v, table, lengths,
                       iters=iters, **scales)

    return _tune(key, cands, measure, lambda: min(256, cands[-1]),
                 f"page ctx={ctx}", verbose)


_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
           "fp32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_flashattention_torch.utils.autotune",
        description="Time the kernels' built tiles (fwd, bwd), K6's split "
                    "sizes (decode) or K7's page sizes (page) on the card "
                    "and cache the winner in $CFA_AUTOTUNE_CACHE.")
    ap.add_argument("--seq", type=int, default=16384,
                    help="sequence length (fwd, bwd) or cache capacity "
                         "(decode, page)")
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--kv-heads", type=int, default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--mode", choices=["fwd", "bwd", "decode", "page"],
                    default="fwd")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="bf16",
                    help="Q, K, V (and dO) type of fwd and bwd")
    return ap


def main(argv=None) -> None:
    opts = build_parser().parse_args(argv)
    if opts.mode == "decode":
        bk = autotune_decode_block_k(
            ctx=opts.seq, heads=opts.heads, kv_heads=opts.kv_heads, d=opts.d,
            batch=opts.batch, window=opts.window, iters=opts.iters,
            verbose=True)
        print(f"best decode block_k: {bk}")
    elif opts.mode == "page":
        ps = autotune_page_size(
            ctx=opts.seq, heads=opts.heads, kv_heads=opts.kv_heads, d=opts.d,
            batch=opts.batch, iters=opts.iters, verbose=True)
        print(f"best page_size: {ps}")
    else:
        bs = autotune_block_sizes(
            nq=opts.seq, nk=opts.seq, d=opts.d, batch=opts.batch,
            heads=opts.heads, kv_heads=opts.kv_heads, causal=opts.causal,
            window=opts.window, mode=opts.mode, iters=opts.iters,
            dtype=_DTYPES[opts.dtype], verbose=True)
        print(f"best: {bs}")


if __name__ == "__main__":
    main()
