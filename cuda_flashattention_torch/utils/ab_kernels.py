"""Time the kernels of one checkout of this package, to compare two
commits on one card within one call.

    python3 cuda_flashattention_torch/utils/ab_kernels.py <checkout root>
                                         [K9 | decode | decode-sweep |
                                          forward | forward-quick |
                                          crossing]

imports `cuda_flashattention_torch` from <checkout root> (building its
kernels there), and prints, on bf16 inputs with d=128 (with `K9`, only the
last item; with `decode`, only the K6 and K7 rows, without the split
sweep; with `decode-sweep`, the K6 and K7 rows and their split sweep):
  - the online forward (K1) and the fused backward (K4), both causal, at
    the serving prefill shape (B=8, H=16, Hkv=4, N=512, fp32 out) and the
    training shape (B=1, H=16, N=4096, bf16 out); K1 there also under
    window 1024;
  - at the training shape: K4 under window 1024 and without a mask (a
    ring step's full 4096 x 4096 block), and the split backward
    (`fused=False`): its dK/dV kernel (K2) and its dQ kernel (K3), each
    listed with its own time;
  - K1's other forms: at the chunked-prefill prefix pinned online over
    bf16 and int8 K/V, and under segment ids (the serving chunk's shape,
    causal and not);
  - FA1 (K8) at B=1, H=16, N=4096, causal and not;
  - the score-bound forward (`softmax="bound_unchecked"`, no guarded
    fallback launch) at the chunked-prefill prefix (B=8, H=16, Hkv=4, 512
    query rows over 3584 keys, fp32 out): K1b over bf16 and int8 K/V, K5
    over fp8 K/V; and K5 at B=1, H=16, N=16384 causal (the one-rank call
    of the ring's shape, and Ulysses');
  - the decode (K6) at B=8, H=16, Hkv=4 over 640 and 4224 live tokens of
    a bf16 cache, and the paged decode (K7) over 4224 live tokens in
    128-token pages, each on a cold L2 (a 256 MiB write before every
    call, as a server's decode step finds the cache); where the checkout
    splits the context (`ops.decode.SPLIT_KEYS`), the same three rows
    under split sizes of 64, 128, 256 and 512 keys and unsplit; then, at
    4224 live of 4352, cold: K6 over int8, fp8 and mixed caches, int8
    under `quantize_q`, an fp32 q over an fp32 cache, K7 over an int8
    pool and the whole paged step (`paged_decode_step`, wrapper ms); the
    Gemma-width shape (B=8, H=8, Hkv=4, d=256) K6 over bf16 and int8 and
    K7 over bf16; K6 at d = 8, 16 and 32, and at d = 7 and 91, whose
    rows no cp.async can take (B=8, H=16, Hkv=4, bf16); the wrapper
    warm, back to back (its host time per call where that exceeds the
    kernel's: K6 at 640 live, K7 at 4224); and
    beside them the library call, one `scaled_dot_product_attention`
    with a one-row query under the length mask, on the same bf16 keys
    (the rows named "SDPA");
  - the device ring (K9, `device_ring_matmul`) with its ranks sharing the
    card: L=1024 at n=1, 4 (the example stage) and 8, L=8192 at n=1, 4
    and 8 (kernel alone per launch: its time per hop is (n8 − n1) / 7).
With `forward`, only the forward rows of `forward_rows` (below): the build's
nvcc seconds, then per row the kernel alone (every `flash_fwd*` kernel of
a call, K5's finalise and the conversion pass included, and the zeroing of
its scratch), its bound and share, and SDPA on the same (dequantised)
inputs under the same mask. `forward-quick`: the same rows over a library
of the forward units alone (`forward_units_only`); `crossing`: over the
same library, only the rows of K5's two walks (`crossing_rows`).
For each: the wrapper's median ms (CUDA events) and the device ms per
call of its kernels (torch.profiler), with each kernel's ms per launch.
The K4 rows run first, so that both checkouts reach them after the same
work.
Unpack the parent commit beside the change (`git archive <commit> | tar
-x -C <dir>`) and run parent, change, change, parent: two cards, or two
calls, differ by more than two commits do. Needs a CUDA device.
"""

import sys
import time


def main(root: str, only: str = "") -> None:
    sys.path.insert(0, root)
    import torch

    from cuda_flashattention_torch.utils.profiling import kernel_times
    from cuda_flashattention_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    card = torch.cuda.get_device_name(0)

    def mk(*shape, peak=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) - 0.5)
                * peak).to(torch.bfloat16)

    def short(name):
        """A profiler kernel name without its return type, namespace and
        arguments."""
        name = name.replace("void ", "", 1)
        return name.replace("(anonymous namespace)::", "").split("(")[0][:48]

    # a write of 256 MiB evicts the 50 MB L2 cache
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def report(label, fn, word, iters, cold=False):
        """`label`: wrapper ms, the device ms per call of the kernels whose
        name holds `word` (each launches once a call; none for word None:
        a library call, whose time is the wrapper's) and each listed
        package kernel's ms per launch; with `cold`, each call follows a
        write that evicts the L2 cache."""
        wrapper = cuda_time_ms(fn, iters=iters,
                               before=flush.zero_ if cold else None)
        prof = kernel_times((lambda: (flush.zero_(), fn())) if cold else fn,
                            iters=max(1, iters // 4))
        names = [n for n in prof.ms if word and word in n]
        per_call = sum(prof.ms[n] / prof.count[n] for n in names)
        each = ", ".join(f"{short(n)} "
                         f"{prof.ms[n] / prof.count[n]:.4f}" for n in prof.ms
                         if any(w in n for w in ("flash_", "fa1", "decode_k",
                                                 "paged_k", "device_ring")))
        print(f"{root} {label}: wrapper {wrapper:.4f} ms, kernels "
              f"{per_call:.4f} ms per call [{each}] ({card})", flush=True)

    def device_ring_rows():
        from cuda_flashattention_torch.parallel.device_ring import (
            device_ring_matmul)
        from cuda_flashattention_torch.parallel.mesh import make_mesh
        for rows, n in ((1024, 1), (1024, 4), (1024, 8), (8192, 1),
                        (8192, 4), (8192, 8)):
            mesh = make_mesh((n,), ("sp",), [dev] * n)
            x, w = mk(n * rows, 128), mk(128, 128)
            report(f"K9 device ring n={n} L={rows}",
                   lambda: device_ring_matmul(x, w, mesh), "device_ring", 40)

    if only == "K9":
        device_ring_rows()
        return
    if only in ("forward", "forward-quick", "crossing"):
        if only != "forward":
            forward_units_only()
        forward_rows(mk, dev, card, only_crossing=only == "crossing")
        return

    if not only.startswith("decode"):
        forward_backward_rows(mk, dev, report)
    _decode_rows(mk, gen, dev, report, sweep=only != "decode")
    if not only.startswith("decode"):
        device_ring_rows()


def forward_backward_rows(mk, dev, report):
    """K4, K2 + K3, K1, K8, K1 under segment ids, K1b and K5."""
    import torch

    from cuda_flashattention_torch.ops.fa1 import fa1_attention
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    from cuda_flashattention_torch.ops.quant import quantize_kv

    cases = []
    for name, (b, h, hkv, n), out_dtype in (
            ("prefill", (8, 16, 4, 512), torch.float32),
            ("train", (1, 16, 16, 4096), torch.bfloat16)):
        q, do = mk(b, h, n, 128), mk(b, h, n, 128)
        k, v = mk(b, hkv, n, 128), mk(b, hkv, n, 128)
        o, lse = flash_attention_forward(q, k, v, causal=True,
                                         out_dtype=out_dtype)
        cases.append((name, q, k, v, do, o, lse, out_dtype))
    # the backward first, so that its rows follow the same work in both
    # checkouts (the forward's time differs between them)
    for name, q, k, v, do, o, lse, _ in cases:
        report(f"{name} K4 fused backward",
               lambda: flash_attention_backward(q, k, v, o, lse, do,
                                                causal=True), "flash_bwd", 20)
    _, q, k, v, do, o, lse, _ = cases[1]
    report("train K2 + K3 (fused=False)",
           lambda: flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                            fused=False), "flash_bwd", 20)
    for label, kw in (("window 1024", dict(causal=True, window=1024)),
                      ("no mask (ring full block)", dict(causal=False))):
        o_m, lse_m = flash_attention_forward(q, k, v, **kw)
        report(f"train K4 fused backward, {label}",
               lambda: flash_attention_backward(q, k, v, o_m, lse_m, do,
                                                **kw), "flash_bwd", 20)
        del o_m, lse_m
    for name, q, k, v, _, _, _, out_dtype in cases:

        def fwd():
            return flash_attention_forward(q, k, v, causal=True,
                                           out_dtype=out_dtype)

        report(f"{name} K1 forward", fwd, "flash_fwd", 40)
    report("train K1 forward, window 1024", lambda: flash_attention_forward(
        q, k, v, causal=True, window=1024), "flash_fwd", 40)
    for causal in (True, False):
        report(f"K8 FA1 B=1 H=16 N=4096 causal={causal}",
               lambda: fa1_attention(q, k, v, causal=causal), "fa1", 20)

    # K1 under segment ids at the serving chunk's shape, peaked inputs
    q = mk(8, 16, 512, 128, peak=8)
    k, v = mk(8, 4, 512, 128, peak=4), mk(8, 4, 512, 128)
    seg = torch.repeat_interleave(
        torch.arange(4, device=dev),
        torch.tensor([200, 1, 120, 191], device=dev))[None].expand(8, 512)
    for causal in (True, False):
        report(f"K1 segments causal={causal}",
               lambda: flash_attention_forward(
                   q, k, v, causal=causal, q_segment_ids=seg,
                   kv_segment_ids=seg, out_dtype=torch.float32), "flash_fwd",
               40)

    # the score-bound forms, peaked inputs as chip_smoke feeds them
    q = mk(8, 16, 512, 128, peak=8)
    k, v = mk(8, 4, 3584, 128, peak=4), mk(8, 4, 3584, 128)
    for label, qtype, softmax in (
            ("prefix K1b bf16", None, "bound_unchecked"),
            ("prefix K1b int8", "int8", "bound_unchecked"),
            ("prefix K5 fp8", "fp8", "bound_unchecked"),
            ("prefix K1 online bf16", None, "online"),
            ("prefix K1 online int8", "int8", "online")):
        kk, vv, scales = k, v, {}
        if qtype is not None:
            kv = quantize_kv(k, v, qtype)
            kk, vv = kv.k_q, kv.v_q
            scales = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
        report(label, lambda: flash_attention_forward(
            q, kk, vv, out_dtype=torch.float32, softmax=softmax,
            **scales), "flash_fwd", 20)
    del q, k, v
    q = mk(1, 16, 16384, 128, peak=8)
    k, v = mk(1, 16, 16384, 128, peak=4), mk(1, 16, 16384, 128)
    report("N=16384 causal K5", lambda: flash_attention_forward(
        q, k, v, causal=True, softmax="bound_unchecked"), "flash_fwd", 8)
    del q, k, v


def forward_units_only():
    """Build and bind only the forward units (`flash_fwd*.cu`, `fa1*.cu`:
    K1, K1b, K5, K8 and their fp16 units) of the checkout just imported,
    for `forward-quick`: a build of ~1 min instead of ~4 (the decode units
    are the long pole), into a library of its own name."""
    from cuda_flashattention_torch import _build
    every = _build.sources
    _build.sources = lambda: [s for s in every()
                              if s.name.startswith(("flash_fwd", "fa1"))]
    _build.SIGNATURES = {n: a for n, a in _build.SIGNATURES.items()
                         if n.startswith(("cfa_flash_fwd", "cfa_fa1"))}


def forward_rows(mk, dev, card, only_crossing=False):
    """The forward kernels' rows (bf16 inputs peaked as chip_smoke's, Q x8
    and K x4; fp32 O), each pinned through `ops.flash_fwd._plan` +
    `_fwd_cuda` (the bound forms without the guarded fallback launch):
      - K1b and K5 at the Gemma-width prefix (B=8, H=8, Hkv=4, 512 rows
        over 3584 keys, d=256) over bf16, int8, fp8 and mixed K/V, each
        quantized pair also under quantize_q;
      - both at its windowed prefix (the 1024-key slice, causal, window
        1024, kv_offset 1024) over bf16, int8 and fp8;
      - K5 at [1, 8, 8192, 256] over 4 KV heads, causal, bf16;
      - the fp32-Q d = 256 builds: K1b over int8 and bf16 at the prefix,
        K5 over int8 at the windowed prefix;
      - fp16: K1b and K5 at the Gemma prefix over int8, and at d=128's
        over fp16 and int8;
      - d = 128: at the 246M model's prefix (B=8, H=16, Hkv=4, 512 over
        3584) K1b and K5 over bf16, int8, fp8 and mixed K/V, each
        quantized pair also under quantize_q, K1 (online) over bf16 and
        int8; the same at its windowed prefix (512 over 1024, window 1024)
        over bf16, int8, fp8; K5 at [1, 16, 6144, 128] and [1, 16, 16384,
        128] causal; the crossing of K5's walks (`crossing_rows`); K1 and K8 at
        [1, 16, 4096, 128] causal, K8 also not causal;
      - K1 at the Gemma prefill (B=8, 512 causal, d=256) and K8 at [1, 8,
        4096, 256] causal.
    Each row: the kernel alone per call (torch.profiler over 5 calls: the
    `flash_fwd*` / `fa1` kernels and the fill of a zeroed scratch), the
    bound (the larger of the bytes, K/V at their storage width, over 3.35
    TB/s and 4·pairs·d over 989 TFLOP/s, or 495 for an fp32 Q) and SDPA's
    wrapper ms on the same inputs (dequantised, Q's type) under the same
    mask."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from cuda_flashattention_torch import _build
    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.ops.fa1 import fa1_attention
    from cuda_flashattention_torch.ops.quant import quantize_kv
    from cuda_flashattention_torch.utils.profiling import kernel_times
    from cuda_flashattention_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    _build.library()
    if _build.build_seconds is not None:
        longest = max(_build.source_seconds.items(), key=lambda x: x[1])
        print(f"{sys.argv[1]} build: nvcc {_build.build_seconds:.1f} s wall "
              f"({time.perf_counter() - t0:.1f} s with the load), longest "
              f"unit {longest[0]} {longest[1]:.1f} s; forward units "
              + ", ".join(f"{n} {t:.1f}" for n, t in sorted(
                  _build.source_seconds.items()) if n.startswith(
                      ("flash_fwd", "fa1"))) + f" ({card})", flush=True)

    def pairs(nq, nk, causal=False, window=0, kv_offset=0):
        i = np.arange(nq, dtype=np.int64) + kv_offset
        hi = np.minimum(nk, i + 1) if causal else np.full(nq, nk)
        lo = np.maximum(0, i - window + 1) if window else np.zeros(nq)
        return int(np.maximum(0, hi - lo).sum())

    def inputs(b, h, hkv, nq, nk, d, qtype, dtype=torch.bfloat16):
        q = mk(b, h, nq, d, peak=8).to(dtype)
        k, v = mk(b, hkv, nk, d, peak=4), mk(b, hkv, nk, d)
        if qtype is None:
            return q, k.to(dtype), v.to(dtype), {}, k.to(dtype), v.to(dtype)
        kv = quantize_kv(k, v, qtype)
        sc = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
        kd = (kv.k_q.float() * kv.k_scale[..., None]).to(dtype)
        vd = (kv.v_q.float() * kv.v_scale[..., None]).to(dtype)
        return q, kv.k_q, kv.v_q, sc, kd, vd

    def pinned(form, q, k, v, sc, kw, qq=False):
        softmax = "online" if form == "online" else "bound_unchecked"
        plan = ff._plan(q, k, v, None, kw.get("causal", False),
                        kw.get("window", 0), kw.get("kv_offset", 0), None,
                        sc.get("k_scale"), sc.get("v_scale"), None, None,
                        softmax, qq)
        plan = dataclasses.replace(plan, use_kmajor=form == "kmajor")
        return lambda: ff._fwd_cuda(q, k, v, plan, torch.float32,
                                    sc.get("k_scale"), sc.get("v_scale"),
                                    None, None)

    sdpa_ms = {}

    def sdpa(key, q, kd, vd, kw):
        """SDPA's wrapper ms on the dequantised K/V (Q's type), once per
        key: `is_causal` for a plain causal square call, else the call's
        boolean mask."""
        if key in sdpa_ms:
            return sdpa_ms[key]
        nq, nk = q.shape[2], kd.shape[2]
        mkw = dict(enable_gqa=q.shape[1] != kd.shape[1])
        if kw.get("causal"):
            if nq == nk and not kw.get("kv_offset") and not kw.get("window"):
                mkw["is_causal"] = True
            else:
                i = torch.arange(nq, device=dev)[:, None] + kw.get(
                    "kv_offset", 0)
                j = torch.arange(nk, device=dev)[None, :]
                ok = j <= i
                if kw.get("window"):
                    ok = ok & (j > i - kw["window"])
                mkw["attn_mask"] = ok
        kd, vd = kd.to(q.dtype), vd.to(q.dtype)
        sdpa_ms[key] = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q, kd, vd, **mkw),
            iters=10)
        return sdpa_ms[key]

    def row(label, fn, q, k, v, sc, kw, key, kd, vd):
        fn()
        torch.cuda.synchronize()
        prof = kernel_times(fn, iters=5)
        mine = {n: prof.ms[n] / 5 for n in prof.ms
                if any(w in n for w in ("flash_fwd", "fa1", "FillFunctor"))}
        ms = sum(mine.values())
        b, h, nq, d = q.shape
        nbytes = (sum(x.numel() * x.element_size() for x in (q, k, v))
                  + sum(x.numel() * 4 for x in sc.values())
                  + b * h * nq * (4 * d + 4))
        flops = 4.0 * b * h * pairs(nq, k.shape[2], **kw) * d
        rate = 495e12 if q.dtype == torch.float32 else 989e12
        t_b, t_o = nbytes / 3.35e12 * 1e3, flops / rate * 1e3
        bound, by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
        lib = sdpa(key, q, kd, vd, kw)
        parts = ", ".join(f"{n.replace('void ', '').split('(')[0][:40]} "
                          f"{t:.4f}" for n, t in mine.items())
        print(f"{sys.argv[1]} fwd {label}: kernel {ms:.4f} ms per call "
              f"[{parts}]; bound {bound:.4f} ms ({by}): "
              f"{100 * bound / ms:.1f}%; SDPA {lib:.4f} ms ({card})",
              flush=True)

    if only_crossing:
        crossing_rows(ff, inputs, pinned, row)
        return
    gemma = (8, 8, 4, 512, 3584, 256)
    window = dict(causal=True, window=1024, kv_offset=1024)
    shapes = [("Gemma prefix", gemma, {}),
              ("Gemma windowed prefix", (8, 8, 4, 512, 1024, 256), window)]
    for name, shape, kw in shapes:
        for qtype in (None, "int8", "fp8", "mixed"):
            if qtype == "mixed" and kw:
                continue
            q, k, v, sc, kd, vd = inputs(*shape, qtype)
            for qq in ((False, True) if qtype and not kw else (False,)):
                for form, kn in (("bound", "K1b"), ("kmajor", "K5")):
                    row(f"{kn} d=256 {name} {qtype or 'bf16'}"
                        + (" quantize_q" if qq else ""),
                        pinned(form, q, k, v, sc, kw, qq), q, k, v, sc, kw,
                        (name, "bf16"), kd, vd)
            del q, k, v, sc, kd, vd
    q, k, v, sc, kd, vd = inputs(1, 8, 4, 8192, 8192, 256, None)
    causal = dict(causal=True)
    row("K5 d=256 [1, 8, 8192, 256] causal bf16",
        pinned("kmajor", q, k, v, sc, causal), q, k, v, sc, causal,
        ("8192 causal", "bf16"), kd, vd)
    del q, k, v, kd, vd
    for name, shape, kw, qtype, form, kn in (
            ("Gemma prefix", gemma, {}, "int8", "bound", "K1b"),
            ("Gemma prefix", gemma, {}, None, "bound", "K1b"),
            ("Gemma windowed prefix", (8, 8, 4, 512, 1024, 256), window,
             "int8", "kmajor", "K5")):
        q, k, v, sc, kd, vd = inputs(*shape, qtype, torch.float32)
        if qtype is None:  # an fp32 Q over a bf16 cache (BF16KV)
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        row(f"{kn} fp32 Q d=256 {name} {qtype or 'bf16'} K/V",
            pinned(form, q, k, v, sc, kw), q, k, v, sc, kw,
            (name, "fp32"), kd, vd)
        del q, k, v, kd, vd
    prefix = (8, 16, 4, 512, 3584, 128)
    for name, shape, qtype in (("Gemma prefix", gemma, "int8"),
                               ("prefix d=128", prefix, None),
                               ("prefix d=128", prefix, "int8")):
        q, k, v, sc, kd, vd = inputs(*shape, qtype, torch.float16)
        for form, kn in (("bound", "K1b"), ("kmajor", "K5")):
            row(f"{kn} fp16 {name} {qtype or 'fp16'}",
                pinned(form, q, k, v, sc, {}), q, k, v, sc, {},
                (name, "fp16"), kd, vd)
        del q, k, v, kd, vd
    # d = 128: the 246M model's prefix reads and their windowed slice
    for name, shape, kw in (("prefix", prefix, {}),
                            ("windowed prefix", (8, 16, 4, 512, 1024, 128),
                             window)):
        for qtype in (None, "int8", "fp8", "mixed"):
            if qtype == "mixed" and kw:
                continue
            q, k, v, sc, kd, vd = inputs(*shape, qtype)
            forms = [("bound", "K1b"), ("kmajor", "K5")]
            if not kw and qtype in (None, "int8"):
                forms.insert(0, ("online", "K1"))
            for qq in ((False, True) if qtype and not kw else (False,)):
                for form, kn in forms:
                    if form == "online" and qq:
                        continue
                    row(f"{kn} d=128 {name} {qtype or 'bf16'}"
                        + (" quantize_q" if qq else ""),
                        pinned(form, q, k, v, sc, kw, qq), q, k, v, sc, kw,
                        (name + " d=128", "bf16"), kd, vd)
            del q, k, v, sc, kd, vd
    # K5 on long causal calls (SDPA `is_causal` beside them)
    for n in (6144, 16384):
        q, k, v, sc, kd, vd = inputs(1, 16, 16, n, n, 128, None)
        row(f"K5 d=128 [1, 16, {n}, 128] causal bf16",
            pinned("kmajor", q, k, v, sc, causal), q, k, v, sc, causal,
            (n, "bf16"), kd, vd)
        del q, k, v, kd, vd
    crossing_rows(ff, inputs, pinned, row)
    for shape, online in (((1, 16, 16, 4096, 4096, 128), True),
                          ((8, 8, 4, 512, 512, 256), True),
                          ((1, 8, 8, 4096, 4096, 256), False)):
        q, k, v, sc, kd, vd = inputs(*shape, None)
        b, h, hkv, n, _, d = shape
        if online:
            row(f"K1 d={d} [{b}, {h}, {n}, {d}] causal",
                pinned("online", q, k, v, sc, causal), q, k, v, sc, causal,
                (shape, "bf16"), kd, vd)
        if shape[0] == 1:
            row(f"K8 d={d} [{b}, {h}, {n}, {d}] causal",
                lambda: fa1_attention(q, k, v, causal=True), q, k, v, sc,
                causal, (shape, "bf16"), kd, vd)
            if d == 128:
                row(f"K8 d={d} [{b}, {h}, {n}, {d}] not causal",
                    lambda: fa1_attention(q, k, v), q, k, v, sc, {},
                    (shape, "bf16 full"), kd, vd)
        del q, k, v, kd, vd


def crossing_rows(ff, inputs, pinned, row):
    """The crossing of K5's two walks under a bf16 Q at d <= 128, by the
    rule and (where the checkout has it) each walk forced (`_forced_walk`:
    over bf16 K/V both forced rows are the Q-major walk): one 512-row
    chunk per sequence over a 16384-token fp8 cache, and over a bf16 one
    (causal, kv_offset 15872), B = 1, 2, 4, 8 (H=16, Hkv=4); [1, 16, N, d]
    causal over bf16 K/V at d = 64 and 128, N = 512 ... 4096, and at N =
    512 and 2048 under GQA 16:4 (d = 128): Q-major grids of 64 to 512
    CTAs."""
    import torch

    chunk = dict(causal=True, kv_offset=16384 - 512)
    cases = [(f"B={b} 512x16384 fp8", (b, 16, 4, 512, 16384, 128), "fp8",
              {}) for b in (1, 2, 4, 8)]
    cases += [(f"B={b} 512x16384 bf16 causal", (b, 16, 4, 512, 16384, 128),
               None, chunk) for b in (1, 2, 4, 8)]
    cases += [(f"[1, 16, {n}, {d}] causal bf16", (1, 16, 16, n, n, d), None,
               dict(causal=True)) for d in (64, 128)
              for n in (512, 1024, 2048, 4096)]
    cases += [(f"[1, 16/4, {n}, 128] causal bf16", (1, 16, 4, n, n, 128),
               None, dict(causal=True)) for n in (512, 2048)]
    for label, shape, qtype, kw in cases:
        q, k, v, sc, kd, vd = inputs(*shape, qtype)
        walks = [("rule", None)]
        if hasattr(ff, "_kmajor_q_walk"):
            walks += [("Q-major", True), ("K-major", False)]
        for walk_label, walk in walks:
            with _forced_walk(ff, walk):
                row(f"K5 d={shape[-1]} {label} ({walk_label})",
                    pinned("kmajor", q, k, v, sc, kw), q, k, v, sc, kw,
                    (label,), kd, vd)
        del q, k, v, kd, vd
        torch.cuda.empty_cache()


class _forced_walk:
    """Within the block, K5 under a 2-byte or int8 Q takes the Q-major
    walk (`walk` True) or the key split (False) at any shape, by replacing
    `ops.flash_fwd._kmajor_q_walk`; None leaves the rule. Over 2-byte K/V
    (`codes` false) the Q-major walk always: K5 has no 2-byte key split
    since the Q-major walk led it at every grid measured (PERF.md §6)."""

    def __init__(self, ff, walk):
        self.ff, self.walk, self.saved = ff, walk, None

    def __enter__(self):
        if self.walk is not None:
            self.saved = self.ff._kmajor_q_walk
            self.ff._kmajor_q_walk = lambda d, q_f32, codes=False, **_: (
                not q_f32 and (d == 256 or not codes or self.walk))

    def __exit__(self, *exc):
        if self.saved is not None:
            self.ff._kmajor_q_walk = self.saved


def _decode_rows(mk, gen, dev, report, sweep):
    """K6 at 640 and 4224 live tokens and K7 at 4224 in 128-token pages,
    bf16, d=128, each call on a cold L2; with `sweep`, again under each
    split size where the checkout splits the context."""
    import torch

    from cuda_flashattention_torch.ops import decode as dec
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.paged import paged_decode_attention

    # the decode kernels on a cold L2, peaked inputs as chip_smoke feeds them
    b, h, hkv, page = 8, 16, 4, 128
    q1 = mk(b, h, 128, peak=8)
    decode_rows = []
    for live in (640, 4224):
        k, v = mk(b, hkv, live, 128, peak=4), mk(b, hkv, live, 128)
        lens = torch.full((b,), live, dtype=torch.int32, device=dev)
        decode_rows.append((f"K6 decode {live} live", "decode_k",
                            lambda k=k, v=v, lens=lens: decode_attention(
                                q1, k, v, lens)))
    # the 4224 live tokens again, in 128-token pages behind a shuffled table
    n_pages = b * live // page
    k_pages = k.reshape(b, hkv, live // page, page, 128).permute(
        0, 2, 1, 3, 4).reshape(n_pages, hkv, page, 128)
    v_pages = v.reshape(b, hkv, live // page, page, 128).permute(
        0, 2, 1, 3, 4).reshape(n_pages, hkv, page, 128)
    order = torch.randperm(n_pages, generator=gen, device=dev)
    k_pages, v_pages = k_pages[order].contiguous(), v_pages[order].contiguous()
    table = torch.argsort(order).to(torch.int32).reshape(b, live // page)
    decode_rows.append(("K7 paged decode 4224 live", "paged_k",
                        lambda: paged_decode_attention(
                            q1, k_pages, v_pages, table, lens)))
    for label, word, fn in decode_rows:
        report(label, fn, word, 40, cold=True)
    if sweep and hasattr(dec, "SPLIT_KEYS"):
        keys = dec.SPLIT_KEYS
        try:
            for size in (64, 128, 256, 512, 1 << 20):
                dec.SPLIT_KEYS = size
                name = "unsplit" if size > live else f"split {size}"
                for label, word, fn in decode_rows:
                    report(f"{label}, {name}", fn, word, 40, cold=True)
        finally:
            dec.SPLIT_KEYS = keys
    _decode_forms(mk, gen, dev, report)


def _decode_forms(mk, gen, dev, report):
    """K6 / K7 at 4224 live of 4352 keys, cold, over the other cache types
    and q types, at the Gemma width and at narrow heads, each beside the
    library call on its bf16 keys."""
    import torch
    import torch.nn.functional as F

    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.paged import (
        paged_decode_attention, paged_decode_step, PagedKVCache)
    from cuda_flashattention_torch.ops.quant import quantize_kv

    live, cap, page = 4224, 4352, 128

    def inputs(b, h, hkv, d):
        q = mk(b, h, d, peak=8)
        k, v = mk(b, hkv, cap, d, peak=4), mk(b, hkv, cap, d)
        return q, k, v, torch.full((b,), live, dtype=torch.int32, device=dev)

    def pools(k, v, ks=None, vs=None):
        """The first `live` keys of each sequence in `page`-token pages
        behind a shuffled table."""
        b, hkv, _, d = k.shape
        per = live // page
        order = torch.randperm(b * per, generator=gen, device=dev)

        def paged(x):
            x = x[:, :, :live].reshape(b, hkv, per, page, *x.shape[3:])
            x = x.transpose(1, 2).reshape(b * per, hkv, page, *x.shape[4:])
            return x[order].contiguous()
        table = torch.argsort(order).to(torch.int32).reshape(b, per)
        return (paged(k), paged(v), None if ks is None else paged(ks),
                None if vs is None else paged(vs), table)

    def sdpa(label, q, k, v, lens):
        b, h, d = q.shape
        mask = (torch.arange(k.shape[2], device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        report(f"SDPA {label}", lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True), None,
            40, cold=True)

    q, k, v, lens = inputs(8, 16, 4, 128)
    rows = []
    for qtype in ("int8", "fp8", "mixed"):
        kv = quantize_kv(k, v, qtype)
        sc = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
        rows.append((f"K6 {qtype} 4224 live", "decode_k",
                     lambda kv=kv, sc=sc: decode_attention(
                         q, kv.k_q, kv.v_q, lens, **sc)))
        if qtype == "int8":
            rows.append(("K6 int8 + quantize_q 4224 live", "decode_k",
                         lambda kv=kv, sc=sc: decode_attention(
                             q, kv.k_q, kv.v_q, lens, quantize_q=True,
                             **sc)))
            kp, vp, ksp, vsp, table = pools(kv.k_q, kv.v_q, kv.k_scale,
                                            kv.v_scale)
            rows.append(("K7 int8 4224 live", "paged_k",
                         lambda kp=kp, vp=vp, ksp=ksp, vsp=vsp, table=table:
                         paged_decode_attention(q, kp, vp, table, lens,
                                                k_scale=ksp, v_scale=vsp)))
    qf, kf, vf = q.float(), k.float(), v.float()
    rows.append(("K6 fp32 q over fp32 4224 live", "decode_k",
                 lambda: decode_attention(qf, kf, vf, lens)))
    kp, vp, _, _, table = pools(k, v)
    cache = PagedKVCache(kp, vp, None, None, table, lens.clone())
    rows.append(("paged step (paged_decode_step) 4224 live", "paged_k",
                 lambda: paged_decode_step(q, cache)))
    sdpa_rows = [("d=128 4224 live", q, k, v, lens)]
    q2, k2, v2, lens2 = inputs(8, 8, 4, 256)
    kv2 = quantize_kv(k2, v2, "int8")
    kp2, vp2, _, _, table2 = pools(k2, v2)
    rows += [
        ("K6 d=256 4224 live", "decode_k",
         lambda: decode_attention(q2, k2, v2, lens2)),
        ("K6 d=256 int8 4224 live", "decode_k",
         lambda: decode_attention(q2, kv2.k_q, kv2.v_q, lens2,
                                  k_scale=kv2.k_scale, v_scale=kv2.v_scale)),
        ("K7 d=256 4224 live", "paged_k",
         lambda: paged_decode_attention(q2, kp2, vp2, table2, lens2))]
    sdpa_rows.append(("d=256 4224 live", q2, k2, v2, lens2))
    for d in (8, 16, 32, 7, 91):
        qn, kn, vn, lensn = inputs(8, 16, 4, d)
        rows.append((f"K6 d={d} 4224 live", "decode_k",
                     lambda qn=qn, kn=kn, vn=vn, lensn=lensn:
                     decode_attention(qn, kn, vn, lensn)))
        sdpa_rows.append((f"d={d} 4224 live", qn, kn, vn, lensn))
    for label, word, fn in rows:
        report(label, fn, word, 40, cold=True)
    # the wrapper warm and back to back: host time per call
    q6, k6, v6 = q, k[:, :, :640].contiguous(), v[:, :, :640].contiguous()
    lens6 = torch.full((8,), 640, dtype=torch.int32, device=dev)
    report("K6 640 live, warm", lambda: decode_attention(q6, k6, v6, lens6),
           "decode_k", 200)
    report("paged step 4224 live, warm", lambda: paged_decode_step(q, cache),
           "paged_k", 200)
    for row in sdpa_rows:
        sdpa(*row)


if __name__ == "__main__":
    main(*(sys.argv[1:3] or ["."]))
