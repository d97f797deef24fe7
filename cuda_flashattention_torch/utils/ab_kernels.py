"""Time the kernels of one checkout of this package, to compare two
commits on one card within one call.

    python3 cuda_flashattention_torch/utils/ab_kernels.py <checkout root>
                                         [K9 | decode | decode-sweep]

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
For each: the wrapper's median ms (CUDA events) and the device ms per
call of its kernels (torch.profiler), with each kernel's ms per launch.
The K4 rows run first, so that both checkouts reach them after the same
work.
Unpack the parent commit beside the change (`git archive <commit> | tar
-x -C <dir>`) and run parent, change, change, parent: two cards, or two
calls, differ by more than two commits do. Needs a CUDA device.
"""

import sys


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
