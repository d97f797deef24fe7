#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, paged-serving and training
paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

1. Environment: needs `torch.cuda.is_available()`; prints the card's name
   and power limit (nvidia-smi), the torch, CUDA and nvcc versions.
2. Build: compiles the package's CUDA kernels (csrc/*.cu) with nvcc into
   the git-ignored build directory, and prints the time it took.
3. Kernels against their plain PyTorch versions, on the card, in bf16, at
   the serving model's shapes: the forward (K1) and the decode (K6), then
   K6's other forms at 640 live tokens of a 1024-token cache: int8, fp8
   and mixed caches, each with and without `window=256`, per-sequence
   `windows`, and `quantize_q` on int8 and mixed. O and LSE must agree
   within 5e-3 (the repo's bf16 gate); for K6, K7 and K8, whose inputs
   are drawn peaked (Q x8, K x4) so that |O| stays ~0.1-0.5 over thousands
   of keys, O must also agree within 2e-2 of the plain version's largest
   |O|, which must be > 0. Each case prints the max |diff| and both
   median times (CUDA events around the wrapper; for K6's forms and K7
   also the kernel's own device time, from torch.profiler). K6 and K7
   are timed on a cold L2 cache, as a server's decode step finds it; K6
   is also timed under 1 to 16 query rows per KV head.
4. Main path of serving: the 246M GQA serving model (vocab 32000, d_model
   2048, 4 layers, 16 query heads over 4 KV heads, d_head 128, d_ff 5632,
   bf16; random weights from a seeded generator) runs `generate()` on
   B=8 prompts of 512 tokens for 128 new tokens, greedily: over a bf16
   cache, an int8 cache, and a mixed cache with `quantize_q`. The launch
   counts of each run must show that prefill went through K1 once per
   layer and decode through K6 once per layer and token. Each quantized
   run is also replayed on the bf16 run's tokens, so that its last-step
   logits meet the bf16 run's on the same context (gate 0.25). Chunked
   prefill must agree with whole prefill, and prefill through the kernels
   with prefill through the plain attention functions.
5. Main path of paged serving, at pools of 4096 pages x 4 KV heads x 128
   tokens x d 128 (512 MiB per bf16 pool), B=8, H=16, 64 table slots per
   sequence: 4096 tokens per sequence are prefilled in eight page-aligned
   chunks through `reserve_for` + `paged_bulk_append`, each chunk's
   attention being `paged_prefix_attention` (K7) + K1 on the chunk +
   `combine_partials`, held against K1 over the contiguous K/V, and the
   prefix form alone (512 rows per query head over the 4096 tokens)
   against `paged_decode_attention_plain`; then 128 steps of
   `reserve_for` + `paged_append` + `paged_decode_step` (K7), whose O and
   LSE must equal bit for bit those of the contiguous `decode_attention`
   (K6) on a shadow cache at every 16th step, and meet
   `paged_decode_attention_plain` once; a sequence is retired, its pages
   counted and reused by a new sequence, and decode goes on. The decode
   part is repeated over int8 and mixed pools and with `window=1024`.
6. FA1 (K8) against its plain version at B=1, H=16, N=4096, d=128,
   causal and not (gate 5e-3), with K1's time at the same shape.
7. Backward kernels against their plain version, on the card, in bf16:
   the fused K4 (`fused=True`) and the split K2 + K3 (`fused=False`), each
   against `flash_attention_backward_plain` and against each other, at the
   training shape (B=1, H=16, N=4096, d=128, causal), a GQA ragged shape,
   a `kv_offset` = -20 case with empty rows and unseen keys, and a
   non-causal Nq != Nk case. Gate per gradient: max |diff| <= 2e-2 ·
   max |plain|, with max |plain| > 0. Each case prints both numbers, the
   wrapper's median times (CUDA events) and each kernel's device time
   (torch.profiler); K1 is also checked at the training shape, bf16 out.
8. Main path of training: the 271M training model (vocab 32000, d_model
   2048, 4 layers, 16 query heads over 16 KV heads, d_head 128, d_ff 5632,
   bf16; random weights from a seeded generator) takes `make_train_step`
   steps with SGD(1e-4) on one seeded batch of B=1 × T=4096. After a
   warm-up, 5 timed steps (median ms, tokens/s, TFLOP/s counted as the
   JAX bench counts them) must launch K1 and K4 once per layer and step,
   and K2, K3 never; a torch.profiler breakdown of one step follows. One
   step's loss and gradients through the kernels must agree with the same
   through the plain attention functions (loss within 2e-2, each
   parameter's gradient within 5e-2 relative L2), and with the same
   through the split backward, whose run must launch K2 and K3 once per
   layer. Ten Adam(1e-3) steps on a fresh model must lower the loss.

Each path is driven with the launch counts set to 0 just before it and
read just after; a kernel's `launches` in the JSON line is its sum over
those runs (the three `generate()` runs, the paged lifecycle, the two FA1
calls, the timed training steps, the split-backward step). Launches made
to compare a kernel with its plain version or to time it are not in it.

Each kernel's `bound_ms` is the least time the card could take for the
same call: the larger of its bytes (each input read once, each output
written once; only the live, in-window part of a cache) over the card's
memory rate and its matmul operations (the visible half when causal) over
the card's bf16 rate, from the data sheet of the H100 SXM (3.35 TB/s,
989 TFLOP/s at a 700 W power limit). `library_ms` is one call of
`torch.nn.functional.scaled_dot_product_attention` (or its autograd
backward) on the same inputs, timed here as a yardstick; the package
never calls it.

Its last lines: the card's name and power limit, one JSON object
describing each kernel, then `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

GATE = 5e-3  # bf16 kernel vs its plain version, on O and LSE
# O of the decode, paged and FA1 kernels is also held to this share of the
# plain version's largest |O|, which must be > 0: an absolute gate alone
# passes a wrong V path wherever the outputs themselves are small. Their
# inputs are drawn peaked (Q x8, K x4), so that a softmax over thousands of
# keys still leaves |O| ~ 0.1-0.5, where the absolute gate is the tighter.
REL_GATE = 2e-2
Q_PEAK, K_PEAK = 8.0, 4.0
# Logits of the bf16 model: chunked vs whole prefill, and kernels vs plain
# attention. The attention outputs differ by fp32 rounding, which flips
# bf16 roundings of activations; through 4 layers and a d_model-wide
# unembedding that leaves a few bf16 ulps on logits of magnitude ~1-4.
LOGIT_GATE = 0.125
# Last-step logits over a quantized cache against the bf16 cache, on the
# same tokens: the cache's K and V carry up to 0.4% (int8) or 6% (e4m3)
# error per element on top of the rounding flips above.
QUANT_LOGIT_GATE = 0.25

CFG_KW = dict(vocab_size=32000, d_model=2048, n_layers=4, n_heads=16,
              n_kv_heads=4, d_head=128, d_ff=5632, max_seq=8192)
BATCH, PROMPT, NEW = 8, 512, 128

# the paged pools: what one card of a server would hold for this model
N_PAGES, PAGE, MAX_PAGES = 4096, 128, 64
PAGED_PREFILL, PAGED_CHUNK, PAGED_STEPS = 4096, 512, 128
PAGED_WINDOW = 1024

# Backward kernels against their plain version, per gradient: the bf16
# roundings of P and dS flip differently under another summation order;
# an absolute gate near the gradients' size (~1e-2) would pass all zeros.
BWD_GATE = 2e-2
# The training model through the kernels against the same through the
# plain attention functions: loss (~10.5) and relative L2 per gradient.
LOSS_GATE = 2e-2
GRAD_GATE = 5e-2
# the repo's training config (bench.py sec_train): 271M parameters
TRAIN_KW = dict(vocab_size=32000, d_model=2048, n_layers=4, n_heads=16,
                n_kv_heads=16, d_head=128, d_ff=5632, max_seq=4096)
TRAIN_T = 4096
TIMED_STEPS = 5
ADAM_STEPS = 10

# H100 SXM data sheet, dense, at a 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def _run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                               timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the bf16 matmul rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _kernel_of(name: str) -> str:
    """The package kernel a profiler kernel name belongs to, else ''."""
    for pattern, label in ((r"flash_bwd_kv_kernel<\d+, true>", "K4"),
                           (r"flash_bwd_kv_kernel<\d+, false>", "K2"),
                           (r"flash_bwd_q_kernel", "K3"),
                           (r"flash_fwd_kernel", "K1")):
        if re.search(pattern, name):
            return label
    return ""


def _group_of(name: str) -> str:
    """Breakdown group of a profiler kernel name."""
    label = _kernel_of(name)
    if label:
        return label
    if re.search(r"gemm|nvjet|cutlass|xmma|cublas", name, re.I):
        return "cuBLAS GEMM"
    return "elementwise/reduction/copy"


def main() -> int:
    import torch

    # ---- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from cuda_flashattention_torch import _build
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.models.generate import generate
    from cuda_flashattention_torch.ops import attention
    from cuda_flashattention_torch.ops.decode import (
        decode_attention, decode_attention_plain)
    from cuda_flashattention_torch.ops.fa1 import (
        fa1_attention, fa1_attention_plain)
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward, flash_attention_backward_plain)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward, flash_attention_forward_plain)
    from cuda_flashattention_torch.ops.kv_cache import (
        append as cache_append, init_cache)
    from cuda_flashattention_torch.ops.paged import (
        PageAllocator, init_paged_cache, paged_append, paged_bulk_append,
        paged_decode_attention, paged_decode_attention_plain,
        paged_decode_step, paged_prefix_attention)
    from cuda_flashattention_torch.ops.quant import quantize_kv
    from cuda_flashattention_torch.parallel.ring import combine_partials
    from cuda_flashattention_torch.utils.profiling import kernel_times
    from cuda_flashattention_torch.utils.timing import (
        attention_flops, cuda_time_ms)

    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()
    card = card[0] if card else "nvidia-smi gave nothing"
    print(f"[env] card: {card}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}")
    nvcc = _build.find_nvcc()
    print(f"[env] nvcc {nvcc}: {_run([nvcc, '--version']).splitlines()[-1]}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'%.2f s' % built if built is not None else 'cached'})",
          flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)

    def mk(*shape, peak=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) - 0.5)
                * peak).to(torch.bfloat16)

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item()

    def o_close(o, o_ref):
        """(max |o - o_ref|, max |o_ref|, whether O passes both gates)."""
        e, ref = diff(o, o_ref), o_ref.float().abs().max().item()
        return e, ref, ref > 0 and e <= min(GATE, REL_GATE * ref)

    bwd_launches = flash_attention_backward.launches

    def zero_counts():
        flash_attention_forward.launches = 0
        decode_attention.launches = 0
        paged_decode_attention.launches = 0
        fa1_attention.launches = 0
        for name in bwd_launches:
            bwd_launches[name] = 0

    def sdpa_ms(q, k, v, before=None, **kw):
        """The library call: one scaled_dot_product_attention on [B,H,N,d]
        inputs, K/V heads shared by the query heads of a group."""
        return cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=q.shape[1] != k.shape[1], **kw),
            before=before)

    # Decode is timed cold: between two calls on one layer's cache a
    # server streams the other layers' caches and all the weights through
    # the 50 MB L2 cache, so a write of 256 MiB goes before each timed call.
    l2_flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def launch_ms(prof, belongs):
        """Mean device ms per recorded launch of the kernels whose name
        `belongs` accepts (the profiler may lose launches of a window);
        NaN when it recorded none."""
        names = [n for n in prof.ms if belongs(n)]
        n_launches = sum(prof.count[n] for n in names)
        return (sum(prof.ms[n] for n in names) / n_launches if n_launches
                else float("nan"))

    def device_ms(fn, pattern, iters=5):
        """Mean device ms per launch of the kernels whose name matches
        `pattern` (torch.profiler), each call on a cold L2 cache: the
        kernel alone, without the small launches and host work of its
        wrapper."""
        prof = kernel_times(lambda: (l2_flush.zero_(), fn()), iters=iters)
        return launch_ms(prof, lambda n: re.search(pattern, n))

    failures = []
    # per kernel: ms, plain_ms, bound_ms, bound_by, library_ms, max_abs_err
    rec = {kn: dict(max_abs_err=0.0) for kn in
           ("K1", "K2", "K3", "K4", "K6", "K7", "K8")}
    # launches on the main paths, summed over the runs that drive them
    launches = {kn: 0 for kn in rec}

    # ---- 3. kernels vs their plain versions ------------------------------
    # (name, B, H, Hkv, Nq, Nk, causal); d = 128, fp32 out as prefill asks
    fwd_cases = [
        ("prefill 512 causal", 8, 16, 4, 512, 512, True),
        ("ragged 500 causal", 8, 16, 4, 500, 500, True),
        ("chunk prefix 128x384", 8, 16, 4, 128, 384, False),
        ("4096 causal", 2, 16, 4, 4096, 4096, True),
    ]
    for name, b, h, hkv, nq, nk, causal in fwd_cases:
        q, k, v = mk(b, h, nq, 128), mk(b, hkv, nk, 128), mk(b, hkv, nk, 128)
        kw = dict(causal=causal, out_dtype=torch.float32)
        o, lse = flash_attention_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        o_p, lse_p = flash_attention_forward_plain(q, k, v, **kw)
        e_o, e_l = diff(o, o_p), diff(lse, lse_p)
        ms = cuda_time_ms(lambda: flash_attention_forward(q, k, v, **kw))
        ms_p = cuda_time_ms(
            lambda: flash_attention_forward_plain(q, k, v, **kw), iters=5)
        print(f"[K1] {name}: B={b} H={h} Hkv={hkv} Nq={nq} Nk={nk} "
              f"max|dO|={e_o:.3e} max|dLSE|={e_l:.3e} kernel {ms:.4f} ms "
              f"plain {ms_p:.4f} ms ({card})", flush=True)
        rec["K1"]["max_abs_err"] = max(rec["K1"]["max_abs_err"], e_o, e_l)
        if "ms" not in rec["K1"]:  # the first case: the prefill's shape
            rec["K1"].update(
                ms=ms, plain_ms=ms_p,
                library_ms=sdpa_ms(q, k, v, is_causal=causal),
                **_bound(_nbytes(q, k, v, o, lse),
                         attention_flops(b, h, nq, nk, 128, causal=causal)))
            print(f"[K1] {name}: bound {rec['K1']['bound_ms']:.4f} ms "
                  f"({rec['K1']['bound_by']}), library call "
                  f"{rec['K1']['library_ms']:.4f} ms", flush=True)
        if not (e_o <= GATE and e_l <= GATE):
            failures.append(f"K1 {name}: {e_o:.3e}/{e_l:.3e} > {GATE}")
        del q, k, v, o, lse, o_p, lse_p

    # the serving decode: cache of prompt + new tokens, per-seq lengths
    max_len = PROMPT + NEW
    dec_lengths = [1, 63, 64, 513, 640, 0, 200, 577]
    q = mk(8, 16, 128, peak=Q_PEAK)
    k, v = mk(8, 4, max_len, 128, peak=K_PEAK), mk(8, 4, max_len, 128)
    for name, lens in (("ragged lengths", dec_lengths),
                       ("full cache", [max_len] * 8)):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        o, lse = decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        o_p, lse_p = decode_attention_plain(q, k, v, lengths)
        (e_o, ref, ok), e_l = o_close(o, o_p), diff(lse, lse_p)
        ms = cuda_time_ms(lambda: decode_attention(q, k, v, lengths),
                          before=l2_flush.zero_)
        ms_w = cuda_time_ms(lambda: decode_attention(q, k, v, lengths))
        ms_p = cuda_time_ms(lambda: decode_attention_plain(q, k, v, lengths),
                            before=l2_flush.zero_)
        print(f"[K6] {name}: B=8 H=16 Hkv=4 max_len={max_len} "
              f"lengths={lens} max|dO|={e_o:.3e} (max|O| {ref:.3e}) "
              f"max|dLSE|={e_l:.3e} kernel {ms:.4f} ms ({ms_w:.4f} ms with the cache warm in "
              f"L2) plain {ms_p:.4f} ms ({card})", flush=True)
        rec["K6"]["max_abs_err"] = max(rec["K6"]["max_abs_err"], e_o, e_l)
        rec["K6"].update(ms=ms, plain_ms=ms_p)  # the last: the full cache
        if not (ok and e_l <= GATE):
            failures.append(f"K6 {name}: dO {e_o:.3e} (max|O| {ref:.3e}) "
                            f"dLSE {e_l:.3e}")
    # bound and library call at the full cache: every key is live
    live = torch.arange(max_len, device=dev)[None, :] < lengths[:, None]
    rec["K6"].update(
        library_ms=sdpa_ms(q[:, :, None], k, v, before=l2_flush.zero_,
                           attn_mask=live[:, None, None, :]),
        **_bound(_nbytes(q, k, v, lengths, o, lse),
                 attention_flops(8, 16, 1, max_len, 128)))
    print(f"[K6] full cache: bound {rec['K6']['bound_ms']:.4f} ms "
          f"({rec['K6']['bound_by']}), library call (one-row query, length "
          f"mask) {rec['K6']['library_ms']:.4f} ms", flush=True)
    # what a CTA's row tile costs: the same full cache under 1 to 16 query
    # rows per KV head (tiles of 1, 4, 4, 8 and two of 8 rows)
    row_ms = {}
    for rows in (1, 2, 4, 8, 16):
        qr = mk(8, 4 * rows, 128, peak=Q_PEAK)
        row_ms[rows] = cuda_time_ms(
            lambda: decode_attention(qr, k, v, lengths),
            before=l2_flush.zero_)
    print(f"[K6] full cache, ms by query rows per KV head: "
          + ", ".join(f"{r}: {t:.4f}" for r, t in row_ms.items())
          + f" ({card})", flush=True)
    del q, k, v, o, lse, o_p, lse_p, qr

    # K6's other forms: 640 live tokens of a 1024-token cache
    cache_n, live_n = 1024, PROMPT + NEW
    q = mk(8, 16, 128, peak=Q_PEAK)
    k, v = mk(8, 4, cache_n, 128, peak=K_PEAK), mk(8, 4, cache_n, 128)
    lengths = torch.full((8,), live_n, dtype=torch.int32, device=dev)
    per_seq = torch.tensor([5, 640, 64, 1, 0, 300, 700, 256],
                           dtype=torch.int32, device=dev)
    forms = [(qt, kw) for qt in ("int8", "fp8", "mixed")
             for kw in (dict(), dict(window=256), dict(windows=per_seq))]
    forms += [(qt, dict(quantize_q=True, **kw)) for qt in ("int8", "mixed")
              for kw in (dict(), dict(window=256))]
    forms += [(None, dict(window=256)), (None, dict(windows=per_seq))]
    for qtype, kw in forms:
        if qtype is None:
            args, skw = (q, k, v, lengths), {}
        else:
            kv = quantize_kv(k, v, qtype)
            args = (q, kv.k_q, kv.v_q, lengths)
            skw = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
        o, lse = decode_attention(*args, **skw, **kw)
        torch.cuda.synchronize()
        o_p, lse_p = decode_attention_plain(*args, **skw, **kw)
        (e_o, ref, ok), e_l = o_close(o, o_p), diff(lse, lse_p)
        ms = cuda_time_ms(lambda: decode_attention(*args, **skw, **kw),
                          before=l2_flush.zero_)
        ms_p = cuda_time_ms(
            lambda: decode_attention_plain(*args, **skw, **kw),
            before=l2_flush.zero_)
        ms_d = device_ms(lambda: decode_attention(*args, **skw, **kw),
                         "::decode_kernel<")
        label = ", ".join(f"{n}={'per-sequence' if n == 'windows' else x}"
                          for n, x in kw.items()) or "no window"
        print(f"[K6] {qtype or 'bf16'} cache, {label}: {live_n} live of "
              f"{cache_n} max|dO|={e_o:.3e} (max|O| {ref:.3e}) "
              f"max|dLSE|={e_l:.3e} wrapper "
              f"{ms:.4f} ms (kernel alone {ms_d:.4f} ms) plain {ms_p:.4f} ms "
              f"({card})", flush=True)
        rec["K6"]["max_abs_err"] = max(rec["K6"]["max_abs_err"], e_o, e_l)
        if not (ok and e_l <= GATE):
            failures.append(f"K6 {qtype} {label}: dO {e_o:.3e} (max|O| "
                            f"{ref:.3e}) dLSE {e_l:.3e}")
    _check(not failures, "; ".join(failures))
    del q, k, v, o, lse, o_p, lse_p, args, skw

    # ---- 4. main path: generate() on the 246M serving model --------------
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **CFG_KW)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tfm.Transformer(cfg, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    print(f"[main] model {n_params / 1e6:.1f}M params, B={BATCH} "
          f"prompt={PROMPT} new={NEW}, greedy", flush=True)
    generate(model, prompt, 2)  # warm-up: cuBLAS and allocator
    torch.cuda.synchronize()

    def generate_counted(label, **kw):
        """One `generate()` run of the main path between a zeroing and a
        reading of the launch counts."""
        zero_counts()
        t0 = time.perf_counter()
        out, logits = generate(model, prompt, NEW, **kw)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        n_fwd = flash_attention_forward.launches
        n_dec = decode_attention.launches
        print(f"[main] {label}: launches: forward {n_fwd} (expect "
              f"{cfg.n_layers}), decode {n_dec} (expect "
              f"{cfg.n_layers * NEW}); end-to-end generate "
              f"{BATCH * NEW / e2e_s:.1f} tok/s ({e2e_s:.3f} s) ({card})",
              flush=True)
        _check(n_fwd == cfg.n_layers, f"{label}: forward kernel launched "
               f"{n_fwd} times in the main path")
        _check(n_dec == cfg.n_layers * NEW, f"{label}: decode kernel "
               f"launched {n_dec} times in the main path")
        _check(tuple(out.shape) == (BATCH, PROMPT + NEW),
               f"{label}: tokens shape {tuple(out.shape)}")
        _check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
               f"{label}: tokens out of range")
        _check(bool(torch.equal(out[:, :PROMPT], prompt)),
               f"{label}: prompt not kept")
        _check(bool(torch.isfinite(logits).all()),
               f"{label}: non-finite logits")
        launches["K1"] += n_fwd
        launches["K6"] += n_dec
        return out, logits

    def prefill_and_replay(tokens, **kw):
        """Prefill alone (median of 5) and the decode loop alone, as
        generate runs it but fed `tokens` [B, PROMPT + NEW]: returns
        (prefill ms, decode seconds, prefill logits, last-step logits, the
        share of steps whose argmax is the fed token, cache bytes per
        token)."""
        quantize_q = kw.pop("quantize_q", False)
        prefill_s = []
        for _ in range(5):
            caches = tfm.init_caches(cfg, BATCH, max_len, device=dev, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg_first, caches = tfm.prefill(model, prompt, caches)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        picks = [torch.argmax(lg_first, dim=-1)]
        t0 = time.perf_counter()
        for i in range(NEW):
            lg, caches = tfm.decode_one(model, tokens[:, PROMPT + i],
                                        PROMPT + i, caches,
                                        quantize_q=quantize_q)
            picks.append(torch.argmax(lg, dim=-1))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        agree = (torch.stack(picks[:-1], dim=1) == tokens[:, PROMPT:]
                 ).float().mean().item()
        per_token = sum(_nbytes(*(x for x in (c.k, c.v, c.k_scale, c.v_scale)
                                  if x is not None))
                        for c in caches) / (BATCH * max_len)
        return (statistics.median(prefill_s) * 1e3, decode_s, lg_first, lg,
                agree, per_token)

    out, logits = generate_counted("bf16 cache")
    prefill_ms, decode_s, lg_whole, lg_last, agree, per_token = \
        prefill_and_replay(out)
    print(f"[main] bf16 cache: prefill {prefill_ms:.3f} ms (B={BATCH} x "
          f"{PROMPT}); decode {BATCH * NEW / decode_s:.1f} tok/s "
          f"({decode_s / NEW * 1e3:.3f} ms/step); cache "
          f"{per_token:.0f} bytes per token; replay reproduces "
          f"{agree:.3f} of the tokens, last logits max|d| "
          f"{diff(lg_last, logits):.3e} ({card})", flush=True)
    _check(agree >= 0.99, f"the replay of the bf16 run reproduced only "
           f"{agree:.3f} of its tokens")

    for label, kw in (("int8 cache", dict(qtype="int8")),
                      ("mixed cache, quantize_q",
                       dict(qtype="mixed", quantize_q=True))):
        out_q, logits_q = generate_counted(label, **kw)
        same = (out_q[:, PROMPT:] == out[:, PROMPT:]).float().mean().item()
        p_ms, d_s, _, lg_q, agree_q, per_q = prefill_and_replay(out, **kw)
        e_q = diff(lg_q, logits)
        print(f"[main] {label}: prefill {p_ms:.3f} ms; decode "
              f"{BATCH * NEW / d_s:.1f} tok/s ({d_s / NEW * 1e3:.3f} "
              f"ms/step); cache {per_q:.0f} bytes per token (bf16 "
              f"{per_token:.0f}); free-running greedy tokens equal to the "
              f"bf16 run's: {same:.3f}; on the bf16 run's tokens: argmax "
              f"agreement {agree_q:.3f}, last-step logits max|d| "
              f"{e_q:.3e} (gate {QUANT_LOGIT_GATE}) ({card})", flush=True)
        _check(e_q <= QUANT_LOGIT_GATE,
               f"{label}: last-step logits {e_q:.3e} from the bf16 cache's")
        _check(per_q < 0.55 * per_token,
               f"{label}: {per_q} cache bytes per token")
        del out_q, logits_q, lg_q

    # chunked prefill agrees with whole prefill
    caches = tfm.init_caches(cfg, BATCH, max_len, device=dev)
    lg_chunk, _ = tfm.prefill_chunked(model, prompt, caches, chunk=128)
    e_chunk = diff(lg_chunk, lg_whole)
    # prefill through the plain attention function agrees with the kernel
    caches = tfm.init_caches(cfg, BATCH, max_len, device=dev)
    with mock.patch.object(tfm, "flash_attention_forward",
                           lambda q, k, v, window=0, **kw:
                           flash_attention_forward_plain(q, k, v, **kw)):
        lg_plain, _ = tfm.prefill(model, prompt, caches)
    e_plain = diff(lg_plain, lg_whole)
    agree = (lg_plain.argmax(-1) == lg_whole.argmax(-1)).float().mean()
    print(f"[main] logits: chunked(128) vs whole max|d|={e_chunk:.3e}; "
          f"plain attention vs kernels max|d|={e_plain:.3e}, greedy "
          f"agreement {agree.item():.3f}; |logits| max "
          f"{lg_whole.abs().max().item():.3f} (gate {LOGIT_GATE})",
          flush=True)
    _check(e_chunk <= LOGIT_GATE, f"chunked prefill logits {e_chunk:.3e}")
    _check(e_plain <= LOGIT_GATE, f"plain-attention logits {e_plain:.3e}")
    del model, caches, out, logits, lg_whole, lg_chunk, lg_plain, lg_last

    # ---- 5. main path of paged serving -----------------------------------
    gen = torch.Generator(device=dev).manual_seed(2)
    b, h, hkv, d = BATCH, 16, 4, 128
    total = PAGED_PREFILL + PAGED_STEPS + 16
    # K, V and the chunks' queries are drawn flat: the prefill is held
    # against K1, which rounds Q x scale to bf16 where K7 does not, and on
    # peaked scores that rounding alone moves LSE by more than the gate.
    # The queries held against K6 and the plain version carry both peaks.
    k_all, v_all = mk(b, hkv, total, d), mk(b, hkv, total, d)
    rows = torch.arange(b, device=dev)

    def reserve(alloc, cache, n, host_s=None):
        t0 = time.perf_counter()
        for i in range(b):
            alloc.reserve_for(cache, i, n)
        if host_s is not None:
            host_s.append(time.perf_counter() - t0)

    def paged_decode_part(cache, alloc, shadow, steps, label, window=0):
        """`steps` decode steps on the paged cache, each written to the
        contiguous shadow cache as well; every 16th step is held against
        the contiguous kernel on the shadow, which walks the same keys in
        the same order and so must give the same bits, the last also
        against the plain paged version. Returns the last query."""
        equal, host_s = True, []
        for t in range(steps):
            pos = cache.lengths.long()
            at = int(pos.max())  # tokens are drawn by the longest sequence
            k1, v1 = k_all[:, :, at], v_all[:, :, at]
            reserve(alloc, cache, 1, host_s)
            paged_append(cache, k1, v1)
            if cache.quantized:  # uniform lengths: the shadow's own append
                cache_append(shadow, k1[:, :, None], v1[:, :, None])
            else:  # each sequence at its own write head
                shadow.k[rows, :, pos] = k1
                shadow.v[rows, :, pos] = v1
            q1 = mk(b, h, d, peak=Q_PEAK * K_PEAK)
            o, lse = paged_decode_step(q1, cache, window=window)
            if t % 16 == 15 or t == steps - 1:
                o_c, lse_c = decode_attention(
                    q1, shadow.k, shadow.v, cache.lengths,
                    k_scale=shadow.k_scale, v_scale=shadow.v_scale,
                    window=window)
                equal = equal and bool(torch.equal(o, o_c)
                                       and torch.equal(lse, lse_c))
        o_p, lse_p = paged_decode_attention_plain(
            q1, cache.k_pages, cache.v_pages, cache.page_table,
            cache.lengths, k_scale=cache.k_scale, v_scale=cache.v_scale,
            window=window)
        (e_o, ref, ok), e_l = o_close(o, o_p), diff(lse, lse_p)
        host_ms = statistics.median(host_s) * 1e3
        print(f"[paged] {label}: {steps} decode steps to lengths "
              f"{cache.lengths.tolist()}: K7 bit-equal to K6 on the shadow "
              f"cache: {equal}; K7 vs its plain version max|dO|={e_o:.3e} "
              f"(max|O| {ref:.3e}) max|dLSE|={e_l:.3e} (gate {GATE}); "
              f"allocator host time {host_ms:.4f} ms per step (median; {b} "
              f"reserve_for calls) ({card})", flush=True)
        _check(equal, f"paged {label}: K7 and K6 differ on the same keys")
        _check(ok and e_l <= GATE, f"paged {label}: dO {e_o:.3e} (max|O| "
               f"{ref:.3e}) dLSE {e_l:.3e}")
        _check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
               f"paged {label}: non-finite output")
        rec["K7"]["max_abs_err"] = max(rec["K7"]["max_abs_err"], e_o, e_l)
        return q1

    def time_k7(cache, q1, label, window=0, **kw):
        """K7's median time on the cache as it stands, with its bound from
        the bytes of the live, in-window tokens."""
        ms = cuda_time_ms(lambda: paged_decode_step(q1, cache,
                                                    window=window, **kw),
                          before=l2_flush.zero_)
        ms_w = cuda_time_ms(lambda: paged_decode_step(q1, cache,
                                                      window=window, **kw))
        ms_d = device_ms(lambda: paged_decode_step(q1, cache, window=window,
                                                   **kw), "::paged_kernel<")
        lens = cache.lengths.long()
        seen = lens.clamp_max(window) if window else lens
        tokens = int(seen.sum()) * hkv
        pages = int(((lens + PAGE - 1) // PAGE
                     - (lens - seen) // PAGE).sum())
        nbytes = (_nbytes(q1) * 2 + b * h * 4 + b * 4 + pages * 4
                  + tokens * d * (cache.k_pages.element_size()
                                  + cache.v_pages.element_size())
                  + (tokens * 8 if cache.quantized else 0))
        bound = _bound(nbytes, 4.0 * b * h * d * int(seen.sum()) / b)
        print(f"[K7] {label}: lengths {lens.tolist()} window {window}: "
              f"wrapper {ms:.4f} ms (kernel alone {ms_d:.4f} ms; wrapper "
              f"{ms_w:.4f} ms with the pools warm in L2); bound "
              f"{bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}, {nbytes / 1e6:.2f} MB) ({card})",
              flush=True)
        return ms, bound

    zero_counts()
    cache = init_paged_cache(N_PAGES, b, MAX_PAGES, hkv, PAGE, d)
    _check(cache.k_pages.device.type == "cuda",
           "init_paged_cache did not allocate on the card")
    alloc = PageAllocator(N_PAGES)
    shadow = init_cache(b, hkv, MAX_PAGES * PAGE, d)
    print(f"[paged] pools {N_PAGES} pages x {hkv} KV heads x {PAGE} tokens "
          f"x d {d}: {_nbytes(cache.k_pages) / 2**20:.0f} MiB per bf16 "
          f"pool; B={b} H={h}, {MAX_PAGES} table slots per sequence",
          flush=True)
    prefix_ms, chunks = {}, []
    for start in range(0, PAGED_PREFILL, PAGED_CHUNK):
        end = start + PAGED_CHUNK
        qc = mk(b, h, PAGED_CHUNK, d)
        kc, vc = k_all[:, :, start:end], v_all[:, :, start:end]
        reserve(alloc, cache, PAGED_CHUNK)
        o, lse = flash_attention_forward(qc, kc, vc, causal=True,
                                         out_dtype=torch.float32)
        if start:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            o_pre, lse_pre = paged_prefix_attention(qc, cache)
            e1.record()
            o, lse = combine_partials(o_pre.float(), lse_pre, o, lse)
            torch.cuda.synchronize()
            prefix_ms[start] = e0.elapsed_time(e1)
        paged_bulk_append(cache, kc, vc)
        chunks.append((start, qc, o, lse))
    n_k1, n_k7_prefill = (flash_attention_forward.launches,
                          paged_decode_attention.launches)
    # every chunk against K1 over the contiguous K/V (after the counts
    # were read: these launches are comparisons)
    prefill_o, prefill_lse, prefill_ok, prefill_ref = 0.0, 0.0, True, 1e30
    for start, qc, o, lse in chunks:
        end = start + PAGED_CHUNK
        o_ref, lse_ref = flash_attention_forward(
            qc, k_all[:, :, :end], v_all[:, :, :end], causal=True,
            kv_offset=start, out_dtype=torch.float32)
        e_o, ref, ok = o_close(o, o_ref)
        prefill_o, prefill_ref = max(prefill_o, e_o), min(prefill_ref, ref)
        prefill_lse = max(prefill_lse, diff(lse, lse_ref))
        prefill_ok = prefill_ok and ok
    print(f"[paged] chunked prefill of {PAGED_PREFILL} tokens in chunks of "
          f"{PAGED_CHUNK}: every chunk (prefix K7 + K1 + combine_partials) "
          f"vs K1 over the contiguous K/V max|dO|={prefill_o:.3e} (least "
          f"max|O| of a chunk {prefill_ref:.3e}) max|dLSE|="
          f"{prefill_lse:.3e} (gate {GATE}); paged_prefix_attention ms by "
          f"prefix length: "
          + ", ".join(f"{s}: {t:.3f}" for s, t in prefix_ms.items())
          + f" ({card})", flush=True)
    _check(prefill_ok and prefill_lse <= GATE,
           f"paged prefill: dO {prefill_o:.3e} dLSE {prefill_lse:.3e}")
    _check(cache.lengths.tolist() == [PAGED_PREFILL] * b,
           f"paged lengths after prefill {cache.lengths.tolist()}")
    # the prefix form alone, on peaked queries over the whole prefill:
    # 512 folded rows per query head against the plain version on the
    # same rows (a comparison: its launch is taken off the count)
    qc = mk(b, h, PAGED_CHUNK, d, peak=Q_PEAK * K_PEAK)
    o_pre, lse_pre = paged_prefix_attention(qc, cache)
    paged_decode_attention.launches -= 1
    o_p, lse_p = paged_decode_attention_plain(
        qc.reshape(b, h * PAGED_CHUNK, d), cache.k_pages, cache.v_pages,
        cache.page_table, cache.lengths)
    (e_o, ref, ok), e_l = (
        o_close(o_pre.reshape(b, h * PAGED_CHUNK, d), o_p),
        diff(lse_pre.reshape(b, h * PAGED_CHUNK), lse_p))
    print(f"[paged] paged_prefix_attention, {PAGED_CHUNK}-row chunk over a "
          f"{PAGED_PREFILL}-token prefix, vs its plain version: max|dO|="
          f"{e_o:.3e} (max|O| {ref:.3e}) max|dLSE|={e_l:.3e} (gate {GATE})",
          flush=True)
    _check(ok and e_l <= GATE,
           f"paged prefix: dO {e_o:.3e} (max|O| {ref:.3e}) dLSE {e_l:.3e}")
    rec["K7"]["max_abs_err"] = max(rec["K7"]["max_abs_err"], e_o, e_l)
    del o_p, lse_p
    shadow.k[:, :, :PAGED_PREFILL] = k_all[:, :, :PAGED_PREFILL]
    shadow.v[:, :, :PAGED_PREFILL] = v_all[:, :, :PAGED_PREFILL]
    del o, lse, o_pre, lse_pre, o_ref, lse_ref, qc, chunks

    q1 = paged_decode_part(cache, alloc, shadow, PAGED_STEPS, "bf16 pools")
    # retire a sequence, count its pages, reuse them for a new sequence
    live_tokens = PAGED_PREFILL + PAGED_STEPS
    retired = cache.page_table[3, :math.ceil(live_tokens / PAGE)].tolist()
    free_before = len(alloc.free)
    alloc.release_sequence(cache, 3)
    freed = len(alloc.free) - free_before
    _check(freed == math.ceil(live_tokens / PAGE) == len(retired),
           f"retiring a sequence of {live_tokens} tokens reclaimed {freed} "
           f"pages")
    paged_decode_part(cache, alloc, shadow, 16, "bf16 pools, after "
                      "sequence 3 was retired and restarted")
    reused = int(cache.page_table[3, 0])
    print(f"[paged] retired sequence 3: {freed} pages reclaimed; its "
          f"successor's first page {reused} is one of them: "
          f"{reused in retired}", flush=True)
    _check(reused in retired, "the new sequence did not reuse a freed page")
    n_k7 = paged_decode_attention.launches
    print(f"[paged] launches on the lifecycle: K7 {n_k7} "
          f"({n_k7_prefill} prefix + {PAGED_STEPS + 16} decode), K1 "
          f"{n_k1}", flush=True)
    _check(n_k7 == n_k7_prefill + PAGED_STEPS + 16 and n_k7_prefill
           == PAGED_PREFILL // PAGED_CHUNK - 1,
           f"K7 launched {n_k7} times on the paged lifecycle")
    launches["K7"] += n_k7
    launches["K1"] += n_k1
    del cache, shadow, alloc

    # the decode part again: int8 and mixed pools, and a window
    k7_ms = {}
    for label, qtype, window in (("bf16 pools", None, 0),
                                 ("int8 pools", "int8", 0),
                                 ("mixed pools", "mixed", 0),
                                 ("bf16 pools", None, PAGED_WINDOW)):
        paged_decode_attention.launches = 0
        cache = init_paged_cache(N_PAGES, b, MAX_PAGES, hkv, PAGE, d,
                                 qtype=qtype)
        alloc = PageAllocator(N_PAGES)
        shadow = init_cache(b, hkv, MAX_PAGES * PAGE, d, qtype=qtype)
        reserve(alloc, cache, PAGED_PREFILL)
        paged_bulk_append(cache, k_all[:, :, :PAGED_PREFILL],
                          v_all[:, :, :PAGED_PREFILL])
        cache_append(shadow, k_all[:, :, :PAGED_PREFILL],
                     v_all[:, :, :PAGED_PREFILL])
        tag = label + (f", window {window}" if window else "")
        if qtype or window:
            q1 = paged_decode_part(cache, alloc, shadow, PAGED_STEPS, tag,
                                   window=window)
            launches["K7"] += paged_decode_attention.launches
        else:  # timed at the length the lifecycle reached; checked above
            for _ in range(PAGED_STEPS):
                reserve(alloc, cache, 1)
                at = int(cache.lengths[0])
                paged_append(cache, k_all[:, :, at], v_all[:, :, at])
        k7_ms[tag] = time_k7(cache, q1, tag, window=window)
        if qtype in ("int8", "mixed"):
            k7_ms[tag + ", quantize_q"] = time_k7(
                cache, q1, tag + ", quantize_q", quantize_q=True)
        if qtype is None and not window:
            ms_p = cuda_time_ms(lambda: paged_decode_attention_plain(
                q1, cache.k_pages, cache.v_pages, cache.page_table,
                cache.lengths), iters=5, before=l2_flush.zero_)
            rec["K7"].update(ms=k7_ms[tag][0], plain_ms=ms_p,
                             library_ms=None, **k7_ms[tag][1])
            print(f"[K7] {tag}: plain version {ms_p:.4f} ms; no single "
                  f"library call gathers and attends", flush=True)
            row_ms = {}
            for n_rows in (1, 4, 8):  # each on its own tile
                qr = mk(b, hkv * n_rows, d, peak=Q_PEAK * K_PEAK)
                row_ms[n_rows] = cuda_time_ms(
                    lambda: paged_decode_step(qr, cache),
                    before=l2_flush.zero_)
            print(f"[K7] {tag}, ms by query rows per KV head: "
                  + ", ".join(f"{r}: {t:.4f}" for r, t in row_ms.items())
                  + f" ({card})", flush=True)
        del cache, shadow, alloc
    del k_all, v_all

    # ---- 6. FA1 (K8) vs its plain version --------------------------------
    gen = torch.Generator(device=dev).manual_seed(3)
    q = mk(1, 16, TRAIN_T, 128, peak=Q_PEAK)
    k, v = mk(1, 16, TRAIN_T, 128, peak=K_PEAK), mk(1, 16, TRAIN_T, 128)
    zero_counts()
    fa1_out = {c: fa1_attention(q, k, v, causal=c) for c in (True, False)}
    torch.cuda.synchronize()
    launches["K8"] += fa1_attention.launches
    _check(fa1_attention.launches == 2,
           f"FA1 kernel launched {fa1_attention.launches} times in 2 calls")
    for causal, o in fa1_out.items():
        o_p = fa1_attention_plain(q, k, v, causal=causal)
        o_2, _ = flash_attention_forward(q, k, v, causal=causal)
        (e_p, ref, ok_p), (e_2, _, ok_2) = o_close(o, o_p), o_close(o, o_2)
        ms = cuda_time_ms(lambda: fa1_attention(q, k, v, causal=causal))
        ms_p = cuda_time_ms(
            lambda: fa1_attention_plain(q, k, v, causal=causal), iters=3,
            warmup=1)
        ms_1 = cuda_time_ms(
            lambda: flash_attention_forward(q, k, v, causal=causal))
        print(f"[K8] B=1 H=16 N={TRAIN_T} d=128 causal={causal} block_k=256"
              f": vs plain max|dO|={e_p:.3e}, vs K1 max|dO|={e_2:.3e} "
              f"(max|O| {ref:.3e}; gate {GATE}); kernel {ms:.4f} ms plain {ms_p:.4f} ms; K1 "
              f"at the same shape {ms_1:.4f} ms ({card})", flush=True)
        _check(ok_p and ok_2 and bool(torch.isfinite(o).all()),
               f"K8 causal={causal}: dO {e_p:.3e} vs plain, {e_2:.3e} vs K1 "
               f"(max|O| {ref:.3e})")
        rec["K8"]["max_abs_err"] = max(rec["K8"]["max_abs_err"], e_p)
        if causal:
            rec["K8"].update(
                ms=ms, plain_ms=ms_p,
                library_ms=sdpa_ms(q, k, v, is_causal=True),
                **_bound(_nbytes(q, k, v, o),
                         attention_flops(1, 16, TRAIN_T, TRAIN_T, 128,
                                         causal=True)))
            print(f"[K8] causal: bound {rec['K8']['bound_ms']:.4f} ms "
                  f"({rec['K8']['bound_by']}), library call "
                  f"{rec['K8']['library_ms']:.4f} ms", flush=True)
    del q, k, v, fa1_out, o, o_p, o_2

    # ---- 7. backward kernels vs their plain version ----------------------
    gen = torch.Generator(device=dev).manual_seed(1)

    # K1 at the training shape, bf16 out as the training forward asks
    q, k, v = (mk(1, 16, TRAIN_T, 128) for _ in range(3))
    o, lse = flash_attention_forward(q, k, v, causal=True)
    torch.cuda.synchronize()
    o_p, lse_p = flash_attention_forward_plain(q, k, v, causal=True)
    e_o, e_l = diff(o, o_p), diff(lse, lse_p)
    ms = cuda_time_ms(lambda: flash_attention_forward(q, k, v, causal=True))
    ms_p = cuda_time_ms(
        lambda: flash_attention_forward_plain(q, k, v, causal=True), iters=5)
    b1 = _bound(_nbytes(q, k, v, o, lse),
                attention_flops(1, 16, TRAIN_T, TRAIN_T, 128, causal=True))
    print(f"[K1] training {TRAIN_T} causal bf16 out: B=1 H=16 Hkv=16 "
          f"max|dO|={e_o:.3e} max|dLSE|={e_l:.3e} kernel {ms:.4f} ms "
          f"plain {ms_p:.4f} ms; bound {b1['bound_ms']:.4f} ms "
          f"({b1['bound_by']}), library call "
          f"{sdpa_ms(q, k, v, is_causal=True):.4f} ms ({card})", flush=True)
    rec["K1"]["max_abs_err"] = max(rec["K1"]["max_abs_err"], e_o, e_l)
    _check(e_o <= GATE and e_l <= GATE,
           f"K1 training shape: {e_o:.3e}/{e_l:.3e} > {GATE}")
    del q, k, v, o, lse, o_p, lse_p

    # (name, B, H, Hkv, Nq, Nk, causal, kv_offset); d = 128
    bwd_cases = [
        ("training 4096 causal", 1, 16, 16, TRAIN_T, TRAIN_T, True, 0),
        ("GQA ragged 1000 causal", 2, 16, 4, 1000, 1000, True, 0),
        ("kv_offset -20 empty rows", 2, 16, 4, 300, 400, True, -20),
        ("non-causal 512x1024", 2, 16, 4, 512, 1024, False, 0),
    ]
    for name, b, h, hkv, nq, nk, causal, off in bwd_cases:
        q, do = mk(b, h, nq, 128), mk(b, h, nq, 128)
        k, v = mk(b, hkv, nk, 128), mk(b, hkv, nk, 128)
        kw = dict(causal=causal, kv_offset=off)
        o, lse = flash_attention_forward(q, k, v, **kw)
        args = (q, k, v, o, lse, do)
        fused = flash_attention_backward(*args, fused=True, **kw)
        split = flash_attention_backward(*args, fused=False, **kw)
        torch.cuda.synchronize()
        plain = flash_attention_backward_plain(*args, **kw)
        for label, got, want in (("K4 vs plain", fused, plain),
                                 ("K2+K3 vs plain", split, plain),
                                 ("K4 vs K2+K3", fused, split)):
            line = []
            for gname, g, w in zip(("dQ", "dK", "dV"), got, want):
                e, ref = diff(g, w), w.float().abs().max().item()
                line.append(f"{gname} {e:.3e}/{ref:.3e}")
                if not (ref > 0 and e <= BWD_GATE * ref):
                    failures.append(f"{name} {label} {gname}: max|diff| "
                                    f"{e:.3e}, max|ref| {ref:.3e}")
                if label == "K4 vs plain":
                    kern = "K4"
                elif label == "K2+K3 vs plain":
                    kern = "K3" if gname == "dQ" else "K2"
                else:
                    continue
                rec[kern]["max_abs_err"] = max(rec[kern]["max_abs_err"], e)
            print(f"[bwd] {name}: {label}: max|diff|/max|ref| "
                  f"{', '.join(line)} (gate {BWD_GATE} x max|ref|)",
                  flush=True)
        ms_f = cuda_time_ms(
            lambda: flash_attention_backward(*args, fused=True, **kw),
            iters=10)
        ms_s = cuda_time_ms(
            lambda: flash_attention_backward(*args, fused=False, **kw),
            iters=10)
        ms_p = cuda_time_ms(
            lambda: flash_attention_backward_plain(*args, **kw), iters=3,
            warmup=1)
        prof = kernel_times(lambda: (
            flash_attention_backward(*args, fused=True, **kw),
            flash_attention_backward(*args, fused=False, **kw)), iters=3)
        dev_ms = {kn: launch_ms(prof, lambda n: _kernel_of(n) == kn)
                  for kn in ("K2", "K3", "K4")}
        _check(all(math.isfinite(t) for t in dev_ms.values()),
               f"{name}: the profiler recorded no launch of a backward "
               f"kernel: {dev_ms}")
        print(f"[bwd] {name}: B={b} H={h} Hkv={hkv} Nq={nq} Nk={nk} "
              f"kv_offset={off}: wrapper fused {ms_f:.4f} ms, split "
              f"{ms_s:.4f} ms, plain {ms_p:.4f} ms; device K4 "
              f"{dev_ms['K4']:.4f} ms, K2 {dev_ms['K2']:.4f} ms, K3 "
              f"{dev_ms['K3']:.4f} ms ({card})", flush=True)
        if name.startswith("training"):
            flops = attention_flops(b, h, nq, nk, 128, causal=causal,
                                    backward=True)
            print(f"[bwd] {name}: K4 {flops / dev_ms['K4'] / 1e9:.1f} "
                  f"TFLOP/s ({flops / 1e9:.1f} GFLOP of products)",
                  flush=True)
            # the library call: the autograd backward of one
            # scaled_dot_product_attention, dQ, dK and dV together
            ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
            o_l = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
            lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
                o_l, (ql, kl, vl), do, retain_graph=True), iters=10)
            read = _nbytes(q, k, v, o, lse, do)
            # products per (query, key) pair: K2 S, dP, dV, dK; K3 S, dP,
            # dQ; K4 all five
            for kn, products, written in (("K2", 4, _nbytes(k, v)),
                                          ("K3", 3, _nbytes(q)),
                                          ("K4", 5, _nbytes(q, k, v))):
                rec[kn].update(ms=dev_ms[kn], plain_ms=ms_p,
                               library_ms=lib_ms,
                               **_bound(read + written, flops * products / 5))
            print(f"[bwd] {name}: bounds K2 {rec['K2']['bound_ms']:.4f} "
                  f"K3 {rec['K3']['bound_ms']:.4f} K4 "
                  f"{rec['K4']['bound_ms']:.4f} ms (operations); library "
                  f"backward (dQ, dK, dV in one call) {lib_ms:.4f} ms",
                  flush=True)
            del ql, kl, vl, o_l
        del q, k, v, o, lse, do, args, fused, split, plain
    _check(not failures, "; ".join(failures))

    # ---- 8. main path: make_train_step on the 271M training model -------
    tcfg = tfm.TransformerConfig(dtype=torch.bfloat16, **TRAIN_KW)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tfm.Transformer(tcfg, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, tcfg.vocab_size, (1, TRAIN_T), generator=gen,
                           device=dev, dtype=torch.int32)
    step = tfm.make_train_step(
        model, torch.optim.SGD(model.parameters(), lr=1e-4))
    print(f"[train] model {n_params / 1e6:.1f}M params, B=1 T={TRAIN_T}, "
          f"bf16, SGD(1e-4)", flush=True)
    for _ in range(2):  # warm-up: cuBLAS, allocator
        step(tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    step_s, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = dict(fwd=flash_attention_forward.launches, **bwd_launches)
    expect = TIMED_STEPS * tcfg.n_layers
    print(f"[train] launches over {TIMED_STEPS} steps: K1 {counts['fwd']}, "
          f"K4 {counts['fused']}, K2 {counts['dkdv']}, K3 {counts['dq']} "
          f"(expect {expect}, {expect}, 0, 0)", flush=True)
    _check(counts == dict(fwd=expect, fused=expect, dkdv=0, dq=0),
           f"train-step launch counts {counts}")
    launches["K1"] += counts["fwd"]
    launches["K4"] += counts["fused"]
    _check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    step_ms = statistics.median(step_s) * 1e3
    train_flops = (6.0 * n_params * TRAIN_T
                   + 3 * attention_flops(1, tcfg.n_heads, TRAIN_T, TRAIN_T,
                                         tcfg.d_head, causal=True)
                   * tcfg.n_layers)
    print(f"[train] step {step_ms:.3f} ms (median of {TIMED_STEPS}: "
          f"{', '.join(f'{x * 1e3:.3f}' for x in step_s)}), "
          f"{TRAIN_T / step_ms * 1e3:.1f} tokens/s, "
          f"{train_flops / step_ms / 1e9:.1f} TFLOP/s "
          f"({train_flops / 1e12:.3f} TFLOP per step), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} ({card})", flush=True)

    prof = kernel_times(lambda: step(tokens))
    groups = {}
    for n, t in prof.ms.items():
        groups[_group_of(n)] = groups.get(_group_of(n), 0.0) + t
    print(f"[train] profile of one step: {sum(prof.count.values())} "
          f"kernels, device busy {prof.busy_ms:.3f} ms of a profiled wall "
          f"of {prof.wall_ms:.3f} ms ({prof.busy_ms / prof.wall_ms:.1%})",
          flush=True)
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[train]   {g}: {t:.3f} ms ({t / prof.busy_ms:.1%} of busy)")
    top = sorted(prof.ms.items(), key=lambda kv: -kv[1])[:8]
    for n, t in top:
        print(f"[train]   top: {t:.3f} ms x{prof.count[n]} {n[:110]}")

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(model, tokens)
        loss.backward()
        return loss.item(), [p.grad.float() for p in model.parameters()]

    names = [n for n, _ in model.named_parameters()]

    def rel_l2(ga, gb):
        errs = [((a - b).norm() / b.norm()).item() for a, b in zip(ga, gb)]
        i = max(range(len(errs)), key=errs.__getitem__)
        return errs[i], names[i]

    loss_k, grads_k = loss_and_grads()
    plain_fwd = (lambda q, k, v, window=0, block_sizes=None,
                 q_segment_ids=None, kv_segment_ids=None, **kw:
                 flash_attention_forward_plain(q, k, v, **kw))
    plain_bwd = (lambda q, k, v, o, lse, do, window=0, block_sizes=None,
                 q_segment_ids=None, kv_segment_ids=None, fused=None, **kw:
                 flash_attention_backward_plain(q, k, v, o, lse, do, **kw))
    with mock.patch.object(attention, "flash_attention_forward", plain_fwd), \
            mock.patch.object(attention, "flash_attention_backward",
                              plain_bwd):
        loss_p, grads_p = loss_and_grads()
    e_grad, worst = rel_l2(grads_k, grads_p)
    print(f"[train] kernels vs plain attention: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (|d| {abs(loss_k - loss_p):.3e}, gate "
          f"{LOSS_GATE}); worst gradient relative L2 {e_grad:.3e} "
          f"({worst}; gate {GRAD_GATE})", flush=True)
    _check(abs(loss_k - loss_p) <= LOSS_GATE,
           f"kernel vs plain loss {loss_k} vs {loss_p}")
    _check(e_grad <= GRAD_GATE, f"kernel vs plain gradient of {worst}: "
           f"relative L2 {e_grad:.3e}")
    del grads_p

    # the same step through the split backward (K2 + K3)
    zero_counts()
    with mock.patch.object(attention, "flash_attention_backward",
                           functools.partial(flash_attention_backward,
                                             fused=False)):
        loss_s, grads_s = loss_and_grads()
    torch.cuda.synchronize()
    split_counts = dict(fwd=flash_attention_forward.launches, **bwd_launches)
    e_split, worst = rel_l2(grads_s, grads_k)
    print(f"[train] split backward: launches K1 {split_counts['fwd']}, K2 "
          f"{split_counts['dkdv']}, K3 {split_counts['dq']}, K4 "
          f"{split_counts['fused']} (expect {tcfg.n_layers} each, K4 0); "
          f"loss {loss_s:.6f}; worst gradient relative L2 to the fused "
          f"backward {e_split:.3e} ({worst}; gate {GRAD_GATE})", flush=True)
    n = tcfg.n_layers
    _check(split_counts == dict(fwd=n, fused=0, dkdv=n, dq=n),
           f"split-backward launch counts {split_counts}")
    launches["K1"] += split_counts["fwd"]
    launches["K2"] += split_counts["dkdv"]
    launches["K3"] += split_counts["dq"]
    _check(abs(loss_s - loss_k) <= LOSS_GATE and e_split <= GRAD_GATE,
           f"split vs fused backward: loss {loss_s} vs {loss_k}, gradient "
           f"of {worst} {e_split:.3e}")
    del grads_k, grads_s, model, step

    # loss falls: 10 Adam steps on a fresh model and the same batch
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tfm.Transformer(tcfg, generator=gen)
    step = tfm.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3))
    adam = [step(tokens).item() for _ in range(ADAM_STEPS)]
    print(f"[train] Adam(1e-3), {ADAM_STEPS} steps: losses "
          f"{', '.join(f'{x:.4f}' for x in adam)}", flush=True)
    _check(all(math.isfinite(x) for x in adam) and adam[-1] < adam[0],
           f"Adam losses did not fall: {adam}")
    del model, step

    # ---- last lines ------------------------------------------------------
    csrc = "cuda_flashattention_torch/csrc/"
    tpu = "cuda_flashattention_tpu/ops/"
    described = [
        ("K1", "flash_attention_forward (K1, online FA2 forward)",
         "flash_fwd.cu", "flash_fwd.py:123"),
        ("K6", "decode_attention (K6, one-token decode: bf16, int8, fp8 "
         "and mixed caches, windows, quantize_q)", "decode.cu",
         "decode.py:145"),
        ("K7", "paged_decode_attention (K7, one-token decode over paged "
         "pools)", "paged.cu", "paged.py:51"),
        ("K8", "fa1_attention (K8, FA1 forward)", "fa1.cu", "fa1.py:54"),
        ("K2", "flash_attention_backward fused=False (K2, dK/dV)",
         "flash_bwd.cu", "flash_bwd.py:117"),
        ("K3", "flash_attention_backward fused=False (K3, dQ)",
         "flash_bwd.cu", "flash_bwd.py:192"),
        ("K4", "flash_attention_backward (K4, fused dQ/dK/dV)",
         "flash_bwd.cu", "flash_bwd.py:252"),
    ]
    kernels = []
    for kn, name, source, replaces in described:
        _check(launches[kn] > 0, f"{kn} was launched no time on its path")
        r = rec[kn]
        kernels.append(dict(
            name=name, route="cuda", source=csrc + source,
            replaces=tpu + replaces, launches=launches[kn],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
