#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

1. Environment: needs `torch.cuda.is_available()`; prints the card's name
   and power limit (nvidia-smi), the torch, CUDA and nvcc versions.
2. Build: compiles the package's CUDA kernels (csrc/*.cu) with nvcc into
   the git-ignored build directory, and prints the time it took.
3. Kernels against their plain PyTorch versions, on the card, in bf16, at
   the serving model's shapes: the forward (K1) and the decode (K6).
   O and LSE must agree within 5e-3 (the repo's bf16 gate); each case
   prints the max |diff| and both median times (CUDA events).
4. Main path: the 246M GQA serving model (vocab 32000, d_model 2048,
   4 layers, 16 query heads over 4 KV heads, d_head 128, d_ff 5632,
   bf16; random weights from a seeded generator) runs `generate()` on
   B=8 prompts of 512 tokens for 128 new tokens, greedily. The launch
   counts must show that prefill went through K1 once per layer and
   decode through K6 once per layer and token. Chunked prefill must agree
   with whole prefill, and prefill through the kernels with prefill
   through the plain attention functions.
5. Backward kernels against their plain version, on the card, in bf16:
   the fused K4 (`fused=True`) and the split K2 + K3 (`fused=False`), each
   against `flash_attention_backward_plain` and against each other, at the
   training shape (B=1, H=16, N=4096, d=128, causal), a GQA ragged shape,
   a `kv_offset` = -20 case with empty rows and unseen keys, and a
   non-causal Nq != Nk case. Gate per gradient: max |diff| <= 2e-2 ·
   max |plain|, with max |plain| > 0. Each case prints both numbers, the
   wrapper's median times (CUDA events) and each kernel's device time
   (torch.profiler); K1 is also checked at the training shape, bf16 out.
6. Main path of training: the 271M training model (vocab 32000, d_model
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
those runs (serving, the timed training steps, the split-backward step).

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
# Logits of the bf16 model: chunked vs whole prefill, and kernels vs plain
# attention. The attention outputs differ by fp32 rounding, which flips
# bf16 roundings of activations; through 4 layers and a d_model-wide
# unembedding that leaves a few bf16 ulps on logits of magnitude ~1-4.
LOGIT_GATE = 0.125

CFG_KW = dict(vocab_size=32000, d_model=2048, n_layers=4, n_heads=16,
              n_kv_heads=4, d_head=128, d_ff=5632, max_seq=8192)
BATCH, PROMPT, NEW = 8, 512, 128

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


def _run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                               timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


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
    from cuda_flashattention_torch import _build
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.models.generate import generate
    from cuda_flashattention_torch.ops.decode import (
        decode_attention, decode_attention_plain)
    from cuda_flashattention_torch.ops import attention
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward, flash_attention_backward_plain)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward, flash_attention_forward_plain)
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

    # ---- 3. kernels vs their plain versions ------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def mk(*shape):
        return (torch.rand(shape, generator=gen, device=dev) - 0.5).to(
            torch.bfloat16)

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item()

    failures = []
    results = {}
    # (name, B, H, Hkv, Nq, Nk, causal); d = 128, fp32 out as prefill asks
    fwd_cases = [
        ("prefill 512 causal", 8, 16, 4, 512, 512, True),
        ("ragged 500 causal", 8, 16, 4, 500, 500, True),
        ("chunk prefix 128x384", 8, 16, 4, 128, 384, False),
        ("4096 causal", 2, 16, 4, 4096, 4096, True),
    ]
    fwd_err = 0.0
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
        fwd_err = max(fwd_err, e_o, e_l)
        results.setdefault("K1", (ms, ms_p))
        if not (e_o <= GATE and e_l <= GATE):
            failures.append(f"K1 {name}: {e_o:.3e}/{e_l:.3e} > {GATE}")
        del q, k, v, o, lse, o_p, lse_p

    # the serving decode: cache of prompt + new tokens, per-seq lengths
    max_len = PROMPT + NEW
    dec_lengths = [1, 63, 64, 513, 640, 0, 200, 577]
    q, k, v = mk(8, 16, 128), mk(8, 4, max_len, 128), mk(8, 4, max_len, 128)
    dec_err = 0.0
    for name, lens in (("ragged lengths", dec_lengths),
                       ("full cache", [max_len] * 8)):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        o, lse = decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        o_p, lse_p = decode_attention_plain(q, k, v, lengths)
        e_o, e_l = diff(o, o_p), diff(lse, lse_p)
        ms = cuda_time_ms(lambda: decode_attention(q, k, v, lengths))
        ms_p = cuda_time_ms(lambda: decode_attention_plain(q, k, v, lengths))
        print(f"[K6] {name}: B=8 H=16 Hkv=4 max_len={max_len} "
              f"lengths={lens} max|dO|={e_o:.3e} max|dLSE|={e_l:.3e} "
              f"kernel {ms:.4f} ms plain {ms_p:.4f} ms ({card})", flush=True)
        dec_err = max(dec_err, e_o, e_l)
        results["K6"] = (ms, ms_p)  # the last case: the full cache
        if not (e_o <= GATE and e_l <= GATE):
            failures.append(f"K6 {name}: {e_o:.3e}/{e_l:.3e} > {GATE}")
    _check(not failures, "; ".join(failures))

    # ---- 4. main path: generate() on the 246M serving model --------------
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **CFG_KW)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tfm.Transformer(cfg, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    print(f"[main] model {n_params / 1e6:.1f}M params, B={BATCH} "
          f"prompt={PROMPT} new={NEW}, bf16 cache, greedy", flush=True)
    generate(model, prompt, 2)  # warm-up: cuBLAS and allocator
    torch.cuda.synchronize()

    flash_attention_forward.launches = 0
    decode_attention.launches = 0
    t0 = time.perf_counter()
    out, logits = generate(model, prompt, NEW)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    fwd_launches = flash_attention_forward.launches
    dec_launches = decode_attention.launches
    print(f"[main] launches: forward {fwd_launches} (expect "
          f"{cfg.n_layers}), decode {dec_launches} (expect "
          f"{cfg.n_layers * NEW})", flush=True)
    _check(fwd_launches == cfg.n_layers,
           f"forward kernel launched {fwd_launches} times in the main path")
    _check(dec_launches == cfg.n_layers * NEW,
           f"decode kernel launched {dec_launches} times in the main path")
    _check(tuple(out.shape) == (BATCH, PROMPT + NEW),
           f"tokens shape {tuple(out.shape)}")
    _check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
           "tokens out of range")
    _check(bool(torch.equal(out[:, :PROMPT], prompt)), "prompt not kept")
    _check(bool(torch.isfinite(logits).all()), "non-finite logits")

    # prefill alone, and the decode loop alone (as generate runs it)
    prefill_s = []
    for _ in range(5):
        caches = tfm.init_caches(cfg, BATCH, max_len, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg_whole, caches = tfm.prefill(model, prompt, caches)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    token = torch.argmax(lg_whole, dim=-1).to(prompt.dtype)
    t0 = time.perf_counter()
    for i in range(NEW):
        lg, caches = tfm.decode_one(model, token, PROMPT + i, caches)
        token = torch.argmax(lg, dim=-1).to(prompt.dtype)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    prefill_ms = statistics.median(prefill_s) * 1e3
    print(f"[main] prefill {prefill_ms:.3f} ms (B={BATCH} x {PROMPT}); "
          f"decode {BATCH * NEW / decode_s:.1f} tok/s "
          f"({decode_s / NEW * 1e3:.3f} ms/step); end-to-end generate "
          f"{BATCH * NEW / e2e_s:.1f} tok/s ({e2e_s:.3f} s) ({card})",
          flush=True)

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
    del model, caches, out, logits, lg_whole, lg_chunk, lg_plain

    # ---- 5. backward kernels vs their plain version ----------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    bwd_launches = flash_attention_backward.launches

    def zero_counts():
        flash_attention_forward.launches = 0
        decode_attention.launches = 0
        for name in bwd_launches:
            bwd_launches[name] = 0

    # K1 at the training shape, bf16 out as the training forward asks
    q, k, v = (mk(1, 16, TRAIN_T, 128) for _ in range(3))
    o, lse = flash_attention_forward(q, k, v, causal=True)
    torch.cuda.synchronize()
    o_p, lse_p = flash_attention_forward_plain(q, k, v, causal=True)
    e_o, e_l = diff(o, o_p), diff(lse, lse_p)
    ms = cuda_time_ms(lambda: flash_attention_forward(q, k, v, causal=True))
    ms_p = cuda_time_ms(
        lambda: flash_attention_forward_plain(q, k, v, causal=True), iters=5)
    print(f"[K1] training {TRAIN_T} causal bf16 out: B=1 H=16 Hkv=16 "
          f"max|dO|={e_o:.3e} max|dLSE|={e_l:.3e} kernel {ms:.4f} ms "
          f"plain {ms_p:.4f} ms ({card})", flush=True)
    fwd_err = max(fwd_err, e_o, e_l)
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
    bwd_err = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
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
                    bwd_err["K4"] = max(bwd_err["K4"], e)
                elif label == "K2+K3 vs plain":
                    kern = "K3" if gname == "dQ" else "K2"
                    bwd_err[kern] = max(bwd_err[kern], e)
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
        dev_ms = {kn: sum(t for n, t in prof.ms.items()
                          if _kernel_of(n) == kn) / 3
                  for kn in ("K2", "K3", "K4")}
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
            for kn in ("K2", "K3", "K4"):
                results[kn] = (dev_ms[kn], ms_p)
        del q, k, v, o, lse, do, args, fused, split, plain
    _check(not failures, "; ".join(failures))

    # ---- 6. main path: make_train_step on the 271M training model -------
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
    train_counts = dict(counts)
    expect = TIMED_STEPS * tcfg.n_layers
    print(f"[train] launches over {TIMED_STEPS} steps: K1 {counts['fwd']}, "
          f"K4 {counts['fused']}, K2 {counts['dkdv']}, K3 {counts['dq']} "
          f"(expect {expect}, {expect}, 0, 0)", flush=True)
    _check(counts == dict(fwd=expect, fused=expect, dkdv=0, dq=0),
           f"train-step launch counts {counts}")
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
    bwd_src = "cuda_flashattention_torch/csrc/flash_bwd.cu"
    tpu_bwd = "cuda_flashattention_tpu/ops/flash_bwd.py"
    kernels = [
        dict(name="flash_attention_forward (K1, online FA2 forward)",
             route="cuda",
             source="cuda_flashattention_torch/csrc/flash_fwd.cu",
             replaces="cuda_flashattention_tpu/ops/flash_fwd.py:123",
             launches=(fwd_launches + train_counts["fwd"]
                       + split_counts["fwd"]),
             max_abs_err=fwd_err,
             ms=results["K1"][0], plain_ms=results["K1"][1]),
        dict(name="decode_attention (K6, one-token decode)",
             route="cuda",
             source="cuda_flashattention_torch/csrc/decode.cu",
             replaces="cuda_flashattention_tpu/ops/decode.py:145",
             launches=dec_launches, max_abs_err=dec_err,
             ms=results["K6"][0], plain_ms=results["K6"][1]),
        dict(name="flash_attention_backward fused=False (K2, dK/dV)",
             route="cuda", source=bwd_src, replaces=f"{tpu_bwd}:117",
             launches=split_counts["dkdv"], max_abs_err=bwd_err["K2"],
             ms=results["K2"][0], plain_ms=results["K2"][1]),
        dict(name="flash_attention_backward fused=False (K3, dQ)",
             route="cuda", source=bwd_src, replaces=f"{tpu_bwd}:192",
             launches=split_counts["dq"], max_abs_err=bwd_err["K3"],
             ms=results["K3"][0], plain_ms=results["K3"][1]),
        dict(name="flash_attention_backward (K4, fused dQ/dK/dV)",
             route="cuda", source=bwd_src, replaces=f"{tpu_bwd}:252",
             launches=train_counts["fused"], max_abs_err=bwd_err["K4"],
             ms=results["K4"][0], plain_ms=results["K4"][1]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
