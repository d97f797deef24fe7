#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA card.

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

Its last lines: the card's name and power limit, one JSON object
describing each kernel, then `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
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


def _run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                               timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


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
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward, flash_attention_forward_plain)
    from cuda_flashattention_torch.utils.timing import cuda_time_ms

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

    # ---- last lines ------------------------------------------------------
    kernels = [
        dict(name="flash_attention_forward (K1, online FA2 forward)",
             route="cuda",
             source="cuda_flashattention_torch/csrc/flash_fwd.cu",
             replaces="cuda_flashattention_tpu/ops/flash_fwd.py:123",
             launches=fwd_launches, max_abs_err=fwd_err,
             ms=results["K1"][0], plain_ms=results["K1"][1]),
        dict(name="decode_attention (K6, one-token decode)",
             route="cuda",
             source="cuda_flashattention_torch/csrc/decode.cu",
             replaces="cuda_flashattention_tpu/ops/decode.py:145",
             launches=dec_launches, max_abs_err=dec_err,
             ms=results["K6"][0], plain_ms=results["K6"][1]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
