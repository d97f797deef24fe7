#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, chunked-serving, paged-serving,
training and distributed paths on one NVIDIA card.

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
   also the kernel's own device time, from torch.profiler); each K1 and K8
   row also its share of its bound and the library call's time (under the
   row's boolean mask where it has one). K6 and K7
   are timed on a cold L2 cache, as a server's decode step finds it; K6
   is also timed under 1 to 16 query rows per KV head.
   Then the forward's other forms at the serving model's width, on peaked
   inputs, O held to min(5e-3, 2e-2 · max |plain O|) and LSE to 5e-3: K1
   (online) under a window and under segment ids; and, at the two shapes
   chunked serving reads the cache at (512 rows over a 3584-key prefix,
   every key visible; 512 rows over a 1024-key slice under window 1024
   with kv_offset 1024), over bf16, int8, fp8 and mixed K/V: what "auto"
   routes to against the plain version, each of online (K1), bound (K1b)
   and K-major (K5) pinned against the plain version of its strategy, K5
   against K1b (1e-4), `quantize_q` where K/V are quantized; the wrapper
   time of each form, of the routed call with and without its guarded
   fallback launch, the routed kernel alone, K1 (online) alone, the bound
   and the library call on the dequantised K/V. A loose bound (anti-aligned Q and K) must
   return the online kernel's bits under "bound" and O = 0, LSE = NEG_INF
   under "bound_unchecked".
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
   Main path of chunked serving, on the same model: B=8 prompts of 4096
   tokens through `prefill_chunked(chunk=512)`, then 128 `decode_one`
   steps, over a bf16, an int8 and an fp8 cache, and with `cfg.window` =
   1024 over an int8 cache. Per layer, each chunk launches K1 (online) on
   itself and, after the first, K1b (bf16 and int8 caches) or K5 (fp8
   cache; any quantized cache under a window) on the cached prefix, with
   one guarded fallback launch behind it: the counts per form must be 32,
   28 and 28, and K6's 512. The last chunk's logits must meet those of the
   same run on the plain attention functions (0.125) and, without a
   window, those of a whole-prompt `prefill` over a bf16 cache (0.125
   bf16, 0.25 int8, 0.5 fp8). A torch.profiler breakdown of one chunked
   prefill over a bf16 and an fp8 cache follows.
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
   the fused K4 (`fused=True`) and the split K2 + K3 (`fused=False`; K2
   is K4's wgmma + TMA kernel without dQ, K3 the wmma dQ kernel), each
   against `flash_attention_backward_plain` and against each other, at the
   training shape (B=1, H=16, N=4096, d=128, causal), a GQA ragged shape,
   a `kv_offset` = -20 case with empty rows and unseen keys, and a
   non-causal Nq != Nk case. Gate per gradient: max |diff| <= 2e-2 ·
   max |plain|, with max |plain| > 0. Each case prints both numbers, the
   wrapper's median times (CUDA events) and each kernel's device time
   (torch.profiler); K1 is also checked at the training shape, bf16 out,
   causal and under window 1024.
   Then K4 and K2 + K3 under a window (the training shape with window
   1024; a GQA prefix shape with kv_offset) and under segment ids (causal
   and not), same gate.
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
   layer. Then the sliding-window model (`cfg.window` = 1024) takes 5
   timed steps on the same batch: K1 and K4 once per layer and step, loss
   and gradients against the plain attention functions at the same gates.
   Ten Adam(1e-3) steps on a fresh model must lower the loss.
9. The distributed layer. The ranks of every mesh share card 0 (a mesh's
   entries may repeat), each rank with its own compute and copy stream;
   with two or more cards visible, phases 9 and 14 run once more over
   distinct cards, and the output says which. First the kernels of one
   ring step against their plain versions at the step's own shapes (one
   [1, 16, L, 128] query shard over one K/V block, fp32 O, `softmax=
   "auto"`; K4 against the LSE of a two-block context): a full block with
   Hkv = 16 and 4, the block one hop behind under window 4096 (causal,
   kv_offset 4096), and the padded last block of the ragged case under
   its segment ids. Then ring attention alone, 4 ranks, B=1, H=16, d=128,
   bf16, so that every ring step is K1's and K4's 4096 x 4096 shape:
   causal at N=16384, non-causal at N=15998 (ragged: padded to shards of
   4000, the tail under segment ids), GQA (Hkv=4), and causal with window
   4096 (the ring must end after 2 steps). O against `flash_attention` on
   the whole sequence (min(5e-3, 2e-2 · max |ref|)), dQ, dK, dV of a
   seeded dO against the same (2e-2 · max |ref|); forward launches (by
   form: a full step goes where `softmax="auto"` routes a non-causal
   4096-row call) and K4 launches must be 10, 16, 10 and 7; forward and
   forward + backward times against the one-rank call; from
   torch.profiler, the share of the copy streams' time that lies under a
   K1 / K1b / K4 kernel.
10. Ulysses on the same causal case: against one rank and against the
   ring (5e-3), forward and gradients; 4 forward and 4 K4 launches.
11. Ring decode: B=8, H=16, Hkv=4, a 16384-token cache over 4 ranks
   (resident shards), lengths in 12000-16384, bf16 and int8 caches, with
   and without window 4096: O and LSE against `decode_attention` on the
   whole cache (5e-3; the int8 cache's fp32 LSE 1e-3 against the same int8
   cache unsharded, its bf16 O 5e-3: one bf16 ulp at |O| 0.3 is 1.95e-3)
   and against `decode_attention_plain` on the whole cache, and K6 on each
   rank's 4096-token shard, under the live lengths and windows the ring
   derives for it, against `decode_attention_plain`; K6 launches 4 per
   call; both timed on a cold L2.
12. Main path of the distributed layer: the 271M training config takes
   `make_train_step(model, SGD(1e-4), mesh=<4 ranks>, seq_axis="sp")`
   steps on one seeded batch of B=1 x T=16384: 3 timed steps (ms,
   tokens/s, peak memory) must launch the forward and K4 4 layers x 10
   times per step and K2, K3 never; one step's loss and every gradient
   against the same model without a mesh at T=16384 (2e-2, 5e-2 relative
   L2).
13. GPipe: `pipeline_forward` of the same config at B=4 x T=2048, 2 stages
   x 2 layers, 4 microbatches: logits against `forward` (0.125).
14. K9, the device-initiated ring. Its path is the example stage
   `cuda_flashattention_torch.examples.device_ring` (both rings within
   1e-2 of the reference, `Test PASSED!`). Then K9 against
   `ring_matmul_plain` and against tile((sum x_i) @ W) in fp32 (gates 1e-2
   and 2e-2 · max |ref|, which must be > 0) at n in {1, 2, 4, 8} ranks, at
   the example's shape (L=1024, d=128) and at L=8192 (a 2 MiB shard), 20
   timed iterations each of the wrapper, the kernel alone (torch.profiler),
   the plain ring and one `torch.einsum` over the shards; the time per
   hop; 50 repeats at n=8 must equal the first call bit for bit.

Each path is driven with the launch counts set to 0 just before it and
read just after; a kernel's `launches` in the JSON line is its sum over
those runs (the three `generate()` runs, the four chunked-serving runs,
the paged lifecycle, the two FA1 calls, the timed training steps of both
models, the split-backward step, the ring-attention cases, Ulysses, the
ring-decode calls, the sequence-parallel train steps, the pipelined
forward, the device-ring stage). Launches made to compare a kernel with
its plain version or to time it are not in it, nor are K1's guarded
fallback launches behind a checked bound call, which exit at once.

Each kernel's `bound_ms` is the least time the card could take for the
same call: the larger of its bytes (each input read once, each output
written once; only the live, in-window part of a cache; quantized K/V at
their storage width plus their scales) over the card's memory rate and its matmul operations (the visible half when causal) over
the card's bf16 rate, from the data sheet of the H100 SXM (3.35 TB/s,
989 TFLOP/s at a 700 W power limit). `library_ms` is one call of
`torch.nn.functional.scaled_dot_product_attention` (or its autograd
backward) on the same inputs, timed here as a yardstick; the package
never calls it.

Its last lines: the card's name and power limit, one JSON object
describing each kernel, then `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import types
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
# The same over an fp8 cache: e4m3 keys carry their 6% into the scores as
# well, not only into the values as the mixed cache's V does.
FP8_LOGIT_GATE = 0.5

CFG_KW = dict(vocab_size=32000, d_model=2048, n_layers=4, n_heads=16,
              n_kv_heads=4, d_head=128, d_ff=5632, max_seq=8192)
BATCH, PROMPT, NEW = 8, 512, 128
# chunked serving: a long prompt in chunks, and the sliding-window model
LONG_PROMPT, LONG_CHUNK, LONG_WINDOW = 4096, 512, 1024

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
# profiled windows tried before a measurement that needs certain kernels
# in its window gives up
PROFILE_ATTEMPTS = 5

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
    for pattern, label in ((r"flash_bwd_kv_kernel<\d+, true,", "K4"),
                           (r"flash_bwd_kv_kernel<\d+, false,", "K2"),
                           (r"flash_bwd_q_kernel", "K3"),
                           (r"flash_fwd_kmajor", "K5"),
                           (r"flash_fwd_bound_kernel", "K1b"),
                           (r"flash_fwd_kernel", "K1"),
                           (r"::decode_kernel<", "K6"),
                           (r"device_ring_kernel", "K9")):
        if re.search(pattern, name):
            return label
    return ""


def _device_ms_by_kernel(fn, labels, iters, attempts=3) -> dict:
    """Mean device ms per recorded launch of each package kernel in
    `labels` over `iters` calls of fn() (torch.profiler). The profiler now
    and then loses the launches of a window: such a window is profiled
    again, up to `attempts` times; a kernel still missing reads NaN."""
    from cuda_flashattention_torch.utils.profiling import kernel_times
    out = {}
    for _ in range(attempts):
        prof = kernel_times(fn, iters=iters)
        for label in labels:
            names = [n for n in prof.ms if _kernel_of(n) == label]
            count = sum(prof.count[n] for n in names)
            out[label] = (sum(prof.ms[n] for n in names) / count if count
                          else float("nan"))
        if all(math.isfinite(t) for t in out.values()):
            break
    return out


def _group_of(name: str) -> str:
    """Breakdown group of a profiler kernel name."""
    label = _kernel_of(name)
    if label:
        return label
    if re.search(r"gemm|nvjet|cutlass|xmma|cublas", name, re.I):
        return "cuBLAS GEMM"
    return "elementwise/reduction/copy"


# ---------------------------------------------------------------------------
# The distributed layer (phases 9-14). Each function takes `ctx`, the
# helpers and records that main() shares with them (mk, diff, o_close,
# zero_counts, rec, launches, the card's name), and raises on failure.
# ---------------------------------------------------------------------------

# ring attention, ring decode and Ulysses alone: one long sequence over 4
# ranks, so that every ring step is the 4096 x 4096 shape of K1 and K4
RING_RANKS, RING_N, RING_H, RING_WINDOW = 4, 16384, 16, 4096
# padded to shards of 4000, whose tail carries segment ids
RING_RAGGED_N = 15998
DECODE_B, DECODE_LEN_LO = 8, 12000
# sequence-parallel training: the training config over a 16384-token batch
SP_T, SP_STEPS = 16384, 3
# GPipe: 2 stages x 2 layers, 4 microbatches
PP_B, PP_T, PP_MICRO = 4, 2048, 4
# K9: the example's shape and one whose shard is 2 MiB
K9_RANKS, K9_SHAPES, K9_ITERS, K9_REPEATS = (1, 2, 4, 8), (1024, 8192), 20, 50
K9_GATE = 1e-2  # the example's gate, beside REL_GATE x max |ref|


def _forward_launches(ctx, add=True) -> int:
    """Forward kernel launches since the counts were zeroed, without the
    guarded fallback launches (which exit at once); adds them to the
    run's per-kernel sums."""
    f = ctx.fwd_forms
    if add:
        ctx.launches["K1"] += f["online"]
        ctx.launches["K1b"] += f["bound"]
        ctx.launches["K5"] += f["kmajor"]
    return f["online"] + f["bound"] + f["kmajor"]


def _grads_close(ctx, grads, grads_ref, what):
    """Each gradient within BWD_GATE x max |reference|, which must be > 0."""
    line = []
    for name, g, w in zip(("dQ", "dK", "dV"), grads, grads_ref):
        e, ref = ctx.diff(g, w), w.float().abs().max().item()
        line.append(f"{name} {e:.3e}/{ref:.3e}")
        _check(ref > 0 and e <= BWD_GATE * ref
               and bool(ctx.torch.isfinite(g).all()),
               f"{what} {name}: max|diff| {e:.3e}, max|ref| {ref:.3e}")
    return ", ".join(line)


def _shared_card_mesh(ctx, n, axis="sp"):
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    return make_mesh((n,), (axis,), [ctx.dev] * n)


def _phase_ring_steps(ctx, n_ranks):
    """K1 / K1b / K5 and K4 against their plain versions at the shapes one
    ring step gives them: a [1, H, L, d] query shard over one [1, Hkv, L, d]
    K/V block, fp32 O, `softmax="auto"`; the backward against the LSE of a
    context of two blocks, as a ring step gets the global LSE. The phases
    after this one hold the ring against `flash_attention`, which is these
    same kernels on the whole sequence."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward, flash_attention_backward_plain)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward, flash_attention_forward_plain)

    full = RING_N // n_ranks
    ragged = -(-RING_RAGGED_N // n_ranks)
    tail = n_ranks * ragged - RING_RAGGED_N
    assert 0 < tail < ragged
    form_kernel = dict(online="K1", bound="K1b", kmajor="K5")

    def segs(length, pad, value, blocks=1):
        """Segment ids of `blocks` shards, the last one ending in `pad`
        rows of `value` (the ring's mark of the padded tail)."""
        ids = torch.zeros(1, blocks * length, dtype=torch.int32,
                          device=ctx.dev)
        if pad:
            ids[:, -pad:] = value
        return ids

    # (name, L, Hkv, the step's mask options, (q ids, k ids) of the step
    # and of the two-block context)
    cases = [
        ("full block", full, RING_H, dict(causal=False), None),
        ("full block, GQA", full, 4, dict(causal=False), None),
        (f"block one hop behind, window {RING_WINDOW}", full, RING_H,
         dict(causal=True, window=RING_WINDOW, kv_offset=full), None),
        (f"last block with {tail} pad keys, segment ids", ragged, RING_H,
         dict(causal=False), (0, tail)),
        (f"last block and {tail} pad queries, segment ids", ragged, RING_H,
         dict(causal=False), (tail, tail)),
    ]
    for name, length, hkv, opts, pads in cases:
        q, do = (ctx.mk(1, RING_H, length, 128) for _ in range(2))
        # a context of two blocks. Causal: the block behind the queries
        # and their own, and the step attends the one behind; else the
        # step's block is the second, which ends in the pad
        k2, v2 = (ctx.mk(1, hkv, 2 * length, 128) for _ in range(2))
        lo = 0 if opts["causal"] else length
        k, v = (x[:, :, lo:lo + length].contiguous() for x in (k2, v2))
        kw, kw2 = dict(opts), dict(opts)
        if pads is not None:
            qseg = segs(length, pads[0], -1)
            kw.update(q_segment_ids=qseg,
                      kv_segment_ids=segs(length, pads[1], -2))
            kw2.update(q_segment_ids=qseg,
                       kv_segment_ids=segs(length, pads[1], -2, blocks=2))
        ctx.zero_counts()
        o, lse = flash_attention_forward(q, k, v, out_dtype=torch.float32,
                                         **kw)
        torch.cuda.synchronize()
        forms = [f for f, n in ctx.fwd_forms.items() if n and f != "fallback"]
        _check(len(forms) == 1 and ctx.fwd_forms[forms[0]] == 1,
               f"ring step {name}: forward launches {dict(ctx.fwd_forms)}")
        kern = form_kernel[forms[0]]
        o_p, lse_p = flash_attention_forward_plain(
            q, k, v, out_dtype=torch.float32, **kw)
        (e_o, ref, ok), e_l = ctx.o_close(o, o_p), ctx.diff(lse, lse_p)
        ctx.rec[kern]["max_abs_err"] = max(ctx.rec[kern]["max_abs_err"],
                                           e_o, e_l)
        _check(ok and e_l <= GATE and bool(torch.isfinite(o).all()),
               f"ring step {name}: {kern} vs plain O {e_o:.3e} (max|O| "
               f"{ref:.3e}), LSE {e_l:.3e}")
        del o, lse, o_p, lse_p
        # the backward against the LSE of the two-block context
        o2, lse2 = flash_attention_forward(q, k2, v2, **kw2)
        args = (q, k, v, o2, lse2, do)
        grads = flash_attention_backward(*args, **kw)
        torch.cuda.synchronize()
        plain = flash_attention_backward_plain(*args, **kw)
        line = _grads_close(ctx, grads, plain, f"ring step {name}: K4")
        ctx.rec["K4"]["max_abs_err"] = max(
            ctx.rec["K4"]["max_abs_err"],
            *(ctx.diff(g, w) for g, w in zip(grads, plain)))
        print(f"[ring-step] {name}: B=1 H={RING_H} Hkv={hkv} {length} x "
              f"{length}, fp32 O, softmax auto -> {kern}: vs plain max|dO|="
              f"{e_o:.3e} (max|O| {ref:.3e}) max|dLSE|={e_l:.3e}; K4 against "
              f"the LSE of a {2 * length}-key context vs plain: "
              f"max|diff|/max|ref| {line} (gate {BWD_GATE} x max|ref|)",
              flush=True)
        del q, do, k2, v2, k, v, o2, lse2, args, grads, plain


def _phase_ring_attention(ctx, mesh, where):
    """Ring attention alone against one call on the whole sequence."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops.attention import flash_attention
    from cuda_flashattention_torch.parallel.ring import ring_attention
    from cuda_flashattention_torch.utils.profiling import (
        covered_share, device_events)
    from cuda_flashattention_torch.utils.timing import cuda_time_ms

    n_ranks = mesh.shape["sp"]
    tri = n_ranks * (n_ranks + 1) // 2
    # (name, N, Hkv, causal, window, forward = K4 launches)
    cases = [
        ("causal", RING_N, RING_H, True, 0, tri),
        ("ragged non-causal", RING_RAGGED_N, RING_H, False, 0,
         n_ranks * n_ranks),
        ("GQA causal", RING_N, 4, True, 0, tri),
        (f"causal window {RING_WINDOW}", RING_N, RING_H, True, RING_WINDOW,
         2 * n_ranks - 1),
    ]
    kept = None
    for name, n, hkv, causal, window, expect in cases:
        q = ctx.mk(1, RING_H, n, 128).requires_grad_()
        k = ctx.mk(1, hkv, n, 128).requires_grad_()
        v = ctx.mk(1, hkv, n, 128).requires_grad_()
        do = ctx.mk(1, RING_H, n, 128)
        kw = dict(causal=causal, window=window)
        ctx.zero_counts()
        o = ring_attention(q, k, v, mesh, **kw)
        grads = torch.autograd.grad(o, (q, k, v), do)
        torch.cuda.synchronize()
        forms = dict(ctx.fwd_forms)
        n_fwd, n_bwd = _forward_launches(ctx), ctx.bwd_launches["fused"]
        ctx.launches["K4"] += n_bwd
        o_ref = flash_attention(q, k, v, **kw)
        grads_ref = torch.autograd.grad(o_ref, (q, k, v), do)
        e, ref, ok = ctx.o_close(o, o_ref)
        line = _grads_close(ctx, grads, grads_ref, f"ring {name}")
        print(f"[ring] {name} ({where}): B=1 H={RING_H} Hkv={hkv} N={n} over "
              f"{n_ranks} ranks: forward launches {n_fwd} (online "
              f"{forms['online']}, bound {forms['bound']}, K-major "
              f"{forms['kmajor']}; guarded fallback {forms['fallback']}), "
              f"K4 {n_bwd} (expect {expect} each); vs one rank: max|dO|="
              f"{e:.3e} (max|O| {ref:.3e}), max|diff|/max|ref| {line}",
              flush=True)
        _check(ok, f"ring {name}: O {e:.3e} against max|O| {ref:.3e}")
        _check(n_fwd == expect and n_bwd == expect
               and ctx.bwd_launches["dkdv"] == ctx.bwd_launches["dq"] == 0,
               f"ring {name} launch counts {forms} {ctx.bwd_launches}")
        if name == "causal":
            kept = (q, k, v, do, o_ref, grads_ref, o)
            ctx.rec["K4"]["max_abs_err"] = max(
                ctx.rec["K4"]["max_abs_err"],
                *(ctx.diff(g, w) for g, w in zip(grads, grads_ref)))
    q, k, v, do, o_ref, grads_ref, o_ring = kept

    def fwd(fn):
        with torch.no_grad():
            return fn(q, k, v, causal=True)

    def fwd_bwd(fn):
        return torch.autograd.grad(fn(q, k, v, causal=True), (q, k, v), do)

    ring = lambda *a, **kw: ring_attention(*a, mesh=mesh, **kw)
    t = {(name, what): cuda_time_ms(lambda: run(fn), iters=3, warmup=1)
         for name, fn in (("ring", ring), ("one rank", flash_attention))
         for what, run in (("forward", fwd), ("forward+backward", fwd_bwd))}
    print(f"[ring] causal N={RING_N}, {n_ranks} ranks ({where}): forward "
          f"{t['ring', 'forward']:.3f} ms (one rank "
          f"{t['one rank', 'forward']:.3f} ms), forward+backward "
          f"{t['ring', 'forward+backward']:.3f} ms (one rank "
          f"{t['one rank', 'forward+backward']:.3f} ms) ({ctx.card})",
          flush=True)

    # how much of the copies' time lies under a step kernel: the copies
    # are whatever ran on a stream that is neither the caller's nor one
    # that carried a step kernel. The caller's stream is the one that ran
    # the markers, spin kernels launched in the same window before and after
    # the ring: late in a long process the profiler has been seen to drop
    # the first kernels of a window. A window that lost both markers or
    # every step kernel is profiled again.
    def marked():
        torch.cuda._sleep(1000)
        fwd_bwd(ring)
        torch.cuda._sleep(1000)

    for _ in range(PROFILE_ATTEMPTS):
        events, wall_ms = device_events(marked)
        marks = [e for e in events if "spin_kernel" in e.name]
        steps = [e for e in events
                 if _kernel_of(e.name) in ("K1", "K1b", "K5", "K4")]
        if marks and steps:
            break
    _check(bool(marks and steps), f"the profiler lost the marker or every "
           f"step kernel of the ring in {PROFILE_ATTEMPTS} windows; the last "
           f"had {len(events)} device events, {len(marks)} markers, "
           f"{len(steps)} step kernels, names "
           f"{sorted({e.name[:60] for e in events})}")
    compute = {e.stream for e in steps} | {marks[0].stream}
    copies = [e for e in events if e.stream not in compute]
    copy_ms = sum(e.end_us - e.start_us for e in copies) / 1e3
    share = covered_share(copies, steps)
    print(f"[ring] profile of one forward+backward ({where}): "
          f"{len(events)} device events on "
          f"{len({e.stream for e in events})} streams in {wall_ms:.3f} ms of "
          f"wall; {len(steps)} step kernels; {len(copies)} copies on the "
          f"copy streams, {copy_ms:.3f} ms in all, {share:.1%} of it under a "
          f"K1/K1b/K4 kernel ({ctx.card})", flush=True)
    _check(len(copies) > 0 and share == share,
           "the profiler saw no copy on the ring's copy streams")
    return kept


def _phase_ulysses(ctx, mesh, kept):
    """Ulysses on the causal case against one rank and against the ring."""
    torch = ctx.torch
    from cuda_flashattention_torch.parallel.ulysses import ulysses_attention
    from cuda_flashattention_torch.utils.timing import cuda_time_ms

    q, k, v, do, o_ref, grads_ref, o_ring = kept
    n_ranks = mesh.shape["sp"]
    ctx.zero_counts()
    o = ulysses_attention(q, k, v, mesh, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    forms = dict(ctx.fwd_forms)
    n_fwd, n_bwd = _forward_launches(ctx), ctx.bwd_launches["fused"]
    ctx.launches["K4"] += n_bwd
    e, ref, ok = ctx.o_close(o, o_ref)
    e_ring = ctx.diff(o, o_ring)
    line = _grads_close(ctx, grads, grads_ref, "ulysses")
    ms_f = cuda_time_ms(lambda: ulysses_attention(
        q.detach(), k.detach(), v.detach(), mesh, causal=True),
        iters=3, warmup=1)
    ms_fb = cuda_time_ms(lambda: torch.autograd.grad(
        ulysses_attention(q, k, v, mesh, causal=True), (q, k, v), do),
        iters=3, warmup=1)
    print(f"[ulysses] causal B=1 H={RING_H} N={RING_N} over {n_ranks} ranks: "
          f"forward launches {n_fwd} (online {forms['online']}, bound "
          f"{forms['bound']}, K-major {forms['kmajor']}), K4 {n_bwd} (expect "
          f"{n_ranks} each); vs one rank max|dO|={e:.3e} (max|O| {ref:.3e}), "
          f"vs the ring {e_ring:.3e} (gate {GATE}); max|diff|/max|ref| "
          f"{line}; forward {ms_f:.3f} ms, forward+backward {ms_fb:.3f} ms "
          f"({ctx.card})", flush=True)
    _check(ok and e_ring <= GATE, f"ulysses O: {e:.3e} vs one rank, "
           f"{e_ring:.3e} vs the ring")
    _check(n_fwd == n_ranks and n_bwd == n_ranks,
           f"ulysses launch counts {forms} {ctx.bwd_launches}")


def _phase_ring_decode(ctx, mesh):
    """Sharded-cache decode: K6 on each rank's resident shard."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops.decode import (
        decode_attention, decode_attention_plain)
    from cuda_flashattention_torch.ops.quant import quantize_kv
    from cuda_flashattention_torch.parallel.mesh import shard_on_axis
    from cuda_flashattention_torch.parallel.ring import ring_decode
    from cuda_flashattention_torch.utils.timing import cuda_time_ms

    n_ranks = mesh.shape["sp"]
    local_n = RING_N // n_ranks
    q = ctx.mk(DECODE_B, RING_H, 128, peak=Q_PEAK)
    k = ctx.mk(DECODE_B, 4, RING_N, 128, peak=K_PEAK)
    v = ctx.mk(DECODE_B, 4, RING_N, 128)
    lengths = torch.randint(DECODE_LEN_LO, RING_N + 1, (DECODE_B,),
                            generator=ctx.gen, device=ctx.dev,
                            dtype=torch.int32)
    lengths[0] = RING_N
    kv8 = quantize_kv(k, v, "int8")
    cut = lambda x: shard_on_axis(mesh, x, 2, "sp")
    # O comes back in bf16: at |O| ~ 0.3 one ulp is 1.95e-3, so O is held
    # to the bf16 gate whatever the cache; the fp32 LSE of the int8 cache
    # is held to the repo's int8 gate against the same cache unsharded
    for qtype, (kk, vv, scales), lse_gate in (
            ("bf16", (k, v, {}), GATE),
            ("int8", (kv8.k_q, kv8.v_q, dict(k_scale=kv8.k_scale,
                                             v_scale=kv8.v_scale)), 1e-3)):
        shards = dict(k=cut(kk), v=cut(vv),
                      **{n: cut(s) for n, s in scales.items()})
        for window in (0, RING_WINDOW):
            run = lambda: ring_decode(q, shards["k"], shards["v"], lengths,
                                      mesh, window=window,
                                      **{n: shards[n] for n in scales})
            ctx.zero_counts()
            o, lse = run()
            torch.cuda.synchronize()
            n_k6 = decode_attention.launches
            ctx.launches["K6"] += n_k6
            whole = lambda: decode_attention(q, kk, vv, lengths,
                                             window=window, **scales)
            o_w, lse_w = whole()
            e, ref = ctx.diff(o, o_w), o_w.float().abs().max().item()
            e_l = ctx.diff(lse, lse_w)
            ms = cuda_time_ms(run, before=ctx.l2_flush.zero_)
            ms_w = cuda_time_ms(whole, before=ctx.l2_flush.zero_)
            # ... and against the plain version: the whole call on the
            # whole cache, then K6 alone on each rank's shard under the
            # live lengths and windows the ring derives for it (a shard
            # wholly before the window has every window <= 0 and must
            # come back empty: O = 0 exactly)
            o_p, lse_p = decode_attention_plain(q, kk, vv, lengths,
                                                window=window, **scales)
            (e_p, _, ok_p), e_lp = ctx.o_close(o, o_p), ctx.diff(lse, lse_p)
            _check(ok_p and e_lp <= lse_gate,
                   f"ring decode {qtype} window {window} vs the plain "
                   f"version on the whole cache: O {e_p:.3e}, LSE {e_lp:.3e}")
            shard_line = []
            for idx in range(n_ranks):
                my_len = (lengths - idx * local_n).clamp(0, local_n)
                kw = {n: shards[n][idx] for n in scales}
                if window:
                    kw["windows"] = my_len - lengths + window + idx * local_n
                args = (q, shards["k"][idx], shards["v"][idx], my_len)
                o_s, lse_s = decode_attention(*args, **kw)
                o_sp, lse_sp = decode_attention_plain(*args, **kw)
                e_s, ref_s, ok_s = ctx.o_close(o_s, o_sp)
                e_ls = ctx.diff(lse_s, lse_sp)
                shard_line.append(f"{idx}: {e_s:.3e}/{ref_s:.3e}, "
                                  f"{e_ls:.3e}")
                _check((ok_s if ref_s > 0 else e_s == 0.0) and e_ls <= GATE,
                       f"K6 on shard {idx} of the {qtype} cache, window "
                       f"{window}: O {e_s:.3e} (max|O| {ref_s:.3e}), LSE "
                       f"{e_ls:.3e}")
                ctx.rec["K6"]["max_abs_err"] = max(
                    ctx.rec["K6"]["max_abs_err"], e_s, e_ls)
            print(f"[ring-decode] {qtype} cache, window {window}: vs the "
                  f"plain version on the whole cache max|dO|={e_p:.3e} "
                  f"max|dLSE|={e_lp:.3e}; K6 vs plain on each "
                  f"{local_n}-token shard (max|dO|/max|O|, max|dLSE|): "
                  + "; ".join(shard_line), flush=True)
            print(f"[ring-decode] {qtype} cache, window {window}: B="
                  f"{DECODE_B} H={RING_H} Hkv=4, {RING_N}-token cache over "
                  f"{n_ranks} ranks, lengths {lengths.tolist()}: K6 launches "
                  f"{n_k6} (expect {n_ranks}); vs K6 on the whole cache "
                  f"max|dO|={e:.3e} (max|O| {ref:.3e}; gate {GATE}) "
                  f"max|dLSE|={e_l:.3e} (gate {lse_gate}); sharded "
                  f"{ms:.4f} ms, whole {ms_w:.4f} ms, "
                  f"cold L2 ({ctx.card})", flush=True)
            _check(ref > 0 and e <= min(GATE, REL_GATE * ref)
                   and e_l <= lse_gate,
                   f"ring decode {qtype} window {window}: O {e:.3e}, LSE "
                   f"{e_l:.3e}")
            _check(n_k6 == n_ranks, f"ring decode launched K6 {n_k6} times")
            ctx.rec["K6"]["max_abs_err"] = max(ctx.rec["K6"]["max_abs_err"],
                                               e, e_l)


def _phase_sp_training(ctx, mesh):
    """The main path of the distributed layer: the 271M training config
    takes sequence-parallel train steps on one batch of B=1 x T=16384."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm

    n_ranks = mesh.shape["sp"]
    tcfg = tfm.TransformerConfig(dtype=torch.bfloat16,
                                 **{**TRAIN_KW, "max_seq": SP_T})
    gen = torch.Generator(device=ctx.dev).manual_seed(0)
    model = tfm.Transformer(tcfg, generator=gen)
    tokens = torch.randint(0, tcfg.vocab_size, (1, SP_T), generator=gen,
                           device=ctx.dev, dtype=torch.int32)
    step = tfm.make_train_step(
        model, torch.optim.SGD(model.parameters(), lr=1e-4), mesh=mesh,
        seq_axis="sp")
    step(tokens)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx.zero_counts()
    step_s, losses = [], []
    for _ in range(SP_STEPS):
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    forms = dict(ctx.fwd_forms)
    n_fwd = _forward_launches(ctx)
    counts = dict(fwd=n_fwd, **ctx.bwd_launches)
    ctx.launches["K4"] += counts["fused"]
    expect = SP_STEPS * tcfg.n_layers * n_ranks * (n_ranks + 1) // 2
    step_ms = statistics.median(step_s) * 1e3
    print(f"[sp-train] 271M config, B=1 T={SP_T}, sequence_mesh({n_ranks}), "
          f"seq_axis='sp', SGD(1e-4): launches over {SP_STEPS} steps: "
          f"forward {n_fwd} (online {forms['online']}, bound "
          f"{forms['bound']}, K-major {forms['kmajor']}; guarded fallback "
          f"{forms['fallback']}), K4 {counts['fused']}, K2 {counts['dkdv']}, "
          f"K3 {counts['dq']} (expect {expect}, {expect}, 0, 0); step "
          f"{step_ms:.3f} ms (median of {SP_STEPS}: "
          f"{', '.join(f'{x * 1e3:.3f}' for x in step_s)}), "
          f"{SP_T / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} ({ctx.card})", flush=True)
    _check(counts == dict(fwd=expect, fused=expect, dkdv=0, dq=0),
           f"sequence-parallel train-step launch counts {counts}")
    _check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # where one step's device time goes, by kernel group (the ranks' streams
    # overlap on the card: shares are of the summed kernel time)
    from cuda_flashattention_torch.utils.profiling import kernel_times
    prof = kernel_times(lambda: step(tokens))
    groups = {}
    for n, t in prof.ms.items():
        groups[_group_of(n)] = groups.get(_group_of(n), 0.0) + t
    total = sum(groups.values()) or float("nan")
    print(f"[sp-train] one step profiled: busy {prof.busy_ms:.3f} ms of "
          f"{prof.wall_ms:.3f} ms wall; " + ", ".join(
              f"{g} {t:.3f} ms ({100 * t / total:.1f}%)" for g, t in
              sorted(groups.items(), key=lambda x: -x[1]))
          + f" ({ctx.card})", flush=True)

    def loss_and_grads(**kw):
        model.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(model, tokens, **kw)
        loss.backward()
        return loss.item(), [p.grad.float() for p in model.parameters()]

    names = [n for n, _ in model.named_parameters()]
    loss_sp, grads_sp = loss_and_grads(mesh=mesh, seq_axis="sp")
    loss_1, grads_1 = loss_and_grads()
    errs = [((a - b).norm() / b.norm()).item()
            for a, b in zip(grads_sp, grads_1)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    print(f"[sp-train] sequence-parallel vs the same model without a mesh at "
          f"T={SP_T}: loss {loss_sp:.6f} vs {loss_1:.6f} (|d| "
          f"{abs(loss_sp - loss_1):.3e}, gate {LOSS_GATE}); worst gradient "
          f"relative L2 {errs[worst]:.3e} ({names[worst]}; gate {GRAD_GATE})",
          flush=True)
    _check(abs(loss_sp - loss_1) <= LOSS_GATE,
           f"sequence-parallel loss {loss_sp} vs {loss_1}")
    _check(errs[worst] <= GRAD_GATE, f"sequence-parallel gradient of "
           f"{names[worst]}: relative L2 {errs[worst]:.3e}")


def _phase_gpipe(ctx):
    """`pipeline_forward` of the training config against `forward`."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm

    tcfg = tfm.TransformerConfig(dtype=torch.bfloat16, **TRAIN_KW)
    gen = torch.Generator(device=ctx.dev).manual_seed(0)
    model = tfm.Transformer(tcfg, generator=gen)
    tokens = torch.randint(0, tcfg.vocab_size, (PP_B, PP_T), generator=gen,
                           device=ctx.dev, dtype=torch.int32)
    mesh = _shared_card_mesh(ctx, 2, "pp")
    with torch.no_grad():
        want = tfm.forward(model, tokens)
        ctx.zero_counts()
        got = tfm.pipeline_forward(model, tokens, mesh, n_micro=PP_MICRO)
        torch.cuda.synchronize()
    n_fwd = _forward_launches(ctx)
    e = ctx.diff(got, want)
    print(f"[gpipe] 271M config, B={PP_B} T={PP_T}, 2 stages x 2 layers, "
          f"n_micro={PP_MICRO}: forward launches {n_fwd} (expect "
          f"{tcfg.n_layers * PP_MICRO}); logits vs forward: max|diff|="
          f"{e:.3e} (gate {LOGIT_GATE})", flush=True)
    _check(bool(torch.isfinite(got).all()) and e <= LOGIT_GATE,
           f"pipeline_forward logits off by {e:.3e}")
    _check(n_fwd == tcfg.n_layers * PP_MICRO,
           f"pipeline_forward launched the forward {n_fwd} times")


def _k9_bound(n, rows, d):
    """K9's least time: every rank reads its shard, pushes n - 1 shards
    and reads them back, reads W and writes o; n x n tile products."""
    shard = rows * d * 2
    nbytes = n * ((2 * n - 1) * shard + d * d * 2 + rows * d * 4)
    return _bound(nbytes, n * n * 2.0 * rows * d * d)


def _phase_device_ring(ctx, devices, where, record):
    """K9 against its plain version and against (sum x_i) @ W in fp32."""
    torch = ctx.torch
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    from cuda_flashattention_torch.utils.timing import cuda_time_ms

    d = 128
    kernel_ms = {}
    for rows in K9_SHAPES:
        for n in K9_RANKS:
            mesh = make_mesh((n,), ("sp",),
                             [devices[i % len(devices)] for i in range(n)])
            x, w = ctx.mk(n * rows, d), ctx.mk(d, d)
            o = device_ring_matmul(x, w, mesh)
            torch.cuda.synchronize()
            grid = device_ring_matmul.last_grid
            o_p = ring_matmul_plain(x, w, mesh)
            ref = (x.float().view(n, rows, d).sum(0) @ w.float()).repeat(n, 1)
            top = ref.abs().max().item()
            e_ref, e_plain = ctx.diff(o, ref), ctx.diff(o, o_p)
            ms = cuda_time_ms(lambda: device_ring_matmul(x, w, mesh),
                              iters=K9_ITERS)
            ms_p = cuda_time_ms(lambda: ring_matmul_plain(x, w, mesh),
                                iters=K9_ITERS)
            x3 = x.view(n, rows, d)
            ms_lib = cuda_time_ms(
                lambda: torch.einsum("nld,de->le", x3, w), iters=K9_ITERS)
            ms_k = _device_ms_by_kernel(
                lambda: device_ring_matmul(x, w, mesh), ("K9",),
                iters=K9_ITERS)["K9"]
            kernel_ms[rows, n] = ms_k
            bound = _k9_bound(n, rows, d)
            print(f"[K9] n={n} ranks ({where}), L={rows} d={d}: grid "
                  f"{grid[0]} CTAs x {grid[1]} ranks per launch; vs "
                  f"tile((sum x_i) @ W) in fp32 {e_ref:.3e} (max|ref| "
                  f"{top:.3e}), vs the plain ring {e_plain:.3e} (gates "
                  f"{K9_GATE} and {REL_GATE} x max|ref|); wrapper {ms:.4f} "
                  f"ms, kernel alone {ms_k:.4f} ms, plain ring {ms_p:.4f} "
                  f"ms, one einsum over the shards {ms_lib:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}) "
                  f"({ctx.card})", flush=True)
            gate = min(K9_GATE, REL_GATE * top)
            _check(top > 0 and e_ref <= gate and e_plain <= gate
                   and bool(torch.isfinite(o).all()),
                   f"K9 n={n} L={rows}: {e_ref:.3e} vs the reference, "
                   f"{e_plain:.3e} vs the plain ring")
            if record:
                r = ctx.rec["K9"]
                r["max_abs_err"] = max(r["max_abs_err"], e_plain)
                if (n, rows) == (4, K9_SHAPES[0]):  # the example's path
                    r.update(ms=ms, plain_ms=ms_p, library_ms=ms_lib,
                             **bound)
        hops = K9_RANKS[-1] - 1
        per_hop = (kernel_ms[rows, K9_RANKS[-1]] - kernel_ms[rows, 1]) / hops
        print(f"[K9] L={rows} ({where}): kernel alone "
              f"{kernel_ms[rows, K9_RANKS[-1]]:.4f} ms at n={K9_RANKS[-1]} "
              f"against {kernel_ms[rows, 1]:.4f} ms at n=1: "
              f"{per_hop * 1e3:.2f} us per hop ({ctx.card})", flush=True)
    n = K9_RANKS[-1]
    mesh = make_mesh((n,), ("sp",),
                     [devices[i % len(devices)] for i in range(n)])
    x, w = ctx.mk(n * K9_SHAPES[0], d), ctx.mk(d, d)
    first = device_ring_matmul(x, w, mesh)
    same = sum(torch.equal(device_ring_matmul(x, w, mesh), first)
               for _ in range(K9_REPEATS))
    print(f"[K9] n={n} ({where}): {same} of {K9_REPEATS} repeats equal the "
          f"first call bit for bit", flush=True)
    _check(same == K9_REPEATS, f"K9 flaked: {same} of {K9_REPEATS} repeats "
           f"bit-identical")


def _phase_device_ring_path(ctx):
    """K9's own path, as a user runs it: the example stage."""
    from cuda_flashattention_torch.examples import device_ring as stage
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    ctx.zero_counts()
    rc = stage.main(["--ranks", "4"] if ctx.torch.cuda.device_count() < 2
                    else [])
    n = device_ring_matmul.launches
    ctx.launches["K9"] += n
    print(f"[K9] the example stage returned {rc}; K9 launches {n}",
          flush=True)
    _check(rc == 0 and n > 0, f"the device-ring stage returned {rc} after "
           f"{n} launches")


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
    from cuda_flashattention_torch.ops import flash_fwd as ffwd
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
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
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

    def vs_bound(ms, bound):
        """A row's time as a share of its bound, for its printed line."""
        return (f"{100 * bound['bound_ms'] / ms:.1f}% of its bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")

    bwd_launches = flash_attention_backward.launches

    fwd_forms = flash_attention_forward.form_launches

    def zero_counts():
        flash_attention_forward.launches = 0
        for name in fwd_forms:
            fwd_forms[name] = 0
        decode_attention.launches = 0
        paged_decode_attention.launches = 0
        fa1_attention.launches = 0
        device_ring_matmul.launches = 0
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

    def device_ms(fn, pattern, iters=5, per_call=1):
        """Device ms per call of the kernels whose name matches `pattern`
        (torch.profiler; the mean per launch times the `per_call` launches
        of a call), each call on a cold L2 cache: the kernel alone, without
        the small launches and host work of its wrapper."""
        prof = kernel_times(lambda: (l2_flush.zero_(), fn()), iters=iters)
        return per_call * launch_ms(prof, lambda n: re.search(pattern, n))

    failures = []
    # per kernel: ms, plain_ms, bound_ms, bound_by, library_ms, max_abs_err
    rec = {kn: dict(max_abs_err=0.0) for kn in
           ("K1", "K1b", "K5", "K2", "K3", "K4", "K6", "K7", "K8", "K9")}
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
        kw = dict(causal=causal, out_dtype=torch.float32, softmax="online")
        o, lse = flash_attention_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        o_p, lse_p = flash_attention_forward_plain(q, k, v, **kw)
        e_o, e_l = diff(o, o_p), diff(lse, lse_p)
        ms = cuda_time_ms(lambda: flash_attention_forward(q, k, v, **kw))
        ms_p = cuda_time_ms(
            lambda: flash_attention_forward_plain(q, k, v, **kw), iters=5)
        bound = _bound(_nbytes(q, k, v, o, lse),
                       attention_flops(b, h, nq, nk, 128, causal=causal))
        lib_ms = sdpa_ms(q, k, v, is_causal=causal)
        print(f"[K1] {name}: B={b} H={h} Hkv={hkv} Nq={nq} Nk={nk} "
              f"max|dO|={e_o:.3e} max|dLSE|={e_l:.3e} kernel {ms:.4f} ms "
              f"({vs_bound(ms, bound)}) library call {lib_ms:.4f} ms "
              f"plain {ms_p:.4f} ms ({card})", flush=True)
        rec["K1"]["max_abs_err"] = max(rec["K1"]["max_abs_err"], e_o, e_l)
        if "ms" not in rec["K1"]:  # the first case: the prefill's shape
            rec["K1"].update(ms=ms, plain_ms=ms_p, library_ms=lib_ms,
                             **bound)
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

    # ---- 3b. the forward's other forms vs the plain version ---------------
    # K1 with a window, segment ids and quantized K/V; K1b (bound softmax,
    # Q-major) and K5 (bound softmax, K-major) in each storage type, with
    # and without quantize_q; all on peaked inputs at the serving model's
    # width. "prefix": the last chunk of chunked serving reading the cache
    # (512 rows over 3584 keys, every key visible); "windowed prefix": the
    # same under cfg.window = 1024 (a 1024-key slice, causal + window with
    # kv_offset 1024, so that only the window cuts).
    gen = torch.Generator(device=dev).manual_seed(4)
    b, h, hkv, d = BATCH, 16, 4, 128

    def stored(k, v, qtype):
        """(k, v, scales) as a cache of `qtype` holds them."""
        if qtype is None:
            return k, v, {}
        kv = quantize_kv(k, v, qtype)
        return kv.k_q, kv.v_q, dict(k_scale=kv.k_scale, v_scale=kv.v_scale)

    def run_form(form, q, k, v, quantize_q=False, **kw):
        """One pinned kernel form, whatever "auto" would route to:
        "online" (K1), "bound" (K1b) or "kmajor" (K5), the bound ones
        without the guarded fallback launch."""
        plan = ffwd._plan(
            q, k, v, None, kw.get("causal", False), kw.get("window", 0),
            kw.get("kv_offset", 0), None, kw.get("k_scale"),
            kw.get("v_scale"), None, None,
            "online" if form == "online" else "bound_unchecked", quantize_q)
        plan = dataclasses.replace(plan, use_kmajor=form == "kmajor")
        return ffwd._fwd_cuda(q, k, v, plan, torch.float32,
                              kw.get("k_scale"), kw.get("v_scale"), None,
                              None)

    def fwd_bound(q, k, v, scales, pairs):
        """bound_ms of one forward call: K/V and scales at their storage
        width, O in fp32; `pairs` (query, key) pairs of 4·d flops."""
        nbytes = (_nbytes(q, k, v, *scales.values())
                  + q.numel() * 4 + q.numel() // d * 4)
        return _bound(nbytes, 4.0 * d * pairs)

    def visible_mask(nq, nk, kw):
        """[B or 1, 1, Nq, Nk] bool: the (query, key) pairs a forward call
        with these masks sees."""
        rows_ = (torch.arange(nq, device=dev)[:, None]
                 + kw.get("kv_offset", 0))
        cols_ = torch.arange(nk, device=dev)[None, :]
        ok = torch.ones(nq, nk, dtype=torch.bool, device=dev)
        if kw.get("causal"):
            ok = cols_ <= rows_
            if kw.get("window"):
                ok = ok & (cols_ > rows_ - kw["window"])
        ok = ok[None, None]
        if kw.get("q_segment_ids") is not None:
            ok = ok & (kw["q_segment_ids"][:, None, :, None]
                       == kw["kv_segment_ids"][:, None, None, :])
        return ok

    def check_fwd(tag, kern, got, want):
        (o, lse), (o_p, lse_p) = got, want
        (e_o, ref, ok), e_l = o_close(o, o_p), diff(lse, lse_p)
        rec[kern]["max_abs_err"] = max(rec[kern]["max_abs_err"], e_o, e_l)
        if not (ok and e_l <= GATE and bool(torch.isfinite(o).all())):
            failures.append(f"{kern} {tag}: dO {e_o:.3e} (max|O| {ref:.3e}) "
                            f"dLSE {e_l:.3e}")
        return f"max|dO|={e_o:.3e} (max|O| {ref:.3e}) max|dLSE|={e_l:.3e}"

    # K1 (online) under a window and under segment ids, at the chunk's
    # own shape
    q = mk(b, h, PROMPT, d, peak=Q_PEAK)
    k, v = mk(b, hkv, PROMPT, d, peak=K_PEAK), mk(b, hkv, PROMPT, d)
    seg = torch.repeat_interleave(
        torch.arange(4, device=dev),
        torch.tensor([200, 1, 120, 191], device=dev))[None].expand(b, PROMPT)
    for tag, kw in (("window 128", dict(causal=True, window=128)),
                    ("window 128, kv_offset -100",
                     dict(causal=True, window=128, kv_offset=-100)),
                    ("segments 200|1|120|191, causal",
                     dict(causal=True, q_segment_ids=seg,
                          kv_segment_ids=seg)),
                    ("segments, not causal",
                     dict(q_segment_ids=seg, kv_segment_ids=seg))):
        kw = dict(kw, out_dtype=torch.float32, softmax="online")
        got = flash_attention_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        line = check_fwd(tag, "K1", got,
                         flash_attention_forward_plain(q, k, v, **kw))
        ms = cuda_time_ms(lambda: flash_attention_forward(q, k, v, **kw))
        # the visible pairs, as the library call's boolean mask
        seen = visible_mask(PROMPT, PROMPT, kw)
        bound = fwd_bound(q, k, v, {}, h * int(seen.sum()) * b
                          // seen.shape[0])
        lib_ms = sdpa_ms(q, k, v, attn_mask=seen)
        print(f"[K1] {tag}: B={b} H={h} Hkv={hkv} N={PROMPT} {line} kernel "
              f"{ms:.4f} ms ({vs_bound(ms, bound)}) library call (boolean "
              f"mask) {lib_ms:.4f} ms ({card})", flush=True)
    del q, k, v, seg

    fwd_shapes = [
        # tag, Nq, Nk, mask, visible pairs per (batch, head)
        ("prefix 512x3584", PAGED_CHUNK, 3584, dict(causal=False),
         PAGED_CHUNK * 3584),
        ("windowed prefix 512x1024", PAGED_CHUNK, 1024,
         dict(causal=True, window=1024, kv_offset=1024),
         sum(1023 - r for r in range(PAGED_CHUNK))),
    ]
    routed_kernel = {"online": "K1", "bound": "K1b", "kmajor": "K5"}
    form_ms = {}
    for tag, nq, nk, mask, pairs in fwd_shapes:
        q = mk(b, h, nq, d, peak=Q_PEAK)
        k_bf, v_bf = mk(b, hkv, nk, d, peak=K_PEAK), mk(b, hkv, nk, d)
        for qtype in (None, "int8", "fp8", "mixed"):
            k, v, scales = stored(k_bf, v_bf, qtype)
            kw = dict(mask, **scales)
            name = f"{tag}, {qtype or 'bf16'} K/V"
            # what "auto" routes to, with its guarded fallback launch
            zero_counts()
            got = flash_attention_forward(q, k, v, out_dtype=torch.float32,
                                          **kw)
            torch.cuda.synchronize()
            routed = next(f for f in ("bound", "kmajor", "online")
                          if fwd_forms[f])
            _check(fwd_forms == dict(online=int(routed == "online"),
                                     fallback=int(routed != "online"),
                                     bound=int(routed == "bound"),
                                     kmajor=int(routed == "kmajor")),
                   f"{name}: launches {fwd_forms}")
            kern = routed_kernel[routed]
            want = flash_attention_forward_plain(
                q, k, v, out_dtype=torch.float32, **kw)
            line = check_fwd(name, kern, got, want)
            # each form pinned, against the plain version of its strategy
            want_on = flash_attention_forward_plain(
                q, k, v, out_dtype=torch.float32, softmax="online", **kw)
            outs = {f: run_form(f, q, k, v, **kw)
                    for f in ("online", "bound", "kmajor")}
            torch.cuda.synchronize()
            for f, out in outs.items():
                check_fwd(f"{name} pinned {f}", routed_kernel[f], out,
                          want_on if f == "online" else want)
            e_km = max(diff(outs["kmajor"][0], outs["bound"][0]),
                       diff(outs["kmajor"][1], outs["bound"][1]))
            if not e_km <= 1e-4:
                failures.append(f"{name}: K5 vs K1b {e_km:.3e} > 1e-4")
            ms = {f: cuda_time_ms(lambda: run_form(f, q, k, v, **kw),
                                  iters=10)
                  for f in ("online", "bound", "kmajor")}
            ms_auto = cuda_time_ms(lambda: flash_attention_forward(
                q, k, v, out_dtype=torch.float32, **kw), iters=10)
            ms_unchecked = cuda_time_ms(lambda: flash_attention_forward(
                q, k, v, out_dtype=torch.float32, softmax="bound_unchecked",
                **kw), iters=10)
            ms_p = cuda_time_ms(lambda: flash_attention_forward_plain(
                q, k, v, out_dtype=torch.float32, **kw), iters=3, warmup=1)
            ms_d = device_ms(lambda: run_form(routed, q, k, v, **kw),
                             {"kmajor": "flash_fwd_kmajor",
                              "bound": "flash_fwd_bound_kernel",
                              "online": "flash_fwd_kernel"}[routed],
                             per_call=2 if routed == "kmajor" else 1)
            ms_on = device_ms(lambda: run_form("online", q, k, v, **kw),
                              "flash_fwd_kernel")
            form_ms[name] = ms
            bound = fwd_bound(q, k, v, scales, b * h * pairs)
            # the library call on the dequantised K/V (a band mask under a
            # window)
            if qtype is None:
                k_d, v_d = k, v
            else:
                k_d = (k.float() * scales["k_scale"][..., None]).to(
                    torch.bfloat16)
                v_d = (v.float() * scales["v_scale"][..., None]).to(
                    torch.bfloat16)
            band = None
            if mask["causal"]:
                rows_ = torch.arange(nq, device=dev)[:, None] + mask[
                    "kv_offset"]
                cols_ = torch.arange(nk, device=dev)[None, :]
                band = (cols_ <= rows_) & (cols_ > rows_ - mask["window"])
            lib_ms = sdpa_ms(q, k_d, v_d, attn_mask=band)
            print(f"[fwd] {name}: auto -> {kern}: {line}; K5 vs K1b "
                  f"{e_km:.3e}; wrapper ms: online {ms['online']:.4f}, "
                  f"bound (K1b) {ms['bound']:.4f}, K-major (K5) "
                  f"{ms['kmajor']:.4f}; auto {ms_auto:.4f} (unchecked "
                  f"{ms_unchecked:.4f}: the guard costs "
                  f"{(ms_auto - ms_unchecked) * 1e3:.1f} us); {kern} kernel "
                  f"alone {ms_d:.4f}; K1 (online) kernel alone {ms_on:.4f} "
                  f"({vs_bound(ms_on, bound)}); plain {ms_p:.4f}; library "
                  f"call {lib_ms:.4f} ({card})", flush=True)
            first = (kern == "K1b" and qtype is None) or (
                kern == "K5" and qtype == "fp8" and not mask["causal"])
            if first:  # the rows of the kernels' table
                rec[kern].update(ms=ms_auto, plain_ms=ms_p,
                                 library_ms=lib_ms, **bound)
            # quantize_q, where the storage allows it
            if qtype is not None:
                qkw = dict(kw, quantize_q=True, out_dtype=torch.float32)
                zero_counts()
                got = flash_attention_forward(q, k, v, **qkw)
                torch.cuda.synchronize()
                routed_q = next(f for f in ("bound", "kmajor")
                                if fwd_forms[f])
                _check(fwd_forms["fallback"] == 0 and fwd_forms["online"]
                       == 0, f"{name} quantize_q: launches {fwd_forms}")
                line = check_fwd(name + " quantize_q",
                                 routed_kernel[routed_q], got,
                                 flash_attention_forward_plain(q, k, v,
                                                               **qkw))
                ms_q = cuda_time_ms(lambda: flash_attention_forward(
                    q, k, v, **qkw), iters=10)
                ms_qd = device_ms(
                    lambda: flash_attention_forward(q, k, v, **qkw),
                    "flash_fwd_kmajor" if routed_q == "kmajor"
                    else "flash_fwd_bound_kernel",
                    per_call=2 if routed_q == "kmajor" else 1)
                print(f"[fwd] {name}, quantize_q -> "
                      f"{routed_kernel[routed_q]}: {line}; wrapper "
                      f"{ms_q:.4f} ms, kernel alone {ms_qd:.4f} ms ({card})",
                      flush=True)
        del q, k_bf, v_bf, k, v, got, want, want_on, outs
    _check(not failures, "; ".join(failures))

    # the loose-bound fallback: anti-aligned Q and K of large norm put every
    # score ~400 log2 units under the bound, so every bound weight
    # underflows. "bound" must return the online kernel's bits (the guarded
    # launch ran), "bound_unchecked" the degraded O = 0, LSE = NEG_INF.
    unit = torch.ones(d, device=dev) / math.sqrt(d)
    q = (40.0 * unit + mk(b, h, PAGED_CHUNK, d).float() * 0.1).to(
        torch.bfloat16)
    k = (-40.0 * unit + mk(b, hkv, 3584, d).float() * 0.1).to(torch.bfloat16)
    v = mk(b, hkv, 3584, d)
    for causal, kern in ((False, "K1b"), (True, "K5")):
        kw = dict(causal=causal, kv_offset=3584 if causal else 0,
                  out_dtype=torch.float32)
        o_on, lse_on = flash_attention_forward(q, k, v, softmax="online",
                                               **kw)
        zero_counts()
        o_b, lse_b = flash_attention_forward(q, k, v, softmax="bound", **kw)
        o_u, lse_u = flash_attention_forward(q, k, v,
                                             softmax="bound_unchecked", **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(o_b, o_on) and torch.equal(lse_b, lse_on))
        degraded = bool((lse_u == -1e30).all() and (o_u == 0).all())
        print(f"[fwd] loose bound ({kern}): 'bound' returns the online "
              f"kernel's bits: {same}; 'bound_unchecked' underflows to "
              f"O = 0, LSE = NEG_INF: {degraded}; online LSE in "
              f"[{lse_on.min().item():.1f}, {lse_on.max().item():.1f}]; "
              f"launches {fwd_forms}", flush=True)
        _check(same and degraded and fwd_forms["fallback"] == 1,
               f"loose-bound fallback ({kern}): same {same}, degraded "
               f"{degraded}, launches {fwd_forms}")
    del q, k, v, o_on, lse_on, o_b, lse_b, o_u, lse_u

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
                           flash_attention_forward_plain):
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

    # ---- 4b. main path of chunked serving --------------------------------
    # A 4096-token prompt per sequence through prefill_chunked(chunk=512),
    # then 128 decode_one steps: every chunk after the first reads the
    # cached prefix through K1b (bf16 and int8 caches) or K5 (fp8 caches,
    # and any quantized cache under cfg.window), and itself through K1.
    long_prompt = torch.randint(0, cfg.vocab_size, (BATCH, LONG_PROMPT),
                                generator=gen, device=dev, dtype=torch.int32)
    n_chunks = LONG_PROMPT // LONG_CHUNK
    long_len = LONG_PROMPT + NEW

    def windowed(m, window):
        """`m` with cfg.window set: the same parameters, another config."""
        w = copy.copy(m)
        w.cfg = dataclasses.replace(m.cfg, window=window)
        return w

    def chunked_run(m, qtype):
        caches = tfm.init_caches(m.cfg, BATCH, long_len, qtype=qtype,
                                 device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = tfm.prefill_chunked(m, long_prompt, caches,
                                         chunk=LONG_CHUNK)
        torch.cuda.synchronize()
        return lg, caches, time.perf_counter() - t0

    chunked_run(model, None)  # warm-up: allocator at the long shapes
    caches = tfm.init_caches(cfg, BATCH, long_len, device=dev)
    lg_long, _ = tfm.prefill(model, long_prompt, caches)  # whole prompt
    del caches
    lg_chunked = {}
    for label, qtype, window, prefix_form in (
            ("bf16 cache", None, 0, "bound"),
            ("int8 cache", "int8", 0, "bound"),
            ("fp8 cache", "fp8", 0, "kmajor"),
            ("int8 cache, window 1024", "int8", LONG_WINDOW, "kmajor")):
        m = windowed(model, window) if window else model
        zero_counts()
        lg, caches, prefill_s = chunked_run(m, qtype)
        counts = dict(fwd_forms)
        tok = torch.argmax(lg, dim=-1).to(long_prompt.dtype)
        t0 = time.perf_counter()
        for i in range(NEW):
            lg_dec, caches = tfm.decode_one(m, tok, LONG_PROMPT + i, caches)
            tok = torch.argmax(lg_dec, dim=-1).to(long_prompt.dtype)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        n_dec = decode_attention.launches
        n_prefix = (n_chunks - 1) * cfg.n_layers
        expect = dict(online=n_chunks * cfg.n_layers, bound=0, kmajor=0,
                      fallback=n_prefix)
        expect[prefix_form] = n_prefix
        print(f"[chunked] {label}: B={BATCH} x {LONG_PROMPT} tokens in "
              f"chunks of {LONG_CHUNK}: launches {counts} (expect {expect}),"
              f" decode {n_dec} (expect {cfg.n_layers * NEW}); prefill "
              f"{prefill_s * 1e3:.3f} ms ({BATCH * LONG_PROMPT / prefill_s:.0f}"
              f" prompt tok/s); decode {BATCH * NEW / decode_s:.1f} tok/s "
              f"({decode_s / NEW * 1e3:.3f} ms/step at context "
              f"{LONG_PROMPT}-{long_len}) ({card})", flush=True)
        _check(counts == expect, f"chunked {label}: launches {counts}, "
               f"expected {expect}")
        _check(n_dec == cfg.n_layers * NEW,
               f"chunked {label}: decode kernel launched {n_dec} times")
        _check(bool(torch.isfinite(lg).all() and torch.isfinite(lg_dec).all()),
               f"chunked {label}: non-finite logits")
        launches["K1"] += counts["online"]
        launches["K1b"] += counts["bound"]
        launches["K5"] += counts["kmajor"]
        launches["K6"] += n_dec
        lg_chunked[label] = lg
        del caches
        # the same prefill on the plain versions of the attention functions
        with mock.patch.object(tfm, "flash_attention_forward",
                               flash_attention_forward_plain):
            lg_plain, _, _ = chunked_run(m, qtype)
        e_plain = diff(lg, lg_plain)
        line = (f"[chunked] {label}: last-chunk logits: kernels vs plain "
                f"versions max|d|={e_plain:.3e} (gate {LOGIT_GATE})")
        _check(e_plain <= LOGIT_GATE,
               f"chunked {label}: plain-version logits {e_plain:.3e}")
        if not window:
            e_whole = diff(lg, lg_long)
            gate = {None: LOGIT_GATE, "int8": QUANT_LOGIT_GATE,
                    "fp8": FP8_LOGIT_GATE}[qtype]
            line += (f"; vs whole-prompt prefill over a bf16 cache max|d|="
                     f"{e_whole:.3e} (gate {gate})")
            _check(e_whole <= gate,
                   f"chunked {label}: whole-prompt logits {e_whole:.3e}")
        else:
            e_full = diff(lg, lg_chunked["int8 cache"])
            line += (f"; the window moves them by {e_full:.3e} from the "
                     f"full-causal int8 run")
            _check(e_full > 0, "the window changed nothing")
        print(line, flush=True)
        del lg_plain

    # where a chunked prefill's time goes (bf16 and fp8 caches)
    for label, qtype in (("bf16 cache", None), ("fp8 cache", "fp8")):
        prof = kernel_times(lambda: chunked_run(model, qtype))
        groups = {}
        for n, t in prof.ms.items():
            groups[_group_of(n)] = groups.get(_group_of(n), 0.0) + t
        print(f"[chunked] profile of one chunked prefill, {label}: "
              f"{sum(prof.count.values())} kernels, device busy "
              f"{prof.busy_ms:.3f} ms of a profiled wall of "
              f"{prof.wall_ms:.3f} ms ({prof.busy_ms / prof.wall_ms:.1%})",
              flush=True)
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"[chunked]   {g}: {t:.3f} ms "
                  f"({t / prof.busy_ms:.1%} of busy)")
    del lg_long, lg_chunked, long_prompt
    del model, out, logits, lg_whole, lg_chunk, lg_last

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
        o_2, _ = flash_attention_forward(q, k, v, causal=causal,
                                         softmax="online")
        (e_p, ref, ok_p), (e_2, _, ok_2) = o_close(o, o_p), o_close(o, o_2)
        ms = cuda_time_ms(lambda: fa1_attention(q, k, v, causal=causal))
        ms_p = cuda_time_ms(
            lambda: fa1_attention_plain(q, k, v, causal=causal), iters=3,
            warmup=1)
        ms_1 = cuda_time_ms(lambda: flash_attention_forward(
            q, k, v, causal=causal, softmax="online"))
        bound = _bound(_nbytes(q, k, v, o),
                       attention_flops(1, 16, TRAIN_T, TRAIN_T, 128,
                                       causal=causal))
        lib_ms = sdpa_ms(q, k, v, is_causal=causal)
        print(f"[K8] B=1 H=16 N={TRAIN_T} d=128 causal={causal} block_k=256"
              f": vs plain max|dO|={e_p:.3e}, vs K1 max|dO|={e_2:.3e} "
              f"(max|O| {ref:.3e}; gate {GATE}); kernel {ms:.4f} ms "
              f"({vs_bound(ms, bound)}) library call {lib_ms:.4f} ms plain "
              f"{ms_p:.4f} ms; K1 at the same shape {ms_1:.4f} ms ({card})",
              flush=True)
        _check(ok_p and ok_2 and bool(torch.isfinite(o).all()),
               f"K8 causal={causal}: dO {e_p:.3e} vs plain, {e_2:.3e} vs K1 "
               f"(max|O| {ref:.3e})")
        rec["K8"]["max_abs_err"] = max(rec["K8"]["max_abs_err"], e_p)
        if causal:
            rec["K8"].update(ms=ms, plain_ms=ms_p, library_ms=lib_ms,
                             **bound)
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
          f"({vs_bound(ms, b1)}) plain {ms_p:.4f} ms; library call "
          f"{sdpa_ms(q, k, v, is_causal=True):.4f} ms ({card})", flush=True)
    rec["K1"]["max_abs_err"] = max(rec["K1"]["max_abs_err"], e_o, e_l)
    _check(e_o <= GATE and e_l <= GATE,
           f"K1 training shape: {e_o:.3e}/{e_l:.3e} > {GATE}")
    # the windowed model's call: window 1024
    kw = dict(causal=True, window=1024)
    o, lse = flash_attention_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    o_p, lse_p = flash_attention_forward_plain(q, k, v, **kw)
    e_o, e_l = diff(o, o_p), diff(lse, lse_p)
    ms = cuda_time_ms(lambda: flash_attention_forward(q, k, v, **kw))
    band = visible_mask(TRAIN_T, TRAIN_T, kw)
    b1 = _bound(_nbytes(q, k, v, o, lse), 4.0 * 16 * 128 * int(band.sum()))
    print(f"[K1] training {TRAIN_T} window 1024 bf16 out: max|dO|={e_o:.3e} "
          f"max|dLSE|={e_l:.3e} kernel {ms:.4f} ms ({vs_bound(ms, b1)}); "
          f"library call (boolean band mask) "
          f"{sdpa_ms(q, k, v, attn_mask=band):.4f} ms ({card})", flush=True)
    rec["K1"]["max_abs_err"] = max(rec["K1"]["max_abs_err"], e_o, e_l)
    _check(e_o <= GATE and e_l <= GATE,
           f"K1 training shape, window 1024: {e_o:.3e}/{e_l:.3e} > {GATE}")
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
        dev_ms = _device_ms_by_kernel(lambda: (
            flash_attention_backward(*args, fused=True, **kw),
            flash_attention_backward(*args, fused=False, **kw)),
            ("K2", "K3", "K4"), iters=3)
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

    # the backward's masks: a sliding window at the training shape, a
    # window on a GQA prefix shape with kv_offset, and segment ids
    seg = torch.repeat_interleave(
        torch.arange(4, device=dev),
        torch.tensor([300, 1, 450, 249], device=dev))[None].expand(2, 1000)
    masked_cases = [
        ("training 4096 window 1024", 1, 16, 16, TRAIN_T, TRAIN_T,
         dict(causal=True, window=LONG_WINDOW)),
        ("GQA 300x1000 window 200 kv_offset 700", 2, 16, 4, 300, 1000,
         dict(causal=True, window=200, kv_offset=700)),
        ("GQA ragged 1000 segments causal", 2, 16, 4, 1000, 1000,
         dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)),
        ("GQA ragged 1000 segments", 2, 16, 4, 1000, 1000,
         dict(q_segment_ids=seg, kv_segment_ids=seg)),
    ]
    for name, b, h, hkv, nq, nk, kw in masked_cases:
        q, do = mk(b, h, nq, 128), mk(b, h, nq, 128)
        k, v = mk(b, hkv, nk, 128), mk(b, hkv, nk, 128)
        o, lse = flash_attention_forward(q, k, v, **kw)
        args = (q, k, v, o, lse, do)
        fused = flash_attention_backward(*args, fused=True, **kw)
        split = flash_attention_backward(*args, fused=False, **kw)
        torch.cuda.synchronize()
        plain = flash_attention_backward_plain(*args, **kw)
        for label, got, kerns in (("K4", fused, ("K4", "K4", "K4")),
                                  ("K2+K3", split, ("K3", "K2", "K2"))):
            line = []
            for gname, g, w, kern in zip(("dQ", "dK", "dV"), got, plain,
                                         kerns):
                e, ref = diff(g, w), w.float().abs().max().item()
                line.append(f"{gname} {e:.3e}/{ref:.3e}")
                rec[kern]["max_abs_err"] = max(rec[kern]["max_abs_err"], e)
                if not (ref > 0 and e <= BWD_GATE * ref
                        and bool(torch.isfinite(g).all())):
                    failures.append(f"{name} {label} {gname}: max|diff| "
                                    f"{e:.3e}, max|ref| {ref:.3e}")
            print(f"[bwd] {name}: {label} vs plain: max|diff|/max|ref| "
                  f"{', '.join(line)} (gate {BWD_GATE} x max|ref|)",
                  flush=True)
        ms_f = cuda_time_ms(
            lambda: flash_attention_backward(*args, fused=True, **kw),
            iters=10)
        ms_s = cuda_time_ms(
            lambda: flash_attention_backward(*args, fused=False, **kw),
            iters=10)
        ms_1 = cuda_time_ms(lambda: flash_attention_forward(q, k, v, **kw),
                            iters=10)
        print(f"[bwd] {name}: B={b} H={h} Hkv={hkv} Nq={nq} Nk={nk}: "
              f"wrapper fused {ms_f:.4f} ms, split {ms_s:.4f} ms; K1 "
              f"forward {ms_1:.4f} ms ({card})", flush=True)
        del q, k, v, o, lse, do, args, fused, split, plain
    del seg
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

    def loss_and_grads(m=None):
        m = model if m is None else m
        m.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(m, tokens)
        loss.backward()
        return loss.item(), [p.grad.float() for p in m.parameters()]

    names = [n for n, _ in model.named_parameters()]

    def rel_l2(ga, gb):
        errs = [((a - b).norm() / b.norm()).item() for a, b in zip(ga, gb)]
        i = max(range(len(errs)), key=errs.__getitem__)
        return errs[i], names[i]

    loss_k, grads_k = loss_and_grads()
    plain_bwd = (lambda q, k, v, o, lse, do, block_sizes=None, fused=None,
                 **kw:
                 flash_attention_backward_plain(q, k, v, o, lse, do, **kw))

    def plain_attention():
        """The training path on the plain attention functions."""
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(
            attention, "flash_attention_forward",
            flash_attention_forward_plain))
        stack.enter_context(mock.patch.object(
            attention, "flash_attention_backward", plain_bwd))
        return stack

    with plain_attention():
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

    # ---- 8b. main path of windowed training ------------------------------
    # The sliding-window model (cfg.window = 1024) on the same batch: K1
    # and K4 walk the band only.
    wmodel = tfm.Transformer(
        dataclasses.replace(tcfg, window=LONG_WINDOW),
        generator=torch.Generator(device=dev).manual_seed(0))
    wstep = tfm.make_train_step(
        wmodel, torch.optim.SGD(wmodel.parameters(), lr=1e-4))
    for _ in range(2):
        wstep(tokens)
    torch.cuda.synchronize()
    zero_counts()
    step_s, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss = wstep(tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = dict(fwd=fwd_forms["online"],
                  total=flash_attention_forward.launches, **bwd_launches)
    print(f"[wtrain] window {LONG_WINDOW}: launches over {TIMED_STEPS} "
          f"steps: K1 {counts['fwd']}, K4 {counts['fused']}, K2 "
          f"{counts['dkdv']}, K3 {counts['dq']} (expect {expect}, {expect}, "
          f"0, 0); step {statistics.median(step_s) * 1e3:.3f} ms (median "
          f"of {TIMED_STEPS}: {', '.join(f'{x * 1e3:.3f}' for x in step_s)})"
          f", {TRAIN_T / statistics.median(step_s):.1f} tokens/s; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} ({card})", flush=True)
    _check(counts == dict(fwd=expect, total=expect, fused=expect, dkdv=0,
                          dq=0), f"windowed train-step launch counts {counts}")
    launches["K1"] += counts["fwd"]
    launches["K4"] += counts["fused"]
    _check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    prof = kernel_times(lambda: wstep(tokens))
    dev_ms = {kn: launch_ms(prof, lambda n: _kernel_of(n) == kn)
              for kn in ("K1", "K4")}
    print(f"[wtrain] profile of one step: device busy {prof.busy_ms:.3f} ms "
          f"of a profiled wall of {prof.wall_ms:.3f} ms; per launch K1 "
          f"{dev_ms['K1']:.4f} ms, K4 {dev_ms['K4']:.4f} ms ({card})",
          flush=True)
    loss_k, grads_k = loss_and_grads(wmodel)
    with plain_attention():
        loss_p, grads_p = loss_and_grads(wmodel)
    e_grad, worst = rel_l2(grads_k, grads_p)
    print(f"[wtrain] kernels vs plain attention: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (|d| {abs(loss_k - loss_p):.3e}, gate "
          f"{LOSS_GATE}); worst gradient relative L2 {e_grad:.3e} "
          f"({worst}; gate {GRAD_GATE})", flush=True)
    _check(abs(loss_k - loss_p) <= LOSS_GATE,
           f"windowed kernel vs plain loss {loss_k} vs {loss_p}")
    _check(e_grad <= GRAD_GATE, f"windowed kernel vs plain gradient of "
           f"{worst}: relative L2 {e_grad:.3e}")
    del grads_k, grads_p, wmodel, wstep

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

    # ---- 9-14. the distributed layer --------------------------------------
    torch.cuda.empty_cache()
    ctx = types.SimpleNamespace(
        torch=torch, dev=dev, card=card, gen=gen, mk=mk, diff=diff,
        o_close=o_close, zero_counts=zero_counts, rec=rec,
        launches=launches, fwd_forms=fwd_forms, bwd_launches=bwd_launches,
        l2_flush=l2_flush)
    n_cards = torch.cuda.device_count()
    shared = f"{RING_RANKS} ranks share card 0"
    print(f"[mesh] {n_cards} card(s) visible: the ranks of every mesh share "
          f"card 0, each with its own compute and copy stream"
          + ("; ring attention and K9 then run again over distinct cards"
             if n_cards > 1 else ""), flush=True)
    mesh = _shared_card_mesh(ctx, RING_RANKS)
    _phase_ring_steps(ctx, RING_RANKS)
    torch.cuda.empty_cache()
    kept = _phase_ring_attention(ctx, mesh, shared)
    _phase_ulysses(ctx, mesh, kept)
    del kept
    torch.cuda.empty_cache()
    _phase_ring_decode(ctx, mesh)
    torch.cuda.empty_cache()
    _phase_sp_training(ctx, mesh)
    torch.cuda.empty_cache()
    _phase_gpipe(ctx)
    torch.cuda.empty_cache()
    _phase_device_ring_path(ctx)
    _phase_device_ring(ctx, [dev], "sharing card 0", record=True)
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        from cuda_flashattention_torch.parallel.mesh import make_mesh
        over = f"over {n_cards} distinct cards"
        _phase_ring_attention(
            ctx, make_mesh((RING_RANKS,), ("sp",),
                           [cards[i % n_cards] for i in range(RING_RANKS)]),
            over)
        _phase_device_ring(ctx, cards, over, record=False)

    # ---- last lines ------------------------------------------------------
    csrc = "cuda_flashattention_torch/csrc/"
    tpu = "cuda_flashattention_tpu/ops/"
    described = [
        ("K1", "flash_attention_forward (K1, online FA2 forward: causal, "
         "window, segments, int8/fp8/mixed K/V)", "flash_fwd.cu",
         "flash_fwd.py:123"),
        ("K1b", "flash_attention_forward softmax=bound (K1b, score-bound "
         "FA2 forward, Q-major, wgmma + TMA; quantize_q)",
         "flash_fwd_bound.cu", "flash_fwd.py:123"),
        ("K5", "flash_attention_forward softmax=bound, causal or fp8 keys "
         "(K5, score-bound FA2 forward, split over keys, wgmma + TMA)",
         "flash_fwd_kmajor.cu",
         "flash_fwd.py:399"),
        ("K6", "decode_attention (K6, one-token decode: bf16, int8, fp8 "
         "and mixed caches, windows, quantize_q)", "decode.cu",
         "decode.py:145"),
        ("K7", "paged_decode_attention (K7, one-token decode over paged "
         "pools)", "paged.cu", "paged.py:51"),
        ("K8", "fa1_attention (K8, FA1 forward)", "fa1.cu", "fa1.py:54"),
        ("K2", "flash_attention_backward fused=False (K2, dK/dV; wgmma + "
         "TMA)", "flash_bwd_kv.cu", "flash_bwd.py:117"),
        ("K3", "flash_attention_backward fused=False (K3, dQ)",
         "flash_bwd.cu", "flash_bwd.py:192"),
        ("K4", "flash_attention_backward (K4, fused dQ/dK/dV; wgmma + TMA, "
         "dQ by TMA reduce)", "flash_bwd_kv.cu", "flash_bwd.py:252"),
        ("K9", "device_ring_matmul (K9, device-initiated ring: the kernel "
         "pushes its shard to the next rank and orders the steps with "
         "device-side flags)", "device_ring.cu",
         "examples/07_device_ring.py:46"),
    ]
    kernels = []
    for kn, name, source, replaces in described:
        _check(launches[kn] > 0, f"{kn} was launched no time on its path")
        r = rec[kn]
        kernels.append(dict(
            name=name, route="cuda", source=csrc + source,
            replaces=replaces if "/" in replaces else tpu + replaces,
            launches=launches[kn],
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
