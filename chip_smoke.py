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
   also the kernel's own device time, from torch.profiler); each K1, K6,
   K7 and K8 row also its share of its bound and, where one call computes
   the same thing, the library call's time (under the row's boolean mask
   where it has one; for K7's bf16 pools, on the same keys held
   contiguously). K6 and K7 are timed on a cold L2 cache, as a server's
   decode step finds it; K6 is also timed under 1 to 16 query rows per KV
   head.
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
   bf16, 0.25 int8, 0.5 fp8). Over the bf16 cache the last decode step
   is profiled (device busy and K6's share at context 4224). A
   torch.profiler breakdown of one chunked prefill over a bf16 and an fp8
   cache follows.
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
   is K4's wgmma + TMA kernel without dQ, K3 the Q-major wgmma + TMA dQ
   kernel), each
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
   with two or more cards visible, phases 9, 12 and 14 run once more over
   distinct cards, and the output says which. First the kernels of one
   ring step against their plain versions at the step's own shapes (one
   [1, 16, L, 128] query shard over one K/V block, fp32 O, `softmax=
   "auto"`; K4 against the LSE of a two-block context): a full block with
   Hkv = 16 and 4, the block one hop behind under window 4096 (causal,
   kv_offset 4096), and the padded last block of the ragged case under
   its segment ids; and the steps of phase 12's rings: the diagonal
   (causal) block of the sp4 model ([1, 16, 4096, 128]: K1), and the
   diagonal and full blocks of the tp2 x sp2 model ([1, 8, 8192, 128]: K5
   and K1b). Then ring attention alone, 4 ranks, B=1, H=16, d=128,
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
12. Main path of the distributed layer: the 271M training config, placed
   once on a mesh (`shard_model`), takes `make_train_step(placed,
   SGD(1e-4))` steps on one seeded batch of B=1 x T=16384, every layer on
   the ranks: over 4 sequence ranks (`seq_axis="sp"`), then over 2 tensor
   x 2 sequence ranks (`head_axis="tp"`: 16 heads cut 8 + 8, d_ff 5632
   cut 2816 + 2816). 3 timed steps each (ms, tokens/s, peak memory per
   card) must launch the forward and K4 4 layers x tp x sp(sp+1)/2 times
   per step (40 and 24) and K2, K3 never, and call the collectives as the
   layers need them: per layer and step 4 all-gathers and 4
   reduce-scatters over the tensor axis, and no gradient all-reduce: the
   ranks on one card share one copy of each leaf, into which autograd
   sums their gradients (over distinct cards, one per step for sp4); a
   torch.profiler breakdown of one step by kernel group; one step's loss
   and every gradient against the same weights without a mesh at
   T=16384 (2e-2, 5e-2 relative L2). With two or more cards visible the
   sp4 step runs again with its ranks over distinct cards (cards[i % n]),
   else the output says it was skipped.
13. GPipe: `pipeline_forward` of the same config at B=4 x T=2048, 2 stages
   x 2 layers, 4 microbatches: logits against `forward` (0.125); then the
   model trained through it (a loss over its logits, GPipe's backward),
   once over the restacked layers and once over `stage_param_sharding`'s
   placed stages, each against `loss_fn` without a mesh (loss 2e-2, every
   gradient 5e-2 relative L2) with K1, K4 and the prologue 16 each.
14. K9, the device-initiated ring. Its path is the example stage
   `cuda_flashattention_torch.examples.device_ring` (both rings within
   1e-2 of the reference, `Test PASSED!`). Then K9 against
   `ring_matmul_plain` and against tile((sum x_i) @ W) in fp32 (gates 1e-2
   and 2e-2 · max |ref|, which must be > 0) at n in {1, 2, 4, 8} ranks, at
   the example's shape (L=1024, d=128) and at L=8192 (a 2 MiB shard), 20
   timed iterations each of the wrapper, the kernel alone (torch.profiler),
   the plain ring and one `torch.einsum` over the shards; the time per
   hop; which scope build ran (`.gpu` flags when every rank shares a card,
   `.sys` across cards); the latency floor: the round trip of one hop
   (kernel alone at L=64, one tile per rank: (n=8 − n=1) / 7) times
   n − 1, beside each shape's bound; 50 repeats at n=8 must equal the
   first call bit for bit. K9's bound prices, per card, the shards and W
   read once, o written once and the ring's n x n tile products; the
   pushes only where they cross to another card (over NVLink, 450 GB/s
   each way), since between ranks of one card they stay in L2.
15. fp32: the fp32 builds of K1 (online), K1b and K5 (each pinned), K4
   and K2 (alone, through `ops/flash_bwd._dkdv_cuda`: `fused=False`
   refuses fp32 until K3 has an fp32 build) against their plain fp32
   versions, on flat (uniform ±0.5) and peaked (Q x8, K x4) inputs: O and
   LSE within 1e-4, each gradient within 1e-4 · max(1, max |plain|), at
   the reference's 02_fwd shape [1, 1, 512, 64], the ladder's stage 03
   [1, 1, 5096, 64] and stage 04 ring steps [1, 1, 637, 64], [1, 16,
   4096, 128] causal, GQA 16:4, window 1024 and segment ids; each row
   prints the kernel's ms (torch.profiler), its bound (fp32: 4 bytes per
   element over 3.35 TB/s, products over the 495 TFLOP/s TF32 rate), the
   fp32 library call's ms (TF32 off) and the bf16 build's ms at the same
   shape. The backward rows hold K3's fp32 build with them (`fused=False`:
   K2 + K3's three gradients, K3's own ms and bound), also at the
   reference's backward case [1, 1, 128, 64] and at [1, 16, 6144, 128]
   causal. Then the fp32 path through K5: `flash_attention` on fp32 [1,
   16, 6144, 128] causal (past the online rule's 5120 rows), forward and
   backward against the plain versions: K5 1, its guarded fallback 1, K4
   1; and again through the split backward: K2 1, K3 1. Then an fp32 Q
   over int8, fp8 and mixed K/V at the fp32 serving model's prefix reads
   (B=8, H=16, Hkv=4, 512 rows over 3584 keys, and over the 1024-key
   slice under window 1024): K1 (online), K1b and K5 pinned, and
   `quantize_q` (over int8 keys; dropped over fp8), each against its
   plain fp32 version on flat and peaked inputs (1e-4; `quantize_q`
   5e-3), with the fp32 K/V build's ms on the dequantised K/V beside it
   and fp32 SDPA on the dequantised K/V as the library call; K8's fp32
   build at [1, 16, 4096, 128] causal and not and the reference rung's
   seeded 64 x 32 case (d 32 on padded heads), launches counted; K9's
   fp32 build at n=4 L=1024 (its path, launches counted) and n=8 L=8192
   on ranks sharing card 0 (and over distinct cards where two or more
   are visible), against the plain ring and the fp32 reference (1e-4 ·
   max(1, max |ref|)), 20 repeats bit for bit, one fp32 einsum as the
   library call.
16. fp32 and narrow heads in decode: K6 and K7 against their plain
   versions at the serving batch (B=8, H=16, Hkv=4, 4224 live tokens of
   a 4352-token cache, cold L2), flat and peaked inputs: K6 on an fp32 q
   at d=128 over fp32, int8, fp8 and mixed caches beside the bf16 row;
   K6 and K7 (16-token pages, bit for bit against K6 on the same keys)
   at d = 32 and 16 on bf16 and fp32, and fp32 over int8 at d = 16.
   Gates: fp32 1e-4 on O and LSE, bf16 5e-3 and 2e-2 · max |plain O|.
   Each row: kernel ms (torch.profiler), its bytes bound (fp32: 4 bytes
   an element), plain ms and the library call's (SDPA on the one-row
   query under the length mask, on the dequantised K/V; TF32 off).
17. Narrow heads in the forward and K4: K1 (online), K1b and K5 (pinned)
   and K4 at d = 16 and 32 on heads zero-padded to 64, at [1, 16, 4096,
   d] causal, fp32 and bf16, against the plain versions at d (fp32 1e-4,
   per gradient 1e-4 · max(1, max |plain|); bf16 5e-3 and 2e-2 · max
   |plain|); each row's ms beside the bound of the function at d, the
   d=64 build on unpadded inputs, plain and library ms.
18. Main path of fp32 serving: the 246M serving config with
   `dtype=torch.float32` runs `generate()` on B=8 prompts of 512 tokens
   for 32 new tokens, greedily, over an fp32 and an int8 cache: K1's
   fp32 build once per layer, K6's fp32 builds once per layer and token;
   against the same model on the plain attention functions, the fp32
   run's tokens equal and its prefill logits within 1e-3 · max(1, max
   |plain|); the int8 cache, replayed on the fp32 run's tokens, within
   0.25 of its last-step logits. Then fp32 chunked serving: the same
   model, B=8 prompts of 4096 tokens through `prefill_chunked(chunk=512)`
   and 32 greedy steps over int8, fp8 and mixed caches and, with
   `cfg.window` = 1024, an int8 cache: launches per form (K1 fp32 32; the
   prefix reads with an fp32 Q over the codes, K1b or under the window
   K5, 28, each behind its guarded K1 of the same build; K6 fp32 128),
   the last chunk's logits within 1e-3 · max(1, max |plain|) of the run
   on the plain attention functions, the greedy tokens equal to that
   run's (or departing only where its two best logits tie within that
   gate), and a profile of one chunked prefill over the int8 cache.
19. The ladder model trains: stage 05's config (fp32, d_head 16) takes 3
   `make_train_step` SGD steps on B=4 x T=64, K1 and K4 once per layer
   and step on heads padded to 64; one step's loss and gradients against
   the plain attention functions (1e-4 · max(1, max |plain|)).
20. The ladder (`cuda_flashattention_torch/examples`): stages 00-07
   through their `main` at the reference's shapes (SEQ 5096, d 64; 8
   ranks on card 0; stage 04 again over distinct cards when two or more
   are visible; stage 05's fp32 model at d_head 16, stage 06's fp32
   pools at d 32), each printing `Test PASSED!`; the fp32 launches of
   stage 03 (K1b 1 + its guarded fallback), stage 04 (the full ring's
   64 K1b steps, the causal ring's 8 K1 and 28 K1b steps twice, 36 K4),
   stage 05 (K1 20, K6 32) and stage 06 (K7 10, K6 10) against their
   schedules; the torch oracle on the card against the native C++ oracle
   (`runtime/native.py`) at [1, 2, 256, 64].
21. The tuning path (`_phase_tuning`): the tuners of
   `utils/autotune.py` over a temporary `CFA_AUTOTUNE_CACHE`, "fwd" and
   "bwd" at [1, 16, 4096, 128] causal, K6's split size at B=8 H=16 Hkv=4
   with 4224 live tokens of 4352, K7's page size at the same context;
   every candidate must run and match the plain version, and a second
   call must hit the cache (the timer then raises). The 128-key builds of
   K1 (training shape causal, not causal, window 1024; segment ids at
   N=1024, causal and not) and K1b (the chunked-prefill prefix) against
   the plain version and the 64-key builds; the backward's prologue (D
   and K4's zeroed dQ accumulator) against the plain D, and one CUDA
   backward under torch.profiler with no aten::sum / zeros / zero_. Then
   the 246M serving config's `prefill` and `prefill_chunked` (bf16
   cache) with the tuned tiles and, when the tuner kept 64 keys, at 128
   keys, and 16 `decode_one` steps at the tuned split size: logits within
   0.125 of the plain path, and the 128-key builds' launch counts.
22. An fp32 Q over bf16 K/V in the forward (`_phase_f32_bf16_forward`):
   K1 (online), K1b and K5 pinned at [1, 16, 4096, 128] causal, at the
   fp32 serving model's prefix reads (512 x 3584; 512 x 1024 under window
   1024) and at [1, 16, 6144, 128] causal, against the plain fp32
   version on flat and peaked inputs (1e-4); fp16 O from the same
   launches against the fp32-out O rounded to fp16 (K5 within one fp16
   ulp); each row's ms beside the fp32 K/V build's on the upcast K/V, the
   fp16-out ms, the bound, the plain ms, fp32 SDPA on the upcast K/V and
   the upcast's own ms. K6 and K7 on an fp32 q over a bf16 cache
   (`_phase_f32_bf16_decode`) at B=8 H=16 Hkv=4, 4224 live of 4352, d
   128, 64, 32 and 16 (1e-4; K7 bit for bit K6's), timed at d = 128 on a
   cold L2.
23. Main path of an fp32 model served over bf16 caches
   (`_phase_f32_bf16_serving`): the 246M serving config in fp32 with one
   `init_cache(..., dtype=torch.bfloat16)` per layer, B=8 prompts of
   4096 tokens through `prefill_chunked(chunk=512)`, 32 greedy
   `decode_one` steps, without and with `cfg.window` = 1024: launches
   (online 32, bound 28, fallback 28, K6 128; under the window online 60
   and K6 128), logits within 1e-3 · max(1, max |plain|) of the run on
   the plain attention functions and greedy tokens equal; the forward on
   an fp32 Q over bf16 K/V at [1, 16, 6144, 128] causal (K5 1, fallback
   1); the paged run over bf16 pools (4096 pages x 128 tokens, B=8 x
   4096 tokens, 32 fp32-q steps bit for bit K6's on a bf16 shadow, a
   sequence retired and its pages reused).
24. The port's utilities on the card (`_phase_utils`): the 271M training
   config takes 2 steps, is saved with `utils/checkpoint.py`, restored
   into a fresh model and optimizer, and both take one more step (split
   backward) with equal losses, gradients and parameters; one step under
   `utils/profiling.trace` + `annotate`, whose Chrome trace names K1 and
   K4; `kernel_report` of K1 at `device_peaks`' rates; a memory snapshot
   and `memory_stats`; `utils/monitor.poll_once`.
25. Wide heads (`_phase_wide_kernels`): the d = 256 builds of K1
   (online), K1b and K5 (pinned) at the Gemma-width model's attention
   shapes (8 query heads over 4 KV heads): the prefill (B=8, 512 causal),
   a ragged 500-row prefill, the chunked prefill's prefix (512 x 3584),
   its windowed slice (512 x 1024, window 1024) and a ragged GQA prefix
   (300 x 2999 causal), over bf16, int8, fp8 and mixed K/V, `quantize_q`
   on each quantized pair, and K1 under segment ids: bf16 gates, K5
   within 1e-4 of K1b, each form's ms at the prefill and the prefix. K6
   and K7 (128-token pages, bit for bit K6's) at d = 256 over every
   cache (bf16 q: bf16, int8, fp8, mixed, `quantize_q`; fp32 q: fp32,
   bf16, int8; fp32 gate 1e-4) at B=8, 4224 live of 4352. K6 at d in
   {8, 48, 80, 96, 100, 200, 256} over bf16 and int8 caches read in place
   (d = 100 one element at a time, the others in vector loads): the
   peak allocation of a call must stay below the cache's bytes. The
   forward at d = 96 and 200 at the prefix: the call (on zero-padded
   copies) against the next build's width, and the copies alone. Rows
   "K1 d256" ... "K7 d256": kernel ms (torch.profiler), bound, plain ms,
   SDPA on the same (dequantised) inputs.
26. Main path of serving at Gemma 2 2B's widths (`_phase_gemma_serving`;
   google/gemma-2-2b config.json: vocab 256000, d_model 2304, 26 layers,
   8 query heads over 4 KV heads, d_head 256, d_ff 9216; the repo's
   block, bf16, seeded weights, no cut of depth or width): `generate()`
   on B=8 prompts of 512 tokens for 128 greedy tokens over a bf16 and an
   int8 cache (K1 26, K6 26 x 128 per run), against the plain attention
   functions (prefill logits 0.125, greedy tokens, the int8 cache on the
   bf16 run's tokens 0.25); `prefill_chunked(chunk=512)` of B=8 x 4096
   tokens and 32 greedy steps over bf16, int8 and fp8 caches and, with
   `cfg.window` = 1024, an int8 cache (online 208; K1b or K5 182, each
   behind its guarded K1; K6 832), logits within 0.125 of the plain
   path and, without a window, within 0.125 / 0.25 / 0.5 of a
   whole-prompt prefill over bf16; the paged loop over bf16 and int8
   pools (4096 pages x 128 tokens, B=8 x 4096 tokens, 32 steps bit for
   bit K6's on a shadow, a sequence retired and its pages reused).
   Prefill ms, decode tok/s, chunked-prefill ms and paged step ms.
27. The backward at d = 256 (`_phase_wide_backward`) and training at Gemma
   2 2B's widths (`_phase_gemma_training`): the d = 256 builds of K4, K2 +
   K3 and the prologue against the plain backward (peaked inputs, gate
   2e-2 · max |plain| per gradient) at [1, 8, 4096, 256] over 4 KV heads
   causal and under window 1024, segment ids causal and not, a ragged 300
   x 400 with kv_offset -20 and d = 200 on padded heads; D within 1e-5 ·
   max(1, max |plain D|) and K4's accumulator zeroed; each case's kernel
   ms, bound, plain ms and SDPA's backward (rows "K4 d256", "K2 d256",
   "K3 d256", "prologue d256"). Then the Gemma-width model (GEMMA_KW, 26
   layers, no cut) on B=1 x T=4096: 5 timed SGD(1e-4) `make_train_step`
   steps (K1 = K4 = the prologue = 130, K2 = K3 = 0), step ms, tokens/s,
   TFLOP/s, peak GiB and a profile by kernel group; loss (2e-2) and every
   gradient (5e-2 relative L2) against the plain attention functions;
   one split-backward step (K2 = K3 = 26); the windowed model (window
   1024) the same way; 10 Adam steps that lower the loss.
28. fp32 at d = 256 in the forward (`_phase_wide_f32_kernels`) and an
   fp32 model served at Gemma 2 2B's widths (`_phase_gemma_f32_serving`):
   K1 (online), K1b and K5 (pinned) and "auto" on an fp32 Q at the
   Gemma-width attention shapes of phase 25 over fp32, bf16, int8, fp8 and
   mixed K/V, flat and peaked, O and LSE within 1e-4 of the plain fp32
   version, K5 within 1e-4 of K1b; fp16 O, `quantize_q`, d = 200 on padded heads,
   segment ids, a loose bound; each form's ms, fp32 bound and fp32 SDPA
   at the prefill, the prefix and the windowed slice (rows "K1 f32
   d256", "K1b f32 d256", "K5 f32 d256"); K8 at [1, 8, 4096, 256] in
   bf16 and fp32 (rows "K8 d256", "K8 f32 d256"). Then the fp32
   Gemma-width model (GEMMA_KW, fp32, 26 layers, no cut of width or
   depth): `generate()` B=8 x 512 + 32 greedy tokens over fp32 and int8
   caches, `prefill_chunked(chunk=512)` of B=8 x 4096 tokens and 32
   greedy steps over fp32, bf16, int8 and fp8 caches and, under window
   1024, an int8 cache: launch counts per form (K1 208, K1b or K5 182
   behind their guarded K1, K6 832), logits within 1e-3 · max(1, max
   |plain|) of the run on the plain attention functions and greedy
   tokens equal or departing at a tie, the int8 cache on the fp32
   cache's tokens within 0.25; ms, prompt tokens/s, decode tok/s, peak
   GiB and a profile by kernel group.
29. fp32 training at d = 256 and K9 at d <= 256
   (`_phase_wide_backward(ctx, f32=True)`, `_phase_wide_ring`,
   `_phase_f32_wide_ring_attention`, `_phase_gemma_f32_training`): the
   fp32 d = 256 builds of K4 and K2 + K3 against the plain fp32 backward
   at phase 27's cases, flat and peaked, each gradient within 1e-4 ·
   max(1, max |plain|), with kernel ms, fp32 bound, plain ms and SDPA's
   fp32 backward (rows "K4 f32 d256", "K2 f32 d256", "K3 f32 d256"); K9
   at d = 256 (the example stage at --width 256, fp32 at n=4 L=1024) and
   at n=4 L=1024, n=8 L=8192, d = 256 and n=4 d = 200, bf16 and fp32,
   against the plain ring and the fp32 reference (rows "K9 d256", "K9
   f32 d256"); one fp32 `ring_attention` at d = 256 over 4 ranks (N =
   16384, causal) against one call; the fp32 Gemma-width model (GEMMA_KW,
   fp32, 26 layers) on B=1 x T=4096: 5 timed SGD steps (K1 = K4 = the
   prologue = 130), step ms, tokens/s, TFLOP/s, peak GiB, a profile; loss
   (1e-4 relative) and every gradient (1e-3 relative L2) against the
   plain attention functions at full depth; one split-backward step (K2
   = K3 = 26); the windowed model (window 1024) the same way; 10 Adam
   steps at full depth that lower the loss (no cut of depth or width).
30. The mesh across processes (`_phase_multiprocess`, after the
   distributed layer's phases): the launcher
   (`python -m cuda_flashattention_torch.scripts.launch_multihost`) runs
   ladder stages 01, 04 and 07 at 2 processes x 2 ranks on card 0, whose
   processes share the card (the staged transport: device, pinned host
   buffer, gloo, device); then `utils/multiprocess_paths.py` at 2
   processes x 2 ranks: K9 over a ring of 4 ranks whose neighbours in the
   other process are reached through CUDA IPC handles (n=4, L in {1024,
   8192}, d in {128, 256}, bf16 and fp32: bf16 within min(1e-2, 2e-2 ·
   max |ref|) and fp32 within 1e-4 · max(1, max |ref|) of the fp32
   reference, bit for bit the one-process K9, 20 repeats bit-identical;
   times labelled as the card's time-slicing between the processes) and
   phase 13's step trained at pp=2 over one rank of each process
   against the same step in one process (loss 1e-3, every gradient 1e-2
   relative L2; K1, K4 and the prologue 32 over 2 steps); then over 4
   processes of one rank: K9 again, the step at pp=2·dp=2 (2
   microbatches a pipe), and the causal ring forward + backward at B=1
   H=16 N=16384 against the same ring in one process (O min(5e-3, 2e-2 ·
   max), each gradient 2e-2 · max; forward and K4 launches summed over
   the processes 10 each), ring decode B=8 over a 16384-token cache
   within 5e-3 of K6 on the whole cache (K6 4), and the sp4 and tp2·sp2
   train steps of the 271M config at B=1 x T=16384 (3 timed steps;
   launches as the one-process steps') against the same weights without
   a mesh (loss 2e-2, every gradient 5e-2 relative L2); per process its
   launches, ms, bytes moved between processes, host wait on them and
   peak GiB, beside the one-process ring's and step's ms. With two or
   more cards the ring, the sp step, K9 and the pipelined step again on
   NCCL, one process per card; with one card a line says they were
   skipped. Every launch runs under a timeout.
31. fp16 and mixed float types (`_phase_f16_kernels`,
   `_phase_mixed_kernels`, `_phase_f16_serving`, `_phase_mixed_serving`,
   `_phase_f16_training`, after the tuning phase): every fp16 build (the
   `csrc/*_f16.cu` units) against its plain version at the bf16 gates
   (K1, K1b, K5 at the training shape, the prefix over fp16 and int8 K/V
   and [1, 8, 4096, 256] causal, flat and peaked, K5 within 1e-4 of K1b,
   fp16 O the fp32 O rounded; K6 / K7 at 4224 live keys, d 128 and 256,
   fp16 and int8 caches, K7 bit for bit; K4, K2 + K3 and the prologue at
   the training shape and d = 256; K8; K9), each mixed form against its
   plain version at 1e-4 plus one ulp of P's and O's types (the rounding
   of P shown to act), rows "K1 f16" ... "K9 f16" and one "mixed" row per
   family; the fp16 246M model served (`generate()` over fp16 and int8
   caches, chunked over fp16, int8, fp8 and windowed int8 caches, the
   paged loop over fp16 pools), the bf16 model over fp32 caches and the
   fp16 model over bf16 caches served, each against the plain attention
   functions (logits within 0.125, tokens equal or departing at a tie),
   and the fp16 271M model trained (5 timed steps, a split step, ±
   window; loss within 2e-2, every gradient within 5e-2 relative L2 of
   the plain path under a 2^16 loss scale, the bf16 model's worst
   gradient beside fp16's).

Each path is driven with the launch counts set to 0 just before it and
read just after; a kernel's `launches` in the JSON line is its sum over
those runs (the three `generate()` runs, the four chunked-serving runs,
the paged lifecycle, the two FA1 calls, the timed training steps of both
models, the split-backward step, the ring-attention cases, Ulysses, the
ring-decode calls, the sequence- and tensor-parallel train steps, the
multi-process ring, ring decode and train steps (summed over their
processes), the pipelined forward, the device-ring stage, the tuned serving runs, the checkpointed
and traced train steps; for the fp32 forms the ladder's stages 03
to 06, the fp32 `flash_attention` path with its fused and split
backward, the fp32 `generate()` runs, the fp32 chunked-serving runs, the
fp32 FA1 calls and device-ring call, the ladder model's training
steps, and the fp32 model's serving runs over bf16 caches with its
paged run and the forward at [1, 16, 6144, 128]; for the d = 256 rows
the Gemma-width model's generate(), chunked and paged runs and its
timed, split-backward and windowed train steps, whose launches are also
added to K1, K1b, K5, K6, K7, K2, K3, K4 and the prologue; for the fp32
d = 256 rows the fp32 Gemma-width model's generate() and chunked runs,
whose decode launches are added to K6 d256; for K8 at d = 256 its four
`fa1_attention` calls). Launches made to
compare a kernel with its plain version or to
time it are not in it, nor are K1's guarded fallback launches behind a
checked bound call, which exit at once, but for K1's fp32-Q build over
codes: on its path (fp32 chunked serving) it runs only as that guarded
launch, so its line counts those; K1's fp32-Q-over-bf16 build counts its
windowed prefix reads and its guarded launches alike.

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
# NVLink 4 (the same sheet): 900 GB/s per card, counting both directions
NVLINK_BYTES_PER_S = 450e9


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
                           # (K5 on K1b's Q-major walk runs K1b's kernel)
                           (r"flash_fwd_kmajor", "K5"),
                           (r"flash_fwd_bound_", "K1b"),
                           (r"flash_fwd_kernel", "K1"),
                           (r"fa1_kernel", "K8"),
                           (r"::decode_kernel<", "K6"),
                           (r"::paged_kernel<", "K7"),
                           (r"device_ring_kernel", "K9"),
                           (r"bwd_delta_kernel", "K4 D prologue")):
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
# the same with tensor parallelism: 16 heads cut 8 + 8, d_ff 2816 + 2816
TP_SP, TP_SP_AXES = (2, 2), ("tp", "sp")
# GPipe: 2 stages x 2 layers, 4 microbatches
PP_B, PP_T, PP_MICRO = 4, 2048, 4
# K9: the example's shape and one whose shard is 2 MiB
K9_RANKS, K9_SHAPES, K9_ITERS, K9_REPEATS = (1, 2, 4, 8), (1024, 8192), 20, 50
K9_HOP_ROWS = 64  # one tile per rank: the ring's latency alone
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
    """A mesh whose ranks all share card 0: `n` ranks over `axis`, or an
    (n1, n2, ...) shape over a tuple of axes."""
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    shape, axes = (n, axis) if isinstance(n, tuple) else ((n,), (axis,))
    return make_mesh(shape, axes, [ctx.dev] * math.prod(shape))


def _phase_ring_steps(ctx, n_ranks):
    """K1 / K1b / K5 and K4 against their plain versions at the shapes one
    ring step gives them: a [1, H, L, d] query shard over one [1, Hkv, L, d]
    K/V block, fp32 O, `softmax="auto"`; the backward against the LSE of a
    context of two blocks, as a ring step gets the global LSE. The phases
    after this one hold the ring against `flash_attention`, which is these
    same kernels on the whole sequence. The steps of the model's rings are
    here too: the diagonal (causal) and full blocks of the sp4 model
    (H=16, L=4096: K1 and K1b) and of the tp2·sp2 model (H=8, L=8192: K5
    and K1b), whose phases compare with the model without a mesh, which
    runs the same kernels."""
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

    tp, sp = TP_SP
    tp_heads, tp_len = TRAIN_KW["n_heads"] // tp, SP_T // sp
    # (name, H, L, Hkv, the step's mask options, (q ids, k ids) of the
    # step and of the two-block context)
    cases = [
        ("full block", RING_H, full, RING_H, dict(causal=False), None),
        ("full block, GQA", RING_H, full, 4, dict(causal=False), None),
        (f"block one hop behind, window {RING_WINDOW}", RING_H, full,
         RING_H, dict(causal=True, window=RING_WINDOW, kv_offset=full),
         None),
        (f"last block with {tail} pad keys, segment ids", RING_H, ragged,
         RING_H, dict(causal=False), (0, tail)),
        (f"last block and {tail} pad queries, segment ids", RING_H, ragged,
         RING_H, dict(causal=False), (tail, tail)),
        ("sp4 model, diagonal block", TRAIN_KW["n_heads"], SP_T // n_ranks,
         TRAIN_KW["n_kv_heads"], dict(causal=True), None),
        ("tp2·sp2 model, diagonal block", tp_heads, tp_len,
         TRAIN_KW["n_kv_heads"] // tp, dict(causal=True), None),
        ("tp2·sp2 model, full block", tp_heads, tp_len,
         TRAIN_KW["n_kv_heads"] // tp, dict(causal=False), None),
    ]
    for name, h, length, hkv, opts, pads in cases:
        q, do = (ctx.mk(1, h, length, 128) for _ in range(2))
        # a context of two blocks, the queries' own the second. A causal
        # step attends the block kv_offset behind the queries' (its own at
        # 0); else the step's block is the second, which ends in the pad
        k2, v2 = (ctx.mk(1, hkv, 2 * length, 128) for _ in range(2))
        lo = length - opts.get("kv_offset", 0) if opts["causal"] else length
        k, v = (x[:, :, lo:lo + length].contiguous() for x in (k2, v2))
        kw, kw2 = dict(opts), dict(opts)
        if opts["causal"]:
            kw2["kv_offset"] = length
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
        print(f"[ring-step] {name}: B=1 H={h} Hkv={hkv} {length} x "
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


def _phase_model_parallel(ctx, mesh, tag, **axes):
    """The main path of the distributed layer: the 271M training config,
    placed once on the mesh (`shard_model`), takes train steps on one
    batch of B=1 x T=16384 with every layer on the ranks (`axes`: the
    sequence axis, and the tensor axis where there is one)."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.parallel import collectives

    sp = mesh.shape[axes["seq_axis"]]
    tp = mesh.shape[axes["head_axis"]] if axes.get("head_axis") else 1
    cards = mesh.distinct_devices()
    tcfg = tfm.TransformerConfig(dtype=torch.bfloat16,
                                 **{**TRAIN_KW, "max_seq": SP_T})
    gen = torch.Generator(device=ctx.dev).manual_seed(0)
    model = tfm.Transformer(tcfg, generator=gen)
    tokens = torch.randint(0, tcfg.vocab_size, (1, SP_T), generator=gen,
                           device=ctx.dev, dtype=torch.int32)
    placed = tfm.shard_model(model, mesh, **axes)
    del model
    step = tfm.make_train_step(
        placed, torch.optim.SGD(placed.parameters(), lr=1e-4))
    step(tokens)  # warm-up
    torch.cuda.synchronize()
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    ctx.zero_counts()
    for kind in collectives.calls:
        collectives.calls[kind] = 0
    step_s, losses = [], []
    for _ in range(SP_STEPS):
        t0 = time.perf_counter()
        loss = step(tokens)
        for card in cards:
            torch.cuda.synchronize(card)
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    forms = dict(ctx.fwd_forms)
    n_fwd = _forward_launches(ctx)
    counts = dict(fwd=n_fwd, **ctx.bwd_launches)
    ctx.launches["K4"] += counts["fused"]
    calls = dict(collectives.calls)
    expect = SP_STEPS * tcfg.n_layers * tp * sp * (sp + 1) // 2
    # per layer and step: 2 all-gathers and 2 reduce-scatters forward, as
    # many backward; per step one gradient all-reduce per group of leaves
    # with the same replica axes (the tp-cut matrices, and the rest), and
    # none on one card, whose ranks share one copy of every leaf
    n_tp = SP_STEPS * tcfg.n_layers * 4 if tp > 1 else 0
    n_sync = (2 if tp > 1 else 1) if len(cards) > 1 else 0
    expect_calls = dict(all_reduce=SP_STEPS * n_sync, all_gather=n_tp,
                        reduce_scatter=n_tp)
    peaks = ", ".join(
        f"{card}: {torch.cuda.max_memory_allocated(card) / 2**30:.2f} GiB"
        for card in cards)
    step_ms = statistics.median(step_s) * 1e3
    ctx.step_ms[tag] = [x * 1e3 for x in step_s]
    print(f"[{tag}] 271M config, B=1 T={SP_T}, mesh {mesh.shape} "
          f"{axes}, SGD(1e-4), every layer on the ranks: launches over "
          f"{SP_STEPS} steps: forward {n_fwd} (online {forms['online']}, "
          f"bound {forms['bound']}, K-major {forms['kmajor']}; guarded "
          f"fallback {forms['fallback']}), K4 {counts['fused']}, K2 "
          f"{counts['dkdv']}, K3 {counts['dq']} (expect {expect}, {expect}, "
          f"0, 0); collectives {calls} (expect {expect_calls}); step "
          f"{step_ms:.3f} ms (median of {SP_STEPS}: "
          f"{', '.join(f'{x * 1e3:.3f}' for x in step_s)}), "
          f"{SP_T / step_ms * 1e3:.1f} tokens/s, peak memory {peaks}; "
          f"losses {', '.join(f'{x:.4f}' for x in losses)} ({ctx.card})",
          flush=True)
    _check(counts == dict(fwd=expect, fused=expect, dkdv=0, dq=0,
                          delta=expect),
           f"{tag} train-step launch counts {counts}")
    _check(calls == expect_calls, f"{tag} collective calls {calls}")
    _check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # where one step's device time goes, by kernel group (the ranks' streams
    # overlap on the card: shares are of the summed kernel time)
    from cuda_flashattention_torch.utils.profiling import kernel_times
    prof = kernel_times(lambda: step(tokens))
    groups = {}
    for n, t in prof.ms.items():
        groups[_group_of(n)] = groups.get(_group_of(n), 0.0) + t
    total = sum(groups.values()) or float("nan")
    print(f"[{tag}] one step profiled: busy {prof.busy_ms:.3f} ms of "
          f"{prof.wall_ms:.3f} ms wall; " + ", ".join(
              f"{g} {t:.3f} ms ({100 * t / total:.1f}%)" for g, t in
              sorted(groups.items(), key=lambda x: -x[1]))
          + f" ({ctx.card})", flush=True)

    # one step's loss and gradients against the same weights without a mesh
    placed.zero_grad(set_to_none=True)
    loss_mesh = tfm.loss_fn(placed, tokens)
    loss_mesh.backward()
    placed.sync_grads()
    whole = tfm.gather_model(placed, ctx.dev)
    del placed, step
    grads_mesh = {n: p.grad.float() for n, p in whole.named_parameters()}
    whole.zero_grad(set_to_none=True)
    loss_1 = tfm.loss_fn(whole, tokens)
    loss_1.backward()
    loss_mesh, loss_1 = loss_mesh.item(), loss_1.item()
    errs = {n: ((grads_mesh[n] - p.grad.float()).norm()
                / p.grad.float().norm()).item()
            for n, p in whole.named_parameters()}
    worst = max(errs, key=errs.get)
    print(f"[{tag}] on the ranks vs the same weights without a mesh at "
          f"T={SP_T}: loss {loss_mesh:.6f} vs {loss_1:.6f} (|d| "
          f"{abs(loss_mesh - loss_1):.3e}, gate {LOSS_GATE}); worst gradient "
          f"relative L2 {errs[worst]:.3e} ({worst}; gate {GRAD_GATE}) "
          f"({ctx.card})", flush=True)
    _check(abs(loss_mesh - loss_1) <= LOSS_GATE,
           f"{tag} loss {loss_mesh} vs {loss_1}")
    _check(errs[worst] <= GRAD_GATE, f"{tag} gradient of {worst}: "
           f"relative L2 {errs[worst]:.3e}")


def _phase_gpipe(ctx):
    """`pipeline_forward` of the training config against `forward`; then
    pipelined training in one process: a loss over its logits and the
    backward through GPipe's schedule, once over the restacked layers and
    once over `stage_param_sharding`'s placed stages, each against
    `loss_fn` over the same weights without a mesh (loss LOSS_GATE, every
    gradient GRAD_GATE relative L2), with K1, K4 and the D prologue
    launched once per layer and microbatch."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.utils.multiprocess_paths import pipe_loss

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
    del want, got
    print(f"[gpipe] 271M config, B={PP_B} T={PP_T}, 2 stages x 2 layers, "
          f"n_micro={PP_MICRO}: forward launches {n_fwd} (expect "
          f"{tcfg.n_layers * PP_MICRO}); logits vs forward: max|diff|="
          f"{e:.3e} (gate {LOGIT_GATE})", flush=True)
    _check(e <= LOGIT_GATE, f"pipeline_forward logits off by {e:.3e}")
    _check(n_fwd == tcfg.n_layers * PP_MICRO,
           f"pipeline_forward launched the forward {n_fwd} times")

    loss_1 = tfm.loss_fn(model, tokens)
    loss_1.backward()
    loss_1 = loss_1.item()
    ref = {n: w.grad.float() for n, w in model.named_parameters()}
    expect = tcfg.n_layers * PP_MICRO
    for placed in (False, True):
        form = "placed stages" if placed else "restacked"
        model.zero_grad(set_to_none=True)
        pipe_loss(model, tokens, mesh, PP_MICRO, placed=placed).backward()
        torch.cuda.synchronize()
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats(ctx.dev)
        ctx.zero_counts()
        t0 = time.perf_counter()
        loss = pipe_loss(model, tokens, mesh, PP_MICRO, placed=placed)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_fwd = _forward_launches(ctx)
        counts = dict(ctx.bwd_launches)
        ctx.launches["K4"] += counts["fused"]
        ctx.launches["K4 D prologue"] += counts["delta"]
        errs = {n: ((w.grad.float() - ref[n]).norm() / ref[n].norm()).item()
                for n, w in model.named_parameters()}
        worst = max(errs, key=errs.get)
        loss = loss.item()
        print(f"[gpipe-train] 271M config, B={PP_B} T={PP_T}, 2 stages x 2 "
              f"layers, n_micro={PP_MICRO}, {form}: launches forward "
              f"{n_fwd} (online {ctx.fwd_forms['online']}), K4 "
              f"{counts['fused']}, prologue {counts['delta']}, K2 "
              f"{counts['dkdv']}, K3 {counts['dq']} (expect {expect}, "
              f"{expect}, {expect}, 0, 0); loss {loss:.6f} vs loss_fn "
              f"without a mesh {loss_1:.6f} (|d| {abs(loss - loss_1):.3e}, "
              f"gate {LOSS_GATE}); worst gradient relative L2 "
              f"{errs[worst]:.3e} ({worst}; gate {GRAD_GATE}) over "
              f"{len(errs)} parameters; forward + backward {ms:.1f} ms, "
              f"peak {torch.cuda.max_memory_allocated(ctx.dev) / 2**30:.2f} "
              f"GiB ({ctx.card})", flush=True)
        _check(ctx.fwd_forms["online"] == expect and counts == dict(
            fused=expect, delta=expect, dkdv=0, dq=0),
            f"pipelined training ({form}) launches {n_fwd} {counts}")
        _check(math.isfinite(loss) and abs(loss - loss_1) <= LOSS_GATE
               and errs[worst] <= GRAD_GATE,
               f"pipelined training ({form}): loss {loss} vs {loss_1}, "
               f"{worst} relative L2 {errs[worst]:.3e}")
        ctx.step_ms[f"pp-train-{'placed' if placed else 'restacked'}"] = [ms]


MP_TIMEOUT = 240  # seconds for one launch's processes


def _mp_run(ctx, nproc, per, command, env=None):
    """`python -m cuda_flashattention_torch.scripts.launch_multihost -np
    nproc --devices-per-proc per -m command...` from the checkout, under
    the launcher's timeout (which stops its processes) and a later one of
    its own (which stops the launcher's whole process group); its stdout
    and seconds. A nonzero exit fails the run."""
    import os
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m",
           "cuda_flashattention_torch.scripts.launch_multihost", "-np",
           str(nproc), "--devices-per-proc", str(per), "--timeout",
           str(MP_TIMEOUT), "-m", *command]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=root, env=dict(
        os.environ, PYTHONPATH=root, **(env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=MP_TIMEOUT + 60)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
    _check(p.returncode == 0, f"launch of {command[0]} ({nproc} x {per}) "
           f"exited {p.returncode}:\n{out[-3000:]}\n{err[-30000:]}")
    return out, time.perf_counter() - t0


def _mp_paths(ctx, nproc, per, paths, options, env=None):
    """utils/multiprocess_paths.py --check over `paths` in `nproc`
    processes of `per` ranks: every process's report and the seconds of
    the launch."""
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        _, secs = _mp_run(ctx, nproc, per, [
            "cuda_flashattention_torch.utils.multiprocess_paths", "--out",
            out, "--check", *options, *paths], env)
        return [json.loads(open(f"{out}/p{p}.json").read())
                for p in range(nproc)], secs


def _mp_per_process(reports, path):
    """One line of each process's numbers on `path`."""
    rows = []
    for r in reports:
        i = r["paths"][path]
        lx = i["launches"]
        f = lx["forms"]
        rows.append(
            f"p{r['process']}: fwd {f['online'] + f['bound'] + f['kmajor']} "
            f"(online {f['online']}, bound {f['bound']}, K-major "
            f"{f['kmajor']}), K4 {lx['bwd']['fused']}, K6 {lx['decode']}; "
            + (f"{i['ms']:.1f} ms; " if "ms" in i else
               f"steps {', '.join(f'{x:.1f}' for x in i['step_ms'])} ms; ")
            + f"moved {i['moved_bytes'] / 2**20:.1f} MiB, waited "
              f"{i['wait_s'] * 1e3:.1f} ms; peak {i['peak_gib']:.2f} GiB")
    return "; ".join(rows)


def _mp_launches(ctx, reports, path):
    """The launches of `path` summed over the processes (added to the
    run's per-kernel sums): (forward, K4, K6)."""
    fwd = k4 = k6 = 0
    for r in reports:
        lx = r["paths"][path]["launches"]
        for form, kn in (("online", "K1"), ("bound", "K1b"),
                         ("kmajor", "K5")):
            ctx.launches[kn] += lx["forms"][form]
            fwd += lx["forms"][form]
        ctx.launches["K4"] += lx["bwd"]["fused"]
        ctx.launches["K6"] += lx["decode"]
        k4, k6 = k4 + lx["bwd"]["fused"], k6 + lx["decode"]
    return fwd, k4, k6


MP_STEPS = 2  # timed train steps across processes (staged: ~4 s each)
# pipelined training across processes: the one-process gates of phase 13
# tighten to these against the one-process pipelined step
MP_PIPE_LOSS_GATE, MP_PIPE_GRAD_GATE = 1e-3, 1e-2
# K9 across processes: n = 4 ranks, L x d x type, 20 repeats on one
# workspace; the fp32 gate is 1e-4 · max(1, max |ref|)
MP_K9_ROWS, MP_K9_D, MP_K9_REPEATS = (1024, 8192), (128, 256), 20
F32_RING_GATE = 1e-4


def _phase_multiprocess(ctx):
    """The mesh across processes, through the launcher on this machine's
    card (processes sharing card 0: the staged transport). Ladder stages
    01, 04 and 07 at 2 processes x 2 ranks. Then at 2 processes x 2
    ranks: K9 over a ring of 4 ranks in 2 processes, and the phase-13
    pipelined training step at pp=2 over one rank of each process; over 4
    processes of one rank: the causal ring forward + backward at N = 16384
    and ring decode (B = 8 over a 16384-token cache) against the same
    calls in one process (the ring's gates; decode 5e-3 against K6 on the
    whole cache), the sp4 and tp2·sp2 train steps of the 271M config at
    B=1 x T=16384 against the same weights without a mesh (loss 2e-2,
    every gradient 5e-2 relative L2), K9 over 4 processes of one rank,
    and the pipelined step at pp=2·dp=2. The pipelined steps against the
    same step in one process (loss 1e-3, every gradient 1e-2 relative
    L2); K9 at n = 4, L in {1024, 8192}, d in {128, 256}, bf16 and fp32,
    against the fp32 reference (bf16 min(1e-2, 2e-2 · max |ref|), fp32
    1e-4 · max(1, max |ref|)), bit for bit the one-process K9 on the same
    shards, 20 repeated calls bit-identical; its times are the card
    switching between the processes' contexts (time-sliced), not the
    kernel's. Per process its launches, ms, bytes moved, host wait and
    peak GiB. Three launches; the NCCL run, which needs two or more
    cards, is `_phase_multiprocess_nccl`."""
    import torch.distributed as dist
    t_phase = time.perf_counter()
    nccl = dist.is_nccl_available()
    print(f"[mp] torch.distributed: gloo {dist.is_gloo_available()}, NCCL "
          f"{nccl}" + (f" {'.'.join(map(str, ctx.torch.cuda.nccl.version()))}"
                       if nccl else ""), flush=True)
    out, secs = _mp_run(ctx, 2, 2, ["cuda_flashattention_torch.examples",
                                    "ppermute_verify", "ring_attention",
                                    "device_ring"])
    lines = [x for x in out.splitlines() if "over 2 processes" in x]
    print(f"[mp-ladder] stages 01, 04 and 07 at 2 processes x 2 ranks: "
          + " | ".join(lines) + f" ({secs:.1f} s)", flush=True)
    _check(out.count("Test PASSED!") == 3 and "transport staged" in out
           and len(lines) == 3, f"multi-process ladder stages: "
           f"{out[-1500:]}")
    reports, secs = _mp_paths(ctx, 2, 2, ["k9", "pipe_train"], _MP_K9 + [
        *_MP_PIPE, "--pipe-axes", "pp=2", "--micro", str(PP_MICRO)])
    _mp_report_k9(ctx, reports, "staged", "2 processes x 2 ranks sharing "
                  "card 0, time-sliced")
    _mp_report_pipe(ctx, reports, "pipe_train", "staged",
                    "pp-train-restacked")
    print(f"[mp] 2-process launch {secs:.1f} s", flush=True)
    reports, secs = _mp_paths(ctx, 4, 1, MP_FOUR_PATHS, MP_FOUR_OPTIONS)
    _mp_report_ring(ctx, reports, "staged", "processes sharing card 0")
    for axes, tag in (("sp=4", "sp-train"), ("tp=2,sp=2", "tp-sp-train")):
        _mp_report_train(ctx, reports, f"train[{axes}]", "staged", tag)
    _mp_report_k9(ctx, reports, "staged", "4 processes x 1 rank sharing "
                  "card 0, time-sliced", record=True)
    _mp_report_pipe(ctx, reports, "pipe_train", "staged", None)
    print(f"[mp] 4-process launch {secs:.1f} s (joining the group "
          + ", ".join(f"{r['join_s']:.1f}" for r in reports)
          + f" s); phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def _phase_multiprocess_nccl(ctx):
    """With two or more cards: the causal ring, the sp step, K9 and the
    pipelined step (pp=2 over 2 cards, pp=2·dp=2 over 4) again over NCCL,
    one process per card, as `_phase_multiprocess` holds them; with one
    card, a line says that they were skipped."""
    cards = ctx.torch.cuda.device_count()
    if cards < 2:
        print("[mp-nccl] one card visible: the NCCL ring, sp step, K9 and "
              "pipelined step (one process per card) are skipped",
              flush=True)
        return
    n = 4 if cards >= 4 else 2
    pipe = (["--pipe-axes", "pp=2", "--micro", str(PP_MICRO)] if n == 2
            else ["--pipe-axes", "pp=2,dp=2", "--micro", "2"])
    reports, secs = _mp_paths(
        ctx, n, 1, ["ring_causal", "train", "k9", "pipe_train"],
        _MP_RING + _MP_TRAIN + _MP_K9 + _MP_PIPE + pipe
        + ["--axes", f"sp={n}"])
    _mp_report_ring(ctx, reports, "nccl", f"one process per card, {n} "
                    f"cards")
    _mp_report_train(ctx, reports, "train", "nccl", "sp-train-cards")
    _mp_report_k9(ctx, reports, "nccl", f"one process per card, {n} cards")
    _mp_report_pipe(ctx, reports, "pipe_train", "nccl", None)
    print(f"[mp-nccl] {n}-process launch {secs:.1f} s", flush=True)


_MP_RING = ["--dtype", "bf16", "--batch", "1", "--heads", str(RING_H),
            "--kv-heads", str(RING_H), "--d", "128", "--seq", str(RING_N),
            "--decode-batch", str(DECODE_B)]
_MP_TRAIN = ["--model", "271m", "--train-seq", str(SP_T), "--steps",
             str(MP_STEPS)]
_MP_PIPE = ["--model", "271m", "--pipe-batch", str(PP_B), "--pipe-seq",
            str(PP_T), "--steps", str(MP_STEPS)]
_MP_K9 = ["--k9-rows", *map(str, MP_K9_ROWS), "--k9-d", *map(str, MP_K9_D),
          "--k9-dtypes", "bf16", "fp32", "--k9-repeats", str(MP_K9_REPEATS),
          "--k9-iters", "5"]
# the 4-process launch of phase 30 (`utils/mp_launches.py` repeats it)
MP_FOUR_PATHS = ["ring_causal", "decode", "train", "k9", "pipe_train"]
MP_FOUR_OPTIONS = _MP_RING + _MP_TRAIN + _MP_K9 + [
    *_MP_PIPE, "--pipe-axes", "pp=2,dp=2", "--micro", "2", "--axes", "sp=4",
    "--axes", "tp=2,sp=2"]


def _mp_report_k9(ctx, reports, transport, where, record=False):
    """K9 across processes: per case its gates, bit-equality with the
    one-process K9, the repeats, and its times beside the bound and one
    einsum over the shards (timed here, in one process); `record`: the
    "K9 across processes" row takes the example's case (L=1024, d=128,
    bf16)."""
    torch = ctx.torch
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    _check(all(r["transport"] == transport for r in reports),
           f"transports {[r['transport'] for r in reports]}")
    p0 = reports[0]["paths"]["k9"]
    n = reports[0]["ranks"]
    launches = sum(r["paths"]["k9"]["launches"]["k9"] for r in reports)
    cases = len(MP_K9_ROWS) * len(MP_K9_D) * 2
    e = p0["errors"]
    for key, t in p0["k9"].items():
        rows, d, dt = key.split(",")
        rows, d = int(rows), int(d)
        f32 = dt == "fp32"
        got_ref = e[f"o[{key}]@ref"]
        top = got_ref[1]
        gate = (F32_RING_GATE * max(1.0, top) if f32
                else min(K9_GATE, REL_GATE * top))
        one = e[f"o[{key}]"][0]
        # the library call: one einsum over the shards, in this process
        x = ctx.mk(n * rows, d).to(torch.float32 if f32 else torch.bfloat16)
        w = ctx.mk(d, d).to(x.dtype)
        x3 = x.view(n, rows, d)
        lib_ms = cuda_time_ms(lambda: torch.einsum("nld,de->le", x3, w),
                              iters=K9_ITERS)
        # one card each under NCCL (pushes over NVLink), else card 0
        bound = _k9_bound(list(range(n)) if transport == "nccl"
                          else [ctx.dev] * n, rows, d, f32=f32)
        kms = [r["paths"]["k9"]["k9"][key].get("kernel_ms", float("nan"))
               for r in reports]
        wms = [r["paths"]["k9"]["k9"][key]["ms"] for r in reports]
        starts = [r["paths"]["k9"]["k9"][key]["start_ms"] for r in reports]
        same = [r["paths"]["k9"]["k9"][key]["same"] for r in reports]
        print(f"[mp-K9] n={n} over {len(reports)} processes ({where}; "
              f"transport {transport}), L={rows} d={d} {dt}: "
              f"{t['scope']} scope, grid {t['grid'][0]} spans x "
              f"{t['grid'][1]} ranks per launch; vs (sum x_i) @ W in fp32 "
              f"{got_ref[0]:.3e} (max|ref| {top:.3e}, gate {gate:.3e}); vs "
              f"the one-process K9 {one:.3e} (bit for bit: 0); repeats "
              f"equal to the first {same} of {MP_K9_REPEATS} per process; "
              f"kernel {', '.join(f'{x:.4f}' for x in kms)} ms per process "
              f"(CUDA events around the launch: a process's time holds its "
              f"wait for neighbours that launch later), wrapper "
              f"{', '.join(f'{x:.3f}' for x in wms)} ms (with the rows' "
              f"share), plain ring across processes "
              f"{t['plain_ms']:.3f} ms, the host's wait before the launch "
              f"(stream + barrier) {', '.join(f'{x:.3f}' for x in starts)} "
              f"ms; one einsum over the shards in one process "
              f"{lib_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) ({ctx.card})", flush=True)
        _check(got_ref[0] <= gate and one == 0.0
               and all(x == MP_K9_REPEATS for x in same),
               f"K9 across processes L={rows} d={d} {dt}: {got_ref[0]:.3e} "
               f"vs the reference, {one:.3e} vs one process, repeats {same}")
        if record and (rows, d, dt) == (K9_SHAPES[0], 128, "bf16"):
            ctx.rec["K9 across processes"].update(
                max_abs_err=one, ms=statistics.median(kms),
                plain_ms=t["plain_ms"], library_ms=lib_ms, **bound)
    _check(launches == cases * len(reports),
           f"K9 across processes launched {launches} times")
    if record:
        ctx.launches["K9 across processes"] += launches
        ctx.launches["K9"] += launches


def _mp_report_pipe(ctx, reports, path, transport, tag):
    """The pipelined step across processes against the same step in one
    process (`--check`), with its launches and per-process numbers."""
    nproc = len(reports)
    fwd, k4, _ = _mp_launches(ctx, reports, path)
    i0 = reports[0]["paths"][path]
    e = i0["errors"]
    worst = max((k for k in e if k != "loss"), key=lambda k: e[k][2])
    n_micro = PP_MICRO if nproc == 2 else 2
    nb = 1 if nproc == 2 else 2
    expect = MP_STEPS * TRAIN_KW["n_layers"] * n_micro * nb
    delta = sum(r["paths"][path]["launches"]["bwd"]["delta"]
                for r in reports)
    ctx.launches["K4 D prologue"] += delta
    step = statistics.median(i0["step_ms"])
    one = ctx.step_ms.get(tag) if tag else None
    print(f"[mp-pipe] 271M config, B={PP_B} T={PP_T}, pipelined "
          f"({i0.get('mesh', path)}) over {nproc} processes ({transport}): "
          f"launches summed fwd {fwd}, K4 {k4}, prologue {delta} (expect "
          f"{expect} each over {MP_STEPS} steps); vs the same step in one "
          f"process: loss |d| {e['loss'][0]:.3e} (gate {MP_PIPE_LOSS_GATE}), "
          f"worst gradient relative L2 {e[worst][2]:.3e} ({worst}; gate "
          f"{MP_PIPE_GRAD_GATE}); step {step:.1f} ms on p0 "
          + (f"against {one[0]:.1f} ms for phase 13's one-process forward + "
             f"backward " if one else "")
          + f"(losses {i0['losses']}); {_mp_per_process(reports, path)} "
          f"({ctx.card})", flush=True)
    _check(fwd == expect and k4 == expect and delta == expect,
           f"mp {path} launches {fwd} {k4} {delta}")
    _check(e["loss"][0] <= MP_PIPE_LOSS_GATE
           and e[worst][2] <= MP_PIPE_GRAD_GATE,
           f"mp {path}: loss {e['loss']}, {worst} {e[worst]}")


def _mp_report_ring(ctx, reports, transport, where):
    """The ring's (and, where it ran, ring decode's) lines and gates."""
    nproc = len(reports)
    _check(all(r["transport"] == transport for r in reports),
           f"transports {[r['transport'] for r in reports]}")
    p0 = reports[0]["paths"]
    fwd, k4, _ = _mp_launches(ctx, reports, "ring_causal")
    tri = nproc * (nproc + 1) // 2
    e = p0["ring_causal"]["errors"]
    share = max(r["paths"]["ring_causal"]["wait_s"] * 1e3
                / r["paths"]["ring_causal"]["ms"] for r in reports)
    print(f"[mp-ring] causal B=1 H={RING_H} N={RING_N} over {nproc} "
          f"processes of one rank ({where}; transport {transport}): "
          f"launches summed fwd {fwd}, K4 {k4} (expect {tri} each); vs the "
          f"one-process {nproc}-rank ring: "
          + ", ".join(f"{k} {v[0]:.3e}/{v[1]:.3e}" for k, v in e.items())
          + f"; forward + backward {p0['ring_causal']['ms']:.1f} ms on p0 "
          f"against {p0['ring_causal']['alone_ms']:.1f} ms in one process; "
          f"host waits on transfers at most {share:.1%} of a process's "
          f"call; {_mp_per_process(reports, 'ring_causal')} ({ctx.card})",
          flush=True)
    _check(fwd == tri and k4 == tri, f"mp ring launches {fwd} {k4}")
    _check(e["o"][0] <= min(GATE, REL_GATE * e["o"][1]), f"mp ring O {e['o']}")
    for g in ("dq", "dk", "dv"):
        _check(e[g][1] > 0 and e[g][0] <= BWD_GATE * e[g][1],
               f"mp ring {g} {e[g]}")
    if "decode" not in p0:
        return
    _, _, k6 = _mp_launches(ctx, reports, "decode")
    e = p0["decode"]["errors"]
    print(f"[mp-decode] ring_decode B={DECODE_B} over a {RING_N}-token "
          f"cache, {nproc} processes: K6 {k6} (expect {nproc}); vs K6 on the "
          f"whole cache O {e['o@whole'][0]:.3e}, LSE {e['lse@whole'][0]:.3e}; "
          f"vs one process O {e['o'][0]:.3e}; {p0['decode']['ms']:.1f} ms "
          f"on p0, {p0['decode']['alone_ms']:.1f} ms in one process "
          f"({ctx.card})", flush=True)
    _check(k6 == nproc, f"mp decode launches {k6}")
    _check(all(v[0] <= GATE for v in e.values()), f"mp decode {e}")


def _mp_report_train(ctx, reports, path, transport, tag):
    """A train path's line and gates, beside the one-process step `tag`."""
    nproc = len(reports)
    fwd, k4, _ = _mp_launches(ctx, reports, path)
    tp = 2 if "tp=" in path else 1
    sp = nproc // tp
    expect = MP_STEPS * TRAIN_KW["n_layers"] * tp * sp * (sp + 1) // 2
    i0 = reports[0]["paths"][path]
    e = i0["errors"]
    worst = max((k for k in e if k != "loss"), key=lambda k: e[k][2])
    step = statistics.median(i0["step_ms"])
    one = ctx.step_ms.get(tag)
    print(f"[mp-train] 271M config, B=1 T={SP_T}, {path} over {nproc} "
          f"processes ({transport}): launches summed fwd {fwd}, K4 {k4} "
          f"(expect {expect} each); loss |d| {e['loss'][0]:.3e} (gate "
          f"{LOSS_GATE}); worst gradient relative L2 {e[worst][2]:.3e} "
          f"({worst}; gate {GRAD_GATE}); step {step:.1f} ms on p0 "
          + (f"against {statistics.median(one):.1f} ms for the one-process "
             f"{tag} step " if one else "")
          + f"(losses {i0['losses']}); {_mp_per_process(reports, path)} "
          f"({ctx.card})", flush=True)
    _check(fwd == expect and k4 == expect,
           f"mp {path} launches {fwd} {k4}")
    _check(e["loss"][0] <= LOSS_GATE and e[worst][2] <= GRAD_GATE,
           f"mp {path}: loss {e['loss']}, {worst} {e[worst]}")


def _k9_bound(ring_devices, rows, d, f32=False):
    """K9's least time over the ring's cards, each at work at once: on a
    card, its ranks' shards and W read once and their o written once
    (fp32) over the memory rate, and their n x n tile products (every
    rank multiplies every shard) over the bf16 rate; where a rank's right
    neighbour is on another card, its n - 1 pushed shards over one
    direction of NVLink. Pushes between ranks of one card need not reach
    the memory (they stay in L2) and are not priced. `f32`: fp32 shards
    and W (4 bytes an element, pushed as split images of the same size),
    the products at the TF32 rate (`_bound_f32`)."""
    size = 4 if f32 else 2
    n, shard = len(ring_devices), rows * d * size
    worst = dict(bound_ms=0.0, bound_by="bytes")
    for card in dict.fromkeys(ring_devices):
        mine = [i for i, c in enumerate(ring_devices) if c == card]
        b = (_bound_f32 if f32 else _bound)(
            len(mine) * (shard + rows * d * 4) + d * d * size,
            len(mine) * n * 2.0 * rows * d * d)
        crossing = sum(ring_devices[(i + 1) % n] != card for i in mine)
        t_link = crossing * (n - 1) * shard / NVLINK_BYTES_PER_S * 1e3
        if t_link > b["bound_ms"]:
            b = dict(bound_ms=t_link, bound_by="bytes")
        if b["bound_ms"] > worst["bound_ms"]:
            worst = b
    return worst


def _phase_device_ring(ctx, devices, where, record):
    """K9 against its plain version and against (sum x_i) @ W in fp32."""
    torch = ctx.torch
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    from cuda_flashattention_torch.utils.timing import cuda_time_ms

    d = 128
    kernel_ms = {}
    for n in (1, K9_RANKS[-1]):
        mesh = make_mesh((n,), ("sp",),
                         [devices[i % len(devices)] for i in range(n)])
        x, w = ctx.mk(n * K9_HOP_ROWS, d), ctx.mk(d, d)
        kernel_ms[K9_HOP_ROWS, n] = _device_ms_by_kernel(
            lambda: device_ring_matmul(x, w, mesh), ("K9",),
            iters=K9_ITERS)["K9"]
    hop = (kernel_ms[K9_HOP_ROWS, K9_RANKS[-1]]
           - kernel_ms[K9_HOP_ROWS, 1]) / (K9_RANKS[-1] - 1)
    scope = device_ring_matmul.last_scope
    print(f"[K9] round trip of one hop ({where}, {scope} scope): "
          f"{hop * 1e3:.2f} us (kernel alone at L={K9_HOP_ROWS}: n=1 "
          f"{kernel_ms[K9_HOP_ROWS, 1]:.4f} ms, n={K9_RANKS[-1]} "
          f"{kernel_ms[K9_HOP_ROWS, K9_RANKS[-1]]:.4f} ms) ({ctx.card})",
          flush=True)
    for rows in K9_SHAPES:
        for n in K9_RANKS:
            ring_devices = [devices[i % len(devices)] for i in range(n)]
            mesh = make_mesh((n,), ("sp",), ring_devices)
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
            bound = _k9_bound(ring_devices, rows, d)
            print(f"[K9] n={n} ranks ({where}), L={rows} d={d}: "
                  f"{device_ring_matmul.last_scope} scope, grid "
                  f"{grid[0]} CTAs x {grid[1]} ranks per launch; vs "
                  f"tile((sum x_i) @ W) in fp32 {e_ref:.3e} (max|ref| "
                  f"{top:.3e}), vs the plain ring {e_plain:.3e} (gates "
                  f"{K9_GATE} and {REL_GATE} x max|ref|); wrapper {ms:.4f} "
                  f"ms, kernel alone {ms_k:.4f} ms, plain ring {ms_p:.4f} "
                  f"ms, one einsum over the shards {ms_lib:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
                  f"latency floor {hop * (n - 1):.4f} ms ({ctx.card})",
                  flush=True)
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


# ---------------------------------------------------------------------------
# fp32 (phases 15-16): the fp32 builds of K1, K1b, K5, K4 and K2, and the
# ladder that runs on them. Gates: O and LSE within 1e-4 of the plain fp32
# version, each gradient within 1e-4 · max(1, max |plain|), on flat
# (uniform ±0.5) and peaked (Q x8, K x4) inputs; the plain versions and
# the library call run with TF32 off.
# ---------------------------------------------------------------------------

F32_GATE = 1e-4
# the fp32 bound's operations rate: the TF32 dense peak, the least time any
# fp32-input tensor-core product could take (the same data sheet)
PEAK_TF32_FLOPS = 495e12
# the fp32 path through K5: `flash_attention` past the online rule's 5120
# rows, causal, forward and backward
F32_PATH = (1, 16, 6144, 128)
LADDER_RANKS = 8


def _bound_f32(nbytes: float, flops: float) -> dict:
    """The least time of an fp32 call: bytes (4 per element) over the
    memory rate, matmul operations over the TF32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_TF32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _call_ms(fn, label, iters=3, attempts=3, before=None) -> float:
    """Device ms per call of package kernel `label` (torch.profiler): its
    launches' time over the launches of its main kernel (K5's finalise
    and the conversion pass of one-byte K/V at d = 256 are added to their
    kernel's call; a K5 call on K1b's Q-major walk launches K1b's kernel,
    which counts as K5's); NaN when none was recorded. `before()`,
    when given, runs ahead of each call (to evict the L2 cache, say).
    Where the profiler records no device activity at all in any of its
    windows, the call is timed by CUDA events instead (the wrapper's
    time, not the kernel's alone), and a line says so."""
    from cuda_flashattention_torch.utils.profiling import kernel_times
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    call = fn if before is None else lambda: (before(), fn())
    recorded = False
    for _ in range(attempts):
        try:
            prof = kernel_times(call, iters=iters)
        except RuntimeError:  # every window of this attempt came back empty
            continue
        recorded = True
        labels = ("K5", "K1b") if label == "K5" else (label,)
        names = [n for n in prof.ms if _kernel_of(n) in labels]
        calls = sum(prof.count[n] for n in names
                    if "finalize" not in n and "convert" not in n)
        if calls:
            return sum(prof.ms[n] for n in names) / calls
    if recorded:
        return float("nan")
    ms = cuda_time_ms(fn, iters=iters, before=before)
    print(f"[profiler] no device activity recorded for {label}: its call "
          f"timed by CUDA events instead, {ms:.4f} ms", flush=True)
    return ms


def _visible_pairs(ctx, b, h, nq, nk, kw) -> int:
    """Visible (query, key) pairs of a call under its masks."""
    ok = _mask(ctx, nq, nk, kw)
    if ok is None:
        return b * h * nq * nk
    n = int(ok.sum().item())
    return h * (n if ok.ndim == 3 else b * n)  # a 3-D mask has the batch


def _mask(ctx, nq, nk, kw):
    """The boolean mask (True: visible) the library call is given, [Nq,
    Nk] or [B, Nq, Nk]; None when `is_causal` or nothing says it. Row i
    is position i + kv_offset."""
    torch = ctx.torch
    rows = (torch.arange(nq, device=ctx.dev)[:, None]
            + kw.get("kv_offset", 0))
    cols = torch.arange(nk, device=ctx.dev)[None, :]
    if kw.get("q_segment_ids") is not None:
        qs, ks = kw["q_segment_ids"], kw["kv_segment_ids"]
        ok = qs[:, :, None] == ks[:, None, :]
        return ok & (cols <= rows) if kw.get("causal") else ok
    if kw.get("window"):
        return (cols <= rows) & (cols > rows - kw["window"])
    if kw.get("causal"):
        return cols <= rows
    return None


def _library_ms(ctx, q, k, v, kw, backward=False, do=None):
    """One `scaled_dot_product_attention` on the same inputs (its autograd
    backward under `backward`), TF32 off, the call's mask given as a
    boolean mask where it has one."""
    torch = ctx.torch
    F = torch.nn.functional
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    ok = _mask(ctx, q.shape[2], k.shape[2], kw)
    mkw = dict(enable_gqa=q.shape[1] != k.shape[1])
    if ok is not None:
        mkw["attn_mask"] = ok[:, None] if ok.ndim == 3 else ok
    if not backward:
        return cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, **mkw), iters=10)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, **mkw)
    return cuda_time_ms(lambda: torch.autograd.grad(
        o, leaves, do, retain_graph=True), iters=10)


def _phase_fp32(ctx):
    """The fp32 builds against their plain fp32 versions, each form
    pinned (K1 online, K1b and K5 through `_plan` + `_fwd_cuda`, K4 through
    `flash_attention_backward`, K2 alone through `ops/flash_bwd._dkdv_cuda`:
    `fused=False` refuses fp32 until K3 has an fp32 build), at the
    reference's 02_fwd shape [1, 1, 512, 64], stage 03's [1, 1, 5096, 64],
    the ring steps of stage 04 ([1, 1, 637, 64]), [1, 16, 4096, 128]
    causal, GQA 16:4, a window and segment ids; each row's kernel ms
    (torch.profiler), bound, plain and library ms beside the bf16 build's
    kernel ms at the same shape. Then the fp32 path through K5:
    `flash_attention` on fp32 [1, 16, 6144, 128] causal, forward and
    backward, against the plain versions, with its launch counts."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops import attention
    from cuda_flashattention_torch.ops import flash_bwd as fb
    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.ops.attention import flash_attention
    from cuda_flashattention_torch.utils.timing import (
        attention_flops, cuda_time_ms)
    dev, card = ctx.dev, ctx.card
    gen = torch.Generator(device=dev).manual_seed(12)

    def inputs(b, h, hkv, nq, nk, d, peaked):
        def u(*shape):
            return torch.rand(shape, generator=gen, device=dev) - 0.5
        q, k, v = u(b, h, nq, d), u(b, hkv, nk, d), u(b, hkv, nk, d)
        return (q * 8, k * 4, v) if peaked else (q, k, v)

    def fwd(form, q, k, v, kw):
        if form == "online":
            return ff.flash_attention_forward(q, k, v, softmax="online",
                                              **kw)
        plan = ff._plan(q, k, v, None, kw.get("causal", False),
                        kw.get("window", 0), 0, None, None, None, None, None,
                        "bound_unchecked", False)
        plan = dataclasses.replace(plan, use_kmajor=form == "kmajor")
        return ff._fwd_cuda(q, k, v, plan, q.dtype, None, None, None, None)

    def fwd_plain(form, q, k, v, kw):
        return ff.flash_attention_forward_plain(
            q, k, v, softmax="online" if form == "online"
            else "bound_unchecked", **kw)

    ids = torch.arange(1024, device=dev) // 300
    segs = dict(q_segment_ids=ids[None], kv_segment_ids=ids[None])
    step = _ladder_rows()
    label = {"online": "K1", "bound": "K1b", "kmajor": "K5"}
    # (name, (B, H, Hkv, Nq, Nk, d), options, forms, the form recorded
    # for the kernels line at this shape: its main path's)
    fwd_cases = [
        ("02_fwd 512", (1, 1, 1, 512, 512, 64), {},
         ("online", "bound", "kmajor"), None),
        ("stage 03 5096", (1, 1, 1, 5096, 5096, 64), {},
         ("online", "bound", "kmajor"), "bound"),
        (f"stage 04 diagonal step {step}", (1, 1, 1, step, step, 64),
         dict(causal=True), ("online",), "online"),
        (f"stage 04 full step {step}", (1, 1, 1, step, step, 64), {},
         ("bound",), None),
        ("4096 causal", (1, 16, 16, 4096, 4096, 128), dict(causal=True),
         ("online", "bound", "kmajor"), None),
        ("GQA 16:4 4096 causal", (1, 16, 4, 4096, 4096, 128),
         dict(causal=True), ("online", "bound", "kmajor"), None),
        ("4096 window 1024", (1, 16, 16, 4096, 4096, 128),
         dict(causal=True, window=1024), ("online", "kmajor"), None),
        ("1024 segment ids", (1, 16, 16, 1024, 1024, 128), segs,
         ("online",), None),
        (f"fp32 path {F32_PATH[2]} causal", (F32_PATH[0], F32_PATH[1],
                                             F32_PATH[1], F32_PATH[2],
                                             F32_PATH[2], F32_PATH[3]),
         dict(causal=True), ("kmajor",), "kmajor"),
    ]
    for name, (b, h, hkv, nq, nk, d), kw, forms, rec_form in fwd_cases:
        flat = inputs(b, h, hkv, nq, nk, d, False)
        peaked = inputs(b, h, hkv, nq, nk, d, True)
        bf = [x.to(torch.bfloat16) for x in flat]
        pairs = _visible_pairs(ctx, b, h, nq, nk, kw)
        nbytes = 4 * (2 * b * h * nq * d + 2 * b * hkv * nk * d + b * h * nq)
        bound = _bound_f32(nbytes, 4.0 * d * pairs)
        lib_ms = _library_ms(ctx, *flat, kw)
        for form in forms:
            errs = []
            for x in (flat, peaked):
                o, lse = fwd(form, *x, kw)
                torch.cuda.synchronize()
                o_p, lse_p = fwd_plain(form, *x, kw)
                errs += [ctx.diff(o, o_p), ctx.diff(lse, lse_p)]
                _check(o.dtype == torch.float32 and bool(
                    torch.isfinite(o).all()) and o_p.abs().max().item() > 0,
                       f"fp32 {label[form]} {name}: O not finite or all 0")
            kn = label[form]
            ms = _call_ms(lambda: fwd(form, *flat, kw), kn)
            ms_bf16 = _call_ms(lambda: fwd(form, *bf, kw), kn)
            ms_w = cuda_time_ms(lambda: fwd(form, *flat, kw), iters=10)
            ms_p = cuda_time_ms(lambda: fwd_plain(form, *flat, kw), iters=3,
                                warmup=1)
            print(f"[fp32] {kn} {name}: B={b} H={h} Hkv={hkv} Nq={nq} "
                  f"Nk={nk} d={d} max|dO| flat {errs[0]:.3e} peaked "
                  f"{errs[2]:.3e}, max|dLSE| {errs[1]:.3e} / {errs[3]:.3e} "
                  f"(gate {F32_GATE}); kernel {ms:.4f} ms "
                  f"({100 * bound['bound_ms'] / ms:.1f}% of its bound "
                  f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}), bf16 "
                  f"kernel {ms_bf16:.4f} ms, wrapper {ms_w:.4f} ms, library "
                  f"fp32 {lib_ms:.4f} ms, plain {ms_p:.4f} ms ({card})",
                  flush=True)
            _check(max(errs) <= F32_GATE, f"fp32 {kn} {name}: max |diff| "
                   f"{max(errs):.3e} > {F32_GATE}")
            r = ctx.rec[f"{kn} fp32"]
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            if form == rec_form:
                r.update(ms=ms, plain_ms=ms_p, library_ms=lib_ms, **bound)
        del flat, peaked, bf

    def grads_close(got, want):
        return [ctx.diff(g, w) / max(1.0, w.abs().max().item())
                for g, w in zip(got, want)]

    # (name, shape, options, the kernels recorded for the kernels line at
    # this shape: their main path's). K3 runs beside K2 on the split path
    # (fused=False), whose errors are its three gradients.
    bwd_cases = [
        (f"stage 04 full step {step}", (1, 1, 1, step, step, 64), {},
         ("K4",)),
        (f"stage 04 diagonal step {step}", (1, 1, 1, step, step, 64),
         dict(causal=True), ()),
        ("03_bwd 128", (1, 1, 1, 128, 128, 64), {}, ()),
        ("02 512", (1, 1, 1, 512, 512, 64), {}, ()),
        ("4096 causal", (1, 16, 16, 4096, 4096, 128), dict(causal=True),
         ()),
        ("GQA 16:4 4096 causal", (1, 16, 4, 4096, 4096, 128),
         dict(causal=True), ()),
        ("4096 window 1024", (1, 16, 16, 4096, 4096, 128),
         dict(causal=True, window=1024), ()),
        ("1024 segment ids", (1, 16, 16, 1024, 1024, 128), segs, ()),
        (f"fp32 path {F32_PATH[2]} causal", (F32_PATH[0], F32_PATH[1],
                                             F32_PATH[1], F32_PATH[2],
                                             F32_PATH[2], F32_PATH[3]),
         dict(causal=True), ("K2", "K3")),
    ]
    for name, (b, h, hkv, nq, nk, d), kw, record in bwd_cases:
        errs = {"K4": [], "K2": [], "K3": []}
        for peaked in (False, True):
            q, k, v = inputs(b, h, hkv, nq, nk, d, peaked)
            do = torch.rand((b, h, nq, d), generator=gen, device=dev) - 0.5
            o, lse = ff.flash_attention_forward_plain(q, k, v, **kw)
            args = (q, k, v, o, lse, do)
            want = fb.flash_attention_backward_plain(*args, **kw)
            got4 = fb.flash_attention_backward(*args, **kw)
            got2 = fb._dkdv_cuda(*args, **kw)
            got3 = fb.flash_attention_backward(*args, fused=False, **kw)
            torch.cuda.synchronize()
            _check(all(g.dtype == torch.float32 and bool(
                torch.isfinite(g).all()) for g in (*got4, *got2, *got3)),
                   f"fp32 backward {name}: a gradient is not fp32 or finite")
            errs["K4"] += grads_close(got4, want)
            errs["K2"] += grads_close(got2, want[1:])
            errs["K3"] += grads_close(got3, want)
            del want, got4, got2, got3
        bf = [x.to(torch.bfloat16) for x in (q, k, v, o)] + [
            lse, do.to(torch.bfloat16)]
        ms4 = _call_ms(lambda: fb.flash_attention_backward(*args, **kw), "K4")
        ms2 = _call_ms(lambda: fb._dkdv_cuda(*args, **kw), "K2")
        ms3 = _call_ms(lambda: fb.flash_attention_backward(
            *args, fused=False, **kw), "K3")
        ms4_bf = _call_ms(lambda: fb.flash_attention_backward(*bf, **kw),
                          "K4")
        ms2_bf = _call_ms(lambda: fb._dkdv_cuda(*bf, **kw), "K2")
        ms3_bf = _call_ms(lambda: fb.flash_attention_backward(
            *bf, fused=False, **kw), "K3")
        ms_p = cuda_time_ms(lambda: fb.flash_attention_backward_plain(
            *args, **kw), iters=3, warmup=1)
        lib_ms = _library_ms(ctx, q, k, v, kw, backward=True, do=do)
        pairs = _visible_pairs(ctx, b, h, nq, nk, kw)
        read = 4 * (3 * b * h * nq * d + 2 * b * hkv * nk * d + b * h * nq)
        bounds = {"K4": _bound_f32(read + 4 * (b * h * nq * d
                                               + 2 * b * hkv * nk * d),
                                   10.0 * d * pairs),
                  "K2": _bound_f32(read + 4 * 2 * b * hkv * nk * d,
                                   8.0 * d * pairs),
                  "K3": _bound_f32(read + 4 * b * h * nq * d,
                                   6.0 * d * pairs)}
        for kn, ms, ms_bf in (("K4", ms4, ms4_bf), ("K2", ms2, ms2_bf),
                              ("K3", ms3, ms3_bf)):
            bd = bounds[kn]
            e = errs[kn]
            grads = ("dK", "dV") if kn == "K2" else ("dQ", "dK", "dV")
            half = len(e) // 2
            what = "K3 (K2 + K3's gradients)" if kn == "K3" else kn
            print(f"[fp32] {what} {name}: B={b} H={h} Hkv={hkv} N={nq} d={d} "
                  f"max|diff|/max(1, max|plain|) flat "
                  + ", ".join(f"{g} {x:.3e}" for g, x in zip(grads, e[:half]))
                  + " peaked "
                  + ", ".join(f"{g} {x:.3e}" for g, x in zip(grads, e[half:]))
                  + f" (gate {F32_GATE}); kernel {ms:.4f} ms "
                  f"({100 * bd['bound_ms'] / ms:.1f}% of its bound "
                  f"{bd['bound_ms']:.4f} ms, {bd['bound_by']}), bf16 kernel "
                  f"{ms_bf:.4f} ms, library fp32 backward {lib_ms:.4f} ms, "
                  f"plain {ms_p:.4f} ms ({card})", flush=True)
            _check(max(errs[kn]) <= F32_GATE, f"fp32 {kn} {name}: "
                   f"{max(errs[kn]):.3e} > {F32_GATE} x max(1, max|plain|)")
            r = ctx.rec[f"{kn} fp32"]
            r["max_abs_err"] = max(r["max_abs_err"], *errs[kn])
            if kn in record:
                r.update(ms=ms, plain_ms=ms_p, library_ms=lib_ms, **bd)
        del q, k, v, o, lse, do, args, bf

    # the fp32 path through K5: flash_attention, forward and backward
    b, h, n, d = F32_PATH
    q, k, v = inputs(b, h, h, n, n, d, False)
    do = torch.rand((b, h, n, d), generator=gen, device=dev) - 0.5
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ctx.zero_counts()
    o = flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    forms = dict(ctx.fwd_forms)
    fused = ctx.bwd_launches["fused"]
    o_p, lse_p = ff.flash_attention_forward_plain(q, k, v, causal=True)
    want = fb.flash_attention_backward_plain(q, k, v, o_p, lse_p, do,
                                             causal=True)
    e_o = ctx.diff(o, o_p)
    e_g = max(grads_close(grads, want))
    print(f"[fp32] path: flash_attention on fp32 {list(F32_PATH)} causal: "
          f"launches {forms} + K4 {fused} (expect kmajor 1, fallback 1, K4 "
          f"1); max|dO| {e_o:.3e}, worst gradient max|diff|/max(1, "
          f"max|plain|) {e_g:.3e} (gate {F32_GATE})", flush=True)
    _check(forms == dict(online=0, bound=0, kmajor=1, fallback=1)
           and fused == 1, f"fp32 path launch counts {forms}, K4 {fused}")
    _check(e_o <= F32_GATE and e_g <= F32_GATE,
           f"fp32 path: dO {e_o:.3e}, gradients {e_g:.3e}")
    ctx.launches["K5 fp32"] += forms["kmajor"]
    ctx.launches["K4 fp32"] += fused
    # the same path through the split backward (K2 + K3's fp32 builds)
    ctx.zero_counts()
    with mock.patch.object(attention, "flash_attention_backward",
                           functools.partial(fb.flash_attention_backward,
                                             fused=False)):
        o = flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    forms = dict(ctx.fwd_forms)
    split = dict(ctx.bwd_launches)
    e_g = max(grads_close(grads, want))
    print(f"[fp32] path, split backward: launches {forms} + {split} (expect "
          f"kmajor 1, fallback 1, dkdv 1, dq 1, fused 0); worst gradient "
          f"max|diff|/max(1, max|plain|) {e_g:.3e} (gate {F32_GATE})",
          flush=True)
    _check(forms == dict(online=0, bound=0, kmajor=1, fallback=1)
           and split == dict(dkdv=1, dq=1, fused=0, delta=1),
           f"fp32 split path launch counts {forms}, {split}")
    _check(e_g <= F32_GATE, f"fp32 split path: gradients {e_g:.3e}")
    ctx.launches["K5 fp32"] += forms["kmajor"]
    ctx.launches["K2 fp32"] += split["dkdv"]
    ctx.launches["K3 fp32"] += split["dq"]
    del leaves, grads, o, want

    # an fp32 Q over quantized K/V, K8 and K9 on fp32
    torch.cuda.empty_cache()
    _phase_f32q_prefix(ctx)
    torch.cuda.empty_cache()
    _phase_f32_fa1(ctx)
    _phase_f32_ring(ctx, [dev], "sharing card 0", record=True)
    if torch.cuda.device_count() > 1:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        _phase_f32_ring(ctx, cards, f"over {len(cards)} distinct cards",
                        record=False)


# K6 / K7 on an fp32 q and at the narrow heads: the serving batch over
# 4224 live tokens of a 4352-token cache, as the bf16 decode rows
DEC_LIVE, DEC_CAP, DEC_PAGE = 4224, 4352, 16
# the forward and K4 at the narrow heads: the training shape at d < 64
NARROW_FWD = (1, 16, 4096)
# fp32 serving at full width: B, prompt, new tokens (greedy)
F32_GEN = (8, 512, 32)
# first-step logits of the fp32 model through the kernels against the same
# through the plain attention functions, times max(1, max |plain|)
F32_LOGIT_GATE = 1e-3
# the ladder model's training steps at d_head 16
LADDER_TRAIN_STEPS, LADDER_TRAIN_T = 3, 64


def _phase_decode_f32(ctx):
    """K6 and K7 on an fp32 q and at d = 16 and 32 against their plain
    versions at the serving batch (B=8, H=16, Hkv=4, 4224 live tokens of
    4352), on flat and peaked inputs: K6 fp32 at d=128 over fp32, int8,
    fp8 and mixed caches beside the bf16 row; K6 and K7 (16-token pages,
    bit for bit against K6 on the same keys) at d = 32 and 16 on bf16 and
    fp32, and fp32 over int8 at d = 16. Each row: the kernel's ms on a
    cold L2 (torch.profiler), its bytes bound, the plain ms and the
    library call's (SDPA on the one-row query under the length mask, on
    the dequantised K/V in q's dtype; TF32 off)."""
    torch = ctx.torch
    F = torch.nn.functional
    from cuda_flashattention_torch.ops.decode import (
        decode_attention, decode_attention_plain)
    from cuda_flashattention_torch.ops.paged import (
        paged_decode_attention, paged_decode_attention_plain)
    from cuda_flashattention_torch.ops.quant import quantize_kv
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    dev, card = ctx.dev, ctx.card
    b, h, hkv = BATCH, 16, 4
    gen = torch.Generator(device=dev).manual_seed(13)
    lens = torch.full((b,), DEC_LIVE, dtype=torch.int32, device=dev)
    live = torch.arange(DEC_CAP, device=dev)[None, :] < lens[:, None]
    n_pages = DEC_CAP // DEC_PAGE
    order = torch.randperm(b * n_pages, generator=gen, device=dev)
    table = order.view(b, n_pages).to(torch.int32)

    def inputs(dtype, d, peaked):
        def u(*shape):
            return torch.rand(shape, generator=gen, device=dev) - 0.5
        q, k, v = u(b, h, d), u(b, hkv, DEC_CAP, d), u(b, hkv, DEC_CAP, d)
        if peaked:
            q, k = q * Q_PEAK, k * K_PEAK
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def paged(x):
        """The cache [B, Hkv, N, ...] as 16-token pages behind `table`."""
        pages = x.view(b, hkv, n_pages, DEC_PAGE, *x.shape[3:]).transpose(
            1, 2).reshape(b * n_pages, hkv, DEC_PAGE, *x.shape[3:])
        pool = torch.empty_like(pages)
        pool[order] = pages
        return pool

    def close(o, lse, o_p, lse_p, f32):
        e_o, e_l = ctx.diff(o, o_p), ctx.diff(lse, lse_p)
        top = o_p.float().abs().max().item()
        ok = top > 0 and bool(torch.isfinite(o.float()).all())
        ok = ok and (e_o <= F32_GATE and e_l <= F32_GATE if f32 else
                     e_o <= min(GATE, REL_GATE * top) and e_l <= GATE)
        return max(e_o, e_l), ok

    bf16_ms = None
    rows = [("K6", torch.bfloat16, 128, None), ("K6", torch.float32, 128, None),
            ("K6", torch.float32, 128, "int8"), ("K6", torch.float32, 128,
                                                 "fp8"),
            ("K6", torch.float32, 128, "mixed")]
    rows += [(kn, dt, d, None) for d in (32, 16)
             for dt in (torch.bfloat16, torch.float32) for kn in ("K6", "K7")]
    rows += [("K6", torch.float32, 16, "int8")]
    for kn, dtype, d, qtype in rows:
        f32 = dtype == torch.float32
        errs, runs = [], {}
        for peaked in (False, True):
            q, k, v = inputs(dtype, d, peaked)
            scales = {}
            if qtype is not None:
                kv = quantize_kv(k, v, qtype)
                k, v = kv.k_q, kv.v_q
                scales = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
            if kn == "K7":
                pk, pv = paged(k), paged(v)

                def call():
                    return paged_decode_attention(q, pk, pv, table, lens)

                def plain():
                    return paged_decode_attention_plain(q, pk, pv, table,
                                                        lens)
            else:
                def call():
                    return decode_attention(q, k, v, lens, **scales)

                def plain():
                    return decode_attention_plain(q, k, v, lens, **scales)
            o, lse = call()
            torch.cuda.synchronize()
            o_p, lse_p = plain()
            e, ok = close(o, lse, o_p, lse_p, f32)
            _check(ok, f"{kn} {dtype} d={d} {qtype or 'cache in q dtype'} "
                   f"peaked={peaked}: max|diff| {e:.3e}")
            errs.append(e)
            if kn == "K7":  # the same keys through K6
                o_c, lse_c = decode_attention(q, k, v, lens)
                _check(bool(torch.equal(o, o_c) and torch.equal(lse, lse_c)),
                       f"K7 {dtype} d={d}: not bit for bit K6's")
            runs[peaked] = (call, plain, q, k, v, scales)
        call, plain, q, k, v, scales = runs[False]
        ms = _call_ms(call, kn, iters=5, before=ctx.l2_flush.zero_)
        ms_p = cuda_time_ms(plain, iters=5, before=ctx.l2_flush.zero_)
        if qtype is None:
            kd, vd = k, v
        else:
            kd = (k.float() * scales["k_scale"][..., None]).to(dtype)
            vd = (v.float() * scales["v_scale"][..., None]).to(dtype)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=live[:, None, None, :],
            enable_gqa=True), before=ctx.l2_flush.zero_)
        tokens = b * hkv * DEC_LIVE
        nbytes = (2 * _nbytes(q) + b * (h + 1) * 4
                  + tokens * d * (k.element_size() + v.element_size())
                  + (tokens * 8 if scales else 0)
                  + (b * n_pages * 4 if kn == "K7" else 0))
        flops = 4.0 * h * d * DEC_LIVE * b
        bound = (_bound_f32 if f32 else _bound)(nbytes, flops)
        if (kn, dtype, d, qtype) == ("K6", torch.bfloat16, 128, None):
            bf16_ms = ms
        tag = "fp32" if f32 else "bf16"
        print(f"[decode-f32] {kn} {tag} q, d={d}, "
              f"{qtype or tag} cache" + (f" in {DEC_PAGE}-token pages"
                                        if kn == "K7" else "")
              + f": B={b} H={h} Hkv={hkv} {DEC_LIVE} live of {DEC_CAP}; "
              f"max|diff| flat {errs[0]:.3e} peaked {errs[1]:.3e} (gate "
              f"{F32_GATE if f32 else GATE}); kernel {ms:.4f} ms cold "
              f"({100 * bound['bound_ms'] / ms:.1f}% of its bound "
              f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}), library "
              f"{lib_ms:.4f} ms, plain {ms_p:.4f} ms; bf16 K6 d=128 "
              f"{bf16_ms:.4f} ms ({card})", flush=True)
        key = {("K6", 128): "K6 fp32", ("K7", 32): "K7 fp32"}.get((kn, d))
        if f32 and key is not None:
            r = ctx.rec[key]
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            if qtype is None:
                r.update(ms=ms, plain_ms=ms_p, library_ms=lib_ms, **bound)
        elif f32 and kn == "K6":
            ctx.rec["K6 fp32"]["max_abs_err"] = max(
                ctx.rec["K6 fp32"]["max_abs_err"], *errs)
        del runs, call, plain, q, k, v, scales, kd, vd


def _phase_narrow_heads(ctx):
    """The forward (K1 online, K1b and K5 pinned) and K4 at d = 16 and 32
    on heads zero-padded to 64, against their plain versions at d, at
    [1, 16, 4096, d] causal, fp32 and bf16, flat and peaked: fp32 within
    1e-4 (per gradient 1e-4 · max(1, max |plain|)), bf16 within 5e-3 (O
    also 2e-2 · max |plain|; per gradient 2e-2 · max |plain|). Each row:
    kernel ms (torch.profiler), the bound of the function at d, plain and
    library ms (SDPA at d, causal; TF32 off), beside the d=64 build's ms
    on unpadded inputs."""
    torch = ctx.torch
    F = torch.nn.functional
    from cuda_flashattention_torch.ops import flash_bwd as fb
    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.utils.timing import (
        attention_flops, cuda_time_ms)
    dev, card = ctx.dev, ctx.card
    b, h, n = NARROW_FWD
    gen = torch.Generator(device=dev).manual_seed(14)
    kw = dict(causal=True)
    label = {"online": "K1", "bound": "K1b", "kmajor": "K5"}

    def inputs(dtype, d, peaked):
        def u(*shape):
            return torch.rand(shape, generator=gen, device=dev) - 0.5
        q, k, v, do = (u(b, h, n, d) for _ in range(4))
        if peaked:
            q, k = q * Q_PEAK, k * K_PEAK
        return [x.to(dtype) for x in (q, k, v, do)]

    def fwd(form, q, k, v):
        if form == "online":
            return ff.flash_attention_forward(q, k, v, softmax="online", **kw)
        plan = ff._plan(q, k, v, None, True, 0, 0, None, None, None, None,
                        None, "bound_unchecked", False)
        plan = dataclasses.replace(plan, use_kmajor=form == "kmajor")
        return ff._fwd_cuda(q, k, v, plan, q.dtype, None, None, None, None)

    def fwd_plain(form, q, k, v):
        return ff.flash_attention_forward_plain(
            q, k, v, softmax="online" if form == "online"
            else "bound_unchecked", **kw)

    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        bnd = _bound_f32 if f32 else _bound
        for d in (16, 32):
            flat, peaked = inputs(dtype, d, False), inputs(dtype, d, True)
            wide = [x.to(dtype) for x in inputs(dtype, 64, False)]
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                *flat[:3], is_causal=True), iters=10)
            # q, k, v read, O and LSE written
            nbytes = _nbytes(*flat[:3], flat[0]) + b * h * n * 4
            for form in ("online", "bound", "kmajor"):
                errs = []
                for x in (flat, peaked):
                    o, lse = fwd(form, *x[:3])
                    torch.cuda.synchronize()
                    o_p, lse_p = fwd_plain(form, *x[:3])
                    top = o_p.float().abs().max().item()
                    e_o, e_l = ctx.diff(o, o_p), ctx.diff(lse, lse_p)
                    errs += [e_o, e_l]
                    ok = (top > 0 and o.shape == x[0].shape
                          and (max(e_o, e_l) <= F32_GATE if f32 else
                               e_o <= min(GATE, REL_GATE * top)
                               and e_l <= GATE))
                    _check(ok, f"{label[form]} {dtype} d={d}: dO {e_o:.3e} "
                           f"dLSE {e_l:.3e} (max|O| {top:.3e})")
                kn = label[form]
                ms = _call_ms(lambda: fwd(form, *flat[:3]), kn)
                ms64 = _call_ms(lambda: fwd(form, *wide[:3]), kn)
                ms_p = cuda_time_ms(lambda: fwd_plain(form, *flat[:3]),
                                    iters=3, warmup=1)
                bound = bnd(nbytes, attention_flops(b, h, n, n, d,
                                                    causal=True))
                print(f"[narrow] {kn} {'fp32' if f32 else 'bf16'} d={d} "
                      f"(run at 64): [{b}, {h}, {n}, {d}] causal; max|dO| "
                      f"flat {errs[0]:.3e} peaked {errs[2]:.3e}, max|dLSE| "
                      f"{errs[1]:.3e} / {errs[3]:.3e}; kernel {ms:.4f} ms "
                      f"({100 * bound['bound_ms'] / ms:.1f}% of the bound "
                      f"at d {bound['bound_ms']:.4f} ms, {bound['bound_by']}"
                      f"), d=64 inputs {ms64:.4f} ms, library {lib_ms:.4f} "
                      f"ms, plain {ms_p:.4f} ms ({card})", flush=True)
                if f32 and form == "online":
                    r = ctx.rec["K1 fp32 d<64"]
                    r["max_abs_err"] = max(r["max_abs_err"], *errs)
                    if d == 16:
                        r.update(ms=ms, plain_ms=ms_p, library_ms=lib_ms,
                                 **bound)
            # K4 on the same inputs
            errs = []
            for x in (flat, peaked):
                q, k, v, do = x
                o, lse = ff.flash_attention_forward_plain(q, k, v, **kw)
                want = fb.flash_attention_backward_plain(q, k, v, o, lse,
                                                         do, **kw)
                got = fb.flash_attention_backward(q, k, v, o, lse, do, **kw)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    top = w.float().abs().max().item()
                    e = ctx.diff(g, w)
                    errs.append(e / max(1.0, top) if f32 else e / top)
                    _check(g.shape == w.shape and top > 0 and
                           errs[-1] <= (F32_GATE if f32 else BWD_GATE),
                           f"K4 {dtype} d={d}: gradient {errs[-1]:.3e}")
            q, k, v, do = flat
            o, lse = ff.flash_attention_forward_plain(q, k, v, **kw)
            args = (q, k, v, o, lse, do)
            ms = _call_ms(lambda: fb.flash_attention_backward(*args, **kw),
                          "K4")
            ms_p = cuda_time_ms(lambda: fb.flash_attention_backward_plain(
                *args, **kw), iters=3, warmup=1)
            lib_ms = _library_ms(ctx, q, k, v, kw, backward=True, do=do)
            # q, k, v, O, dO and LSE read, dQ, dK and dV written
            bound = bnd(_nbytes(q, k, v, o, do, q, k, v) + b * h * n * 4,
                        attention_flops(b, h, n, n, d, causal=True,
                                        backward=True))
            print(f"[narrow] K4 {'fp32' if f32 else 'bf16'} d={d} (run at "
                  f"64): [{b}, {h}, {n}, {d}] causal; worst gradient "
                  f"max|diff| / {'max(1, max|plain|)' if f32 else 'max|plain|'}"
                  f" flat {max(errs[:3]):.3e} peaked {max(errs[3:]):.3e}; "
                  f"kernel {ms:.4f} ms ({100 * bound['bound_ms'] / ms:.1f}% "
                  f"of the bound at d {bound['bound_ms']:.4f} ms, "
                  f"{bound['bound_by']}), library backward {lib_ms:.4f} ms, "
                  f"plain {ms_p:.4f} ms ({card})", flush=True)
            if f32:
                r = ctx.rec["K4 fp32 d<64"]
                r["max_abs_err"] = max(r["max_abs_err"], *errs)
                if d == 16:
                    r.update(ms=ms, plain_ms=ms_p, library_ms=lib_ms,
                             **bound)
            del flat, peaked, wide, args


def _phase_ladder_train(ctx):
    """The ladder model (stage 05's config: fp32, d_head 16) trains: 3
    `make_train_step` SGD steps on B=4 x T=64, each launching K1 and K4
    once per layer on heads padded to 64; one step's loss and gradients
    against the same through the plain attention functions (1e-4 ·
    max(1, max |plain|))."""
    torch = ctx.torch
    from cuda_flashattention_torch.examples import generate as stage05
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops import attention
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward_plain)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward_plain)
    cfg = stage05.CFG
    gen = torch.Generator(device=ctx.dev).manual_seed(15)
    model = tfm.Transformer(cfg, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (4, LADDER_TRAIN_T),
                           generator=gen, device=ctx.dev)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(model, tokens)
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()]

    loss_k, grads_k = loss_and_grads()
    plain_bwd = (lambda q, k, v, o, lse, do, block_sizes=None, fused=None,
                 **kw: flash_attention_backward_plain(q, k, v, o, lse, do,
                                                      **kw))
    with mock.patch.object(attention, "flash_attention_forward",
                           flash_attention_forward_plain), \
            mock.patch.object(attention, "flash_attention_backward",
                              plain_bwd):
        loss_p, grads_p = loss_and_grads()
    e_g = max(ctx.diff(g, w) / max(1.0, w.abs().max().item())
              for g, w in zip(grads_k, grads_p))
    step = tfm.make_train_step(model, torch.optim.SGD(model.parameters(),
                                                      lr=1e-2))
    ctx.zero_counts()
    losses = [step(tokens).item() for _ in range(LADDER_TRAIN_STEPS)]
    torch.cuda.synchronize()
    n_fwd, n_bwd = ctx.fwd_forms["online"], ctx.bwd_launches["fused"]
    expect = cfg.n_layers * LADDER_TRAIN_STEPS
    print(f"[ladder-train] stage 05's model (fp32, d_head 16, run at 64), "
          f"B=4 x T={LADDER_TRAIN_T}: {LADDER_TRAIN_STEPS} SGD steps, "
          f"losses {', '.join(f'{x:.5f}' for x in losses)}; launches K1 "
          f"{n_fwd}, K4 {n_bwd} (expect {expect} each); kernels vs plain: "
          f"loss {loss_k:.6f} vs {loss_p:.6f}, worst gradient max|diff| / "
          f"max(1, max|plain|) {e_g:.3e} (gate {F32_GATE})", flush=True)
    _check(n_fwd == expect and n_bwd == expect and dict(
        ctx.fwd_forms, online=0) == dict(bound=0, kmajor=0, fallback=0,
                                         online=0),
           f"ladder-train launches {ctx.fwd_forms}, K4 {n_bwd}")
    _check(abs(loss_k - loss_p) <= F32_GATE * max(1.0, abs(loss_p))
           and e_g <= F32_GATE and all(math.isfinite(x) for x in losses),
           f"ladder-train: loss {loss_k} vs {loss_p}, gradients {e_g:.3e}")
    ctx.launches["K1 fp32 d<64"] += n_fwd
    ctx.launches["K4 fp32 d<64"] += n_bwd


def _serving_on_plain_attention():
    """A context in which the serving model's attention (prefill and
    chunks, and decode) runs on the plain versions."""
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops import kv_cache
    from cuda_flashattention_torch.ops.decode import decode_attention_plain
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward_plain)
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        tfm, "flash_attention_forward", flash_attention_forward_plain))
    stack.enter_context(mock.patch.object(
        kv_cache, "decode_attention", decode_attention_plain))
    return stack


def _windowed(m, window):
    """Model `m` with cfg.window set: the same parameters, another
    config."""
    w = copy.copy(m)
    w.cfg = dataclasses.replace(m.cfg, window=window)
    return w


def _phase_f32_generate(ctx):
    """The 246M serving config in fp32 (`dtype=torch.float32`) runs
    `generate()` on B=8 prompts of 512 tokens for 32 new tokens, greedily,
    over an fp32 cache and an int8 cache: prefill through K1's fp32 build
    (one per layer), each decode step through K6's fp32 builds (one per
    layer and token). Against the same model on the plain attention
    functions: the fp32-cache rollout's tokens equal, the prefill's logits
    within 1e-3 · max(1, max |plain|); the int8 run, replayed on the fp32
    run's tokens, within 0.25 of its last-step logits."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.models.generate import generate
    from cuda_flashattention_torch.ops.decode import decode_attention
    dev, card = ctx.dev, ctx.card
    bsz, prompt_n, new = F32_GEN
    cfg = tfm.TransformerConfig(dtype=torch.float32, **CFG_KW)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tfm.Transformer(cfg, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (bsz, prompt_n), generator=gen,
                           device=dev, dtype=torch.int32)
    n_params = sum(p.numel() for p in model.parameters())
    generate(model, prompt, 2)  # warm-up
    torch.cuda.synchronize()
    plain_attention = _serving_on_plain_attention

    runs = {}
    for label, kw in (("fp32 cache", {}), ("int8 cache", dict(qtype="int8"))):
        ctx.zero_counts()
        t0 = time.perf_counter()
        out, logits = generate(model, prompt, new, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fwd, n_dec = ctx.fwd_forms["online"], decode_attention.launches
        print(f"[f32-main] {n_params / 1e6:.1f}M params in fp32, B={bsz} "
              f"prompt={prompt_n} new={new}, {label}: launches K1 {n_fwd} "
              f"(expect {cfg.n_layers}), K6 {n_dec} (expect "
              f"{cfg.n_layers * new}); generate {bsz * new / wall:.1f} tok/s "
              f"({wall:.3f} s) ({card})", flush=True)
        _check(n_fwd == cfg.n_layers and n_dec == cfg.n_layers * new
               and sum(ctx.fwd_forms.values()) == n_fwd,
               f"fp32 generate {label}: launches {ctx.fwd_forms}, K6 {n_dec}")
        _check(tuple(out.shape) == (bsz, prompt_n + new)
               and bool(((out >= 0) & (out < cfg.vocab_size)).all())
               and bool(torch.isfinite(logits).all()),
               f"fp32 generate {label}: tokens or logits")
        ctx.launches["K1 fp32"] += n_fwd
        ctx.launches["K6 fp32"] += n_dec
        runs[label] = (out, logits)
    out, logits = runs["fp32 cache"]
    with plain_attention():
        out_p, logits_p = generate(model, prompt, new)
    same = (out == out_p).float().mean().item()
    first = None
    if not torch.equal(out, out_p):
        step = int((out != out_p).any(0).nonzero()[0]) - prompt_n
        first = step
    # the prefill's logits, kernels against plain
    caches = tfm.init_caches(cfg, bsz, prompt_n + new, device=dev)
    lg_k, _ = tfm.prefill(model, prompt, caches)
    with plain_attention():
        caches = tfm.init_caches(cfg, bsz, prompt_n + new, device=dev)
        lg_p, _ = tfm.prefill(model, prompt, caches)
    top = max(1.0, lg_p.abs().max().item())
    e_first = ctx.diff(lg_k, lg_p)
    e_last = ctx.diff(logits, logits_p)
    # the int8 cache replayed on the fp32 run's tokens
    caches = tfm.init_caches(cfg, bsz, prompt_n + new, qtype="int8",
                             device=dev)
    lg8, caches = tfm.prefill(model, prompt, caches)
    for i in range(new):
        lg8, caches = tfm.decode_one(model, out[:, prompt_n + i],
                                     prompt_n + i, caches)
    e8 = ctx.diff(lg8, logits)
    print(f"[f32-main] fp32 cache vs plain attention: tokens equal "
          f"{same:.4f}" + ("" if first is None else
                           f" (first departure at new token {first})")
          + f"; prefill logits max|d| {e_first:.3e} (gate "
          f"{F32_LOGIT_GATE} x {top:.3f}), last-step logits max|d| "
          f"{e_last:.3e}; int8 cache on the fp32 run's tokens: last-step "
          f"logits max|d| {e8:.3e} (gate {QUANT_LOGIT_GATE}); int8 run's "
          f"free greedy tokens equal to the fp32 run's "
          f"{(runs['int8 cache'][0] == out).float().mean().item():.4f}",
          flush=True)
    _check(first is None, f"fp32 generate: tokens depart from the plain "
           f"path at new token {first}")
    _check(e_first <= F32_LOGIT_GATE * top,
           f"fp32 prefill logits {e_first:.3e} > {F32_LOGIT_GATE * top:.3e}")
    _check(e8 <= QUANT_LOGIT_GATE, f"fp32 int8-cache logits {e8:.3e}")
    del model, caches, runs


# an fp32 Q over one-byte K/V (phase 15): the two shapes the fp32 serving
# model's chunked prefill reads its quantized cache at, (B, H, Hkv, Nq,
# Nk, d): the prefix of the last chunk (every key visible) and the
# windowed prefix's slice (window 1024, kv_offset 1024)
F32Q_PREFIX = (8, 16, 4, 512, 3584, 128)
F32Q_WINDOW = (8, 16, 4, 512, 1024, 128)
# K8's fp32 rows: the training shape, and the reference FA1 rung's seeded
# fp32 case (64 rows, d 32, on heads padded to 64)
F32_FA1 = (1, 16, 4096, 128)
F32_FA1_REF = (1, 1, 64, 32)
# fp32 chunked serving: greedy decode steps after the chunked prefill
F32_CHUNK_NEW = 32


def _phase_f32q_prefix(ctx):
    """An fp32 Q over int8, fp8 and mixed K/V at the fp32 serving model's
    prefix shapes: each of K1 (online), K1b and K5 pinned (through `_plan`
    + `_fwd_cuda`, no guarded fallback), and `quantize_q` (its int8 Q over
    int8 keys; dropped over fp8 keys), against the plain fp32 version on
    flat and peaked inputs: O and LSE within 1e-4 (quantize_q computes in
    bf16: 5e-3). Each row: the kernel's ms (torch.profiler), the fp32
    build's ms on the dequantised K/V held in fp32 (three wgmmas a product
    where the codes take two), its bound (the fp32 Q, O and LSE at 4 bytes
    an element, the codes at 1 and their scales; products at the TF32
    rate), the plain ms and the library call (fp32 SDPA, TF32 off, on the
    dequantised K/V)."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.ops.quant import quantize_kv
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    dev, card = ctx.dev, ctx.card
    gen = torch.Generator(device=dev).manual_seed(14)
    cases = [
        ("prefix 512x3584", F32Q_PREFIX, {}, "bound"),
        ("windowed prefix 512x1024", F32Q_WINDOW,
         dict(causal=True, window=1024, kv_offset=1024), "kmajor"),
    ]
    for name, (b, h, hkv, nq, nk, d), kw, routed in cases:
        pairs = _visible_pairs(ctx, b, h, nq, nk, kw)
        nbytes = (4 * (2 * b * h * nq * d + b * h * nq)
                  + 2 * b * hkv * nk * d + 4 * 2 * b * hkv * nk)
        bound = _bound_f32(nbytes, 4.0 * d * pairs)
        for qtype in ("int8", "fp8", "mixed"):
            draws = []
            for peaked in (False, True):
                def u(*shape):
                    return torch.rand(shape, generator=gen,
                                      device=dev) - 0.5
                q, k, v = u(b, h, nq, d), u(b, hkv, nk, d), u(b, hkv, nk, d)
                if peaked:
                    q, k = q * Q_PEAK, k * K_PEAK
                kv = quantize_kv(k, v, qtype)
                draws.append((q, kv.k_q, kv.v_q, kv.k_scale, kv.v_scale))
            q, kq, vq, ks, vs = draws[0]
            kd = kq.float() * ks[..., None]
            vd = vq.float() * vs[..., None]
            lib_ms = _library_ms(ctx, q, kd, vd, kw)
            for form in ("online", "bound", "kmajor", "qq"):
                if form == "qq" and qtype == "fp8":
                    continue  # dropped over fp8 keys under an fp32 Q
                softmax = ("online" if form == "online" else "auto"
                           if form == "qq" else "bound_unchecked")

                def plan_of(x, form=form, softmax=softmax):
                    plan = ff._plan(x[0], x[1], x[2], None,
                                    kw.get("causal", False),
                                    kw.get("window", 0),
                                    kw.get("kv_offset", 0), None, x[3], x[4],
                                    None, None, softmax, form == "qq")
                    if form in ("bound", "kmajor"):
                        plan = dataclasses.replace(
                            plan, use_kmajor=form == "kmajor")
                    return plan

                def call(x, form=form):
                    return ff._fwd_cuda(x[0], x[1], x[2], plan_of(x),
                                        torch.float32, x[3], x[4], None,
                                        None)

                def plain(x, form=form, softmax=softmax):
                    return ff.flash_attention_forward_plain(
                        x[0], x[1], x[2], k_scale=x[3], v_scale=x[4],
                        softmax=softmax, quantize_q=form == "qq",
                        out_dtype=torch.float32, **kw)

                plan = plan_of(draws[0])
                kn = ("K1" if form == "online" else
                      "K5" if plan.use_kmajor else "K1b")
                errs = []
                for x in draws:
                    o, lse = call(x)
                    torch.cuda.synchronize()
                    o_p, lse_p = plain(x)
                    errs += [ctx.diff(o, o_p), ctx.diff(lse, lse_p)]
                    _check(bool(torch.isfinite(o).all())
                           and o_p.abs().max().item() > 0,
                           f"fp32 Q {kn} {qtype} {name}: O not finite or "
                           f"all 0")
                gate = GATE if form == "qq" else F32_GATE
                ms = _call_ms(lambda: call(draws[0]), kn)
                dq = (q, kd, vd, None, None)
                ms_kv = (float("nan") if form == "qq" else
                         _call_ms(lambda: call(dq), kn))
                ms_p = cuda_time_ms(lambda: plain(draws[0]), iters=3,
                                    warmup=1)
                tag = "quantize_q " if form == "qq" else ""
                print(f"[fp32 Q] {tag}{kn} over {qtype} {name}: B={b} H={h} "
                      f"Hkv={hkv} Nq={nq} Nk={nk} d={d} max|dO| flat "
                      f"{errs[0]:.3e} peaked {errs[2]:.3e}, max|dLSE| "
                      f"{errs[1]:.3e} / {errs[3]:.3e} (gate {gate}); kernel "
                      f"{ms:.4f} ms ({100 * bound['bound_ms'] / ms:.1f}% of "
                      f"its bound {bound['bound_ms']:.4f} ms, "
                      f"{bound['bound_by']}), the fp32 K/V build on the "
                      f"dequantised K/V {ms_kv:.4f} ms, library fp32 "
                      f"{lib_ms:.4f} ms, plain {ms_p:.4f} ms ({card})",
                      flush=True)
                _check(max(errs) <= gate, f"fp32 Q {tag}{kn} over {qtype} "
                       f"{name}: max |diff| {max(errs):.3e} > {gate}")
                if form == "qq":
                    continue
                r = ctx.rec[f"{kn} fp32 Q over codes"]
                r["max_abs_err"] = max(r["max_abs_err"], *errs)
                # the main path's shapes: K1b and K5 where "auto" routes,
                # K1 (its guarded fallback there) at the prefix
                if qtype == "int8" and (form == routed or (
                        form == "online" and routed == "bound")):
                    r.update(ms=ms, plain_ms=ms_p, library_ms=lib_ms,
                             **bound)
            del draws, q, kq, vq, ks, vs, kd, vd


def _phase_f32_fa1(ctx):
    """K8's fp32 build against its plain fp32 version on flat and peaked
    inputs (1e-4): its path, fa1_attention on fp32 at [1, 16, 4096, 128]
    causal and not and the reference rung's seeded 64 x 32 case (d 32 on
    heads padded to 64), with the launch counts; each row's kernel ms
    (torch.profiler), bound, plain ms and the library call (fp32 SDPA,
    TF32 off)."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops.fa1 import (
        fa1_attention, fa1_attention_plain)
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    dev, card = ctx.dev, ctx.card
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = [(F32_FA1, True), (F32_FA1, False), (F32_FA1_REF, False)]

    def draw(shape, peaked):
        x = [torch.rand(shape, generator=gen, device=dev) - 0.5
             for _ in range(3)]
        return (x[0] * Q_PEAK, x[1] * K_PEAK, x[2]) if peaked else x

    inputs = {c: (draw(c[0], False), draw(c[0], True)) for c in cases}
    ctx.zero_counts()
    outs = {c: fa1_attention(*inputs[c][0], causal=c[1]) for c in cases}
    torch.cuda.synchronize()
    n = fa1_attention.launches
    _check(n == len(cases), f"fp32 FA1 launched {n} times in {len(cases)} "
           f"calls")
    ctx.launches["K8 fp32"] += n
    for (shape, causal), o in outs.items():
        b, h, nn, d = shape
        flat, peaked = inputs[shape, causal]
        errs = [ctx.diff(o, fa1_attention_plain(*flat, causal=causal))]
        o_pk = fa1_attention(*peaked, causal=causal)
        torch.cuda.synchronize()
        o_pp = fa1_attention_plain(*peaked, causal=causal)
        errs.append(ctx.diff(o_pk, o_pp))
        _check(o.dtype == torch.float32 and bool(torch.isfinite(o).all())
               and o_pp.abs().max().item() > 0,
               f"fp32 K8 {shape}: O not fp32, not finite or all 0")
        kw = dict(causal=causal)
        pairs = _visible_pairs(ctx, b, h, nn, nn, kw)
        bound = _bound_f32(4 * 4 * b * h * nn * d, 4.0 * d * pairs)
        ms = _call_ms(lambda: fa1_attention(*flat, causal=causal), "K8")
        ms_p = cuda_time_ms(lambda: fa1_attention_plain(*flat, causal=causal),
                            iters=3, warmup=1)
        lib_ms = _library_ms(ctx, *flat, kw)
        print(f"[fp32] K8 B={b} H={h} N={nn} d={d} causal={causal}: max|dO| "
              f"flat {errs[0]:.3e} peaked {errs[1]:.3e} (gate {F32_GATE}); "
              f"kernel {ms:.4f} ms ({100 * bound['bound_ms'] / ms:.1f}% of "
              f"its bound {bound['bound_ms']:.4f} ms, {bound['bound_by']}), "
              f"library fp32 {lib_ms:.4f} ms, plain {ms_p:.4f} ms ({card})",
              flush=True)
        _check(max(errs) <= F32_GATE, f"fp32 K8 {shape} causal={causal}: "
               f"{max(errs):.3e} > {F32_GATE}")
        r = ctx.rec["K8 fp32"]
        r["max_abs_err"] = max(r["max_abs_err"], *errs)
        if shape == F32_FA1 and causal:
            r.update(ms=ms, plain_ms=ms_p, library_ms=lib_ms, **bound)
    del inputs, outs


def _phase_f32_ring(ctx, devices, where, record):
    """K9's fp32 build on fp32 shards: its path (`device_ring_matmul` at
    the example's n=4, L=1024, d=128, launches counted) when `record`;
    then at n=4 L=1024 and n=8 L=8192 against the plain ring and
    tile((Σ x_i) @ W) in fp32 (1e-4 · max(1, max |ref|)), the kernel's ms
    (torch.profiler), its bound, the plain ring's ms and one fp32
    `torch.einsum` (TF32 off); 20 repeats at n=8 give the first call's
    bits."""
    torch = ctx.torch
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    from cuda_flashattention_torch.parallel.mesh import make_mesh
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    gen = torch.Generator(device=ctx.dev).manual_seed(18)
    d = 128

    def draw(*shape):
        return torch.rand(shape, generator=gen, device=ctx.dev) - 0.5

    if record:
        n, rows = 4, K9_SHAPES[0]
        mesh = make_mesh((n,), ("sp",), [devices[0]] * n)
        x, w = draw(n * rows, d), draw(d, d)
        ctx.zero_counts()
        device_ring_matmul(x, w, mesh)
        torch.cuda.synchronize()
        ctx.launches["K9 fp32"] += device_ring_matmul.launches
        _check(device_ring_matmul.launches == 1,
               f"fp32 K9 path: {device_ring_matmul.launches} launches")
    for n, rows in ((4, K9_SHAPES[0]), (8, K9_SHAPES[1])):
        ring_devices = [devices[i % len(devices)] for i in range(n)]
        mesh = make_mesh((n,), ("sp",), ring_devices)
        x, w = draw(n * rows, d), draw(d, d)
        o = device_ring_matmul(x, w, mesh)
        torch.cuda.synchronize()
        ref = (x.view(n, rows, d).sum(0) @ w).repeat(n, 1)
        gate = F32_GATE * max(1.0, ref.abs().max().item())
        o_p = ring_matmul_plain(x, w, mesh)
        errs = [ctx.diff(o, ref), ctx.diff(o, o_p)]
        ms_k = _device_ms_by_kernel(lambda: device_ring_matmul(x, w, mesh),
                                    ("K9",), iters=K9_ITERS)["K9"]
        ms_p = cuda_time_ms(lambda: ring_matmul_plain(x, w, mesh),
                            iters=K9_ITERS)
        x3 = x.view(n, rows, d)
        ms_lib = cuda_time_ms(lambda: torch.einsum("nld,de->le", x3, w),
                              iters=K9_ITERS)
        bound = _k9_bound(ring_devices, rows, d, f32=True)
        same = sum(torch.equal(device_ring_matmul(x, w, mesh), o)
                   for _ in range(20)) if n == 8 else 20
        print(f"[fp32] K9 n={n} ranks ({where}), L={rows} d={d}: "
              f"{device_ring_matmul.last_scope} scope; vs tile((sum x_i) @ "
              f"W) {errs[0]:.3e}, vs the plain ring {errs[1]:.3e} (gate "
              f"{gate:.3e}); kernel {ms_k:.4f} ms "
              f"({100 * bound['bound_ms'] / ms_k:.1f}% of its bound "
              f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}), plain ring "
              f"{ms_p:.4f} ms, one fp32 einsum {ms_lib:.4f} ms; repeats "
              f"equal {same}/20 ({ctx.card})", flush=True)
        _check(max(errs) <= gate and bool(torch.isfinite(o).all())
               and same == 20, f"fp32 K9 n={n} L={rows}: {errs}, "
               f"{same}/20 repeats")
        if record:
            r = ctx.rec["K9 fp32"]
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            if n == 4:
                r.update(ms=ms_k, plain_ms=ms_p, library_ms=ms_lib, **bound)


def _phase_f32_chunked(ctx):
    """Main path of fp32 chunked serving over a quantized cache: the 246M
    serving config with `dtype=torch.float32`, B=8 prompts of 4096 tokens
    through `prefill_chunked(chunk=512)`, then 32 greedy `decode_one`
    steps, over an int8, an fp8 and a mixed cache and, with `cfg.window` =
    1024, an int8 cache. Per layer each chunk launches K1's fp32 build on
    itself and, after the first, reads the cached prefix with its fp32 Q
    over the codes: K1b (no window) or K5 (window), each with its guarded
    fallback (K1's fp32-Q build, which exits at once); K6's fp32 builds
    decode. Counts per form: 32, 28 and 28, K6 128. Against the same run
    on the plain attention functions: the last chunk's logits within
    F32_LOGIT_GATE · max(1, max |plain|), and the greedy tokens equal, or
    departing only where the plain run's two best logits lie within that
    gate of each other (a tie the kernels' fp32 rounding may break).
    Then a torch.profiler breakdown of one chunked prefill over the int8
    cache."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.utils.profiling import kernel_times
    dev, card = ctx.dev, ctx.card
    cfg = tfm.TransformerConfig(dtype=torch.float32, **CFG_KW)
    gen = torch.Generator(device=dev).manual_seed(16)
    model = tfm.Transformer(cfg, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, LONG_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    new = F32_CHUNK_NEW
    n_chunks = LONG_PROMPT // LONG_CHUNK
    long_len = LONG_PROMPT + new

    def prefill(m, qtype):
        caches = tfm.init_caches(m.cfg, BATCH, long_len, qtype=qtype,
                                 device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = tfm.prefill_chunked(m, prompt, caches, chunk=LONG_CHUNK)
        torch.cuda.synchronize()
        return lg, caches, time.perf_counter() - t0

    def serve(m, qtype):
        """(last-chunk logits, tokens [B, 1 + new], each decode step's
        logits, prefill s, decode s)"""
        lg, caches, prefill_s = prefill(m, qtype)
        tok = torch.argmax(lg, dim=-1).to(prompt.dtype)
        toks, steps = [tok], []
        t0 = time.perf_counter()
        for i in range(new):
            lg_dec, caches = tfm.decode_one(m, tok, LONG_PROMPT + i, caches)
            tok = torch.argmax(lg_dec, dim=-1).to(prompt.dtype)
            toks.append(tok)
            steps.append(lg_dec)
        torch.cuda.synchronize()
        return (lg, torch.stack(toks, 1), steps, prefill_s,
                time.perf_counter() - t0)

    prefill(model, "int8")  # warm-up: allocator at the long shapes
    n_prefix = (n_chunks - 1) * cfg.n_layers
    for label, qtype, window, prefix_form in (
            ("int8 cache", "int8", 0, "bound"),
            ("fp8 cache", "fp8", 0, "bound"),
            ("mixed cache", "mixed", 0, "bound"),
            ("int8 cache, window 1024", "int8", LONG_WINDOW, "kmajor")):
        m = _windowed(model, window) if window else model
        ctx.zero_counts()
        lg, toks, _, prefill_s, decode_s = serve(m, qtype)
        counts = dict(ctx.fwd_forms)
        n_dec = decode_attention.launches
        expect = dict(online=n_chunks * cfg.n_layers, bound=0, kmajor=0,
                      fallback=n_prefix)
        expect[prefix_form] = n_prefix
        with _serving_on_plain_attention():
            lg_p, toks_p, steps_p, _, _ = serve(m, qtype)
        top = max(1.0, lg_p.abs().max().item())
        e_lg = ctx.diff(lg, lg_p)
        same = (toks == toks_p).float().mean().item()
        departure = ""
        tie_ok = True
        if not torch.equal(toks, toks_p):
            step = int((toks != toks_p).any(0).nonzero()[0])
            at = lg_p if step == 0 else steps_p[step - 1]
            rows = toks[:, step] != toks_p[:, step]
            best = at[rows].float().topk(2, dim=-1).values
            gap = (best[:, 0] - best[:, 1]).max().item()
            tie_ok = gap <= F32_LOGIT_GATE * top
            departure = (f" (first departure at token {step}, where the "
                         f"plain run's two best logits lie {gap:.3e} apart)")
        print(f"[f32-chunked] {label}: fp32 model, B={BATCH} x "
              f"{LONG_PROMPT} tokens in chunks of {LONG_CHUNK}, then {new} "
              f"greedy steps: launches {counts} (expect {expect}), K6 "
              f"{n_dec} (expect {cfg.n_layers * new}); last-chunk logits vs "
              f"plain attention max|d| {e_lg:.3e} (gate {F32_LOGIT_GATE} x "
              f"{top:.3f}); greedy tokens equal {same:.4f}{departure}; "
              f"prefill {prefill_s * 1e3:.3f} ms "
              f"({BATCH * LONG_PROMPT / prefill_s:.0f} prompt tok/s), decode "
              f"{decode_s / new * 1e3:.3f} ms/step ({card})", flush=True)
        _check(counts == expect and n_dec == cfg.n_layers * new,
               f"fp32 chunked {label}: launches {counts}, K6 {n_dec}")
        _check(bool(torch.isfinite(lg).all()) and e_lg <= F32_LOGIT_GATE * top,
               f"fp32 chunked {label}: logits {e_lg:.3e}")
        _check(tie_ok, f"fp32 chunked {label}: tokens depart from the plain "
               f"run{departure}")
        ctx.launches["K1 fp32"] += counts["online"]
        ctx.launches["K1b fp32 Q over codes"] += counts["bound"]
        ctx.launches["K5 fp32 Q over codes"] += counts["kmajor"]
        # the guarded launches behind the prefix reads: K1's fp32-Q build,
        # launched and exiting at once (no row's bound was loose)
        ctx.launches["K1 fp32 Q over codes"] += counts["fallback"]
        ctx.launches["K6 fp32"] += n_dec
        del lg_p, steps_p
    # where one chunked prefill's time goes (int8 cache)
    prof = kernel_times(lambda: prefill(model, "int8"))
    groups, by_name = {}, {}
    for n, t in prof.ms.items():
        groups[_group_of(n)] = groups.get(_group_of(n), 0.0) + t
        short = n.replace("void ", "", 1).replace(
            "(anonymous namespace)::", "").split("(")[0][:80]
        by_name[short] = by_name.get(short, 0.0) + t
    print(f"[f32-chunked] profile of one chunked prefill, int8 cache: "
          f"{sum(prof.count.values())} kernels, device busy "
          f"{prof.busy_ms:.3f} ms of a profiled wall of {prof.wall_ms:.3f} "
          f"ms ({prof.busy_ms / prof.wall_ms:.1%}) ({card})", flush=True)
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[f32-chunked]   {g}: {t:.3f} ms ({t / prof.busy_ms:.1%} of "
              f"busy)")
    for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print(f"[f32-chunked]   top kernel {n}: {t:.3f} ms")
    del model


# An fp32 model over bf16 caches (phases 22-24): the forward's shapes (the
# training shape, and the chunked prefill's prefix reads), the decode rows'
# context, and the main path's decode steps and paged run
F32BF16_TRAIN = (1, 16, 16, 4096, 4096, 128)  # B, H, Hkv, Nq, Nk, d: causal
F32BF16_PAGED_STEPS = 32


def _phase_f32_bf16_forward(ctx):
    """An fp32 Q over bf16 K/V in K1 (online), K1b and K5, each pinned
    (through `_plan` + `_fwd_cuda`, no guarded fallback), at [1, 16, 4096,
    128] causal, at the fp32 serving model's prefix reads (512 rows over
    3584 keys; over the 1024-key slice under window 1024) and at [1, 16,
    6144, 128] causal (where "auto" sends such a call to K5), against the
    plain fp32 version on flat and peaked inputs: O and LSE within 1e-4.
    Then fp16 O from the same launches: the fp32-out O rounded to fp16 (K5,
    whose fp32 sums add in any order, within one fp16 ulp). Each row: the
    kernel's ms (torch.profiler), the fp32 K/V build's ms on the K/V
    upcast to fp32, the fp16-out ms, its bound (fp32 Q, O and LSE at 4
    bytes an element, bf16 K/V at 2; products at the TF32 rate), the plain
    ms, and the library call (fp32 SDPA, TF32 off, on the K/V upcast to
    fp32) with the upcast's own ms."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    dev, card = ctx.dev, ctx.card
    gen = torch.Generator(device=dev).manual_seed(22)
    # (name, shape, masks, the forms whose JSON row this shape fills: the
    # main path's; K1 is the guarded launch behind K1b at the prefix)
    n6144 = F32_PATH[2]
    cases = [
        ("[1, 16, 4096, 128] causal", F32BF16_TRAIN, dict(causal=True), ()),
        ("prefix 512x3584", F32Q_PREFIX, {}, ("bound", "online")),
        ("windowed prefix 512x1024", F32Q_WINDOW,
         dict(causal=True, window=1024, kv_offset=1024), ()),
        (f"[1, 16, {n6144}, 128] causal", (1, 16, 16, n6144, n6144, 128),
         dict(causal=True), ("kmajor",)),
    ]
    for name, (b, h, hkv, nq, nk, d), kw, recorded in cases:
        pairs = _visible_pairs(ctx, b, h, nq, nk, kw)
        nbytes = 4 * (2 * b * h * nq * d + b * h * nq) + 2 * 2 * b * hkv * nk * d
        bound = _bound_f32(nbytes, 4.0 * d * pairs)
        draws = []
        for peaked in (False, True):
            def u(*shape):
                return torch.rand(shape, generator=gen, device=dev) - 0.5
            q, k, v = u(b, h, nq, d), u(b, hkv, nk, d), u(b, hkv, nk, d)
            if peaked:
                q, k = q * Q_PEAK, k * K_PEAK
            draws.append((q, k.bfloat16(), v.bfloat16()))
        q, k, v = draws[0]
        up_ms = cuda_time_ms(lambda: (k.float(), v.float()), iters=10)
        kf, vf = k.float(), v.float()
        lib_ms = _library_ms(ctx, q, kf, vf, kw)
        for form in ("online", "bound", "kmajor"):
            softmax = "online" if form == "online" else "bound_unchecked"

            def call(x, out=torch.float32, form=form, softmax=softmax):
                plan = ff._plan(x[0], x[1], x[2], None,
                                kw.get("causal", False), kw.get("window", 0),
                                kw.get("kv_offset", 0), None, None, None,
                                None, None, softmax, False)
                if form != "online":
                    plan = dataclasses.replace(
                        plan, use_kmajor=form == "kmajor")
                return ff._fwd_cuda(x[0], x[1], x[2], plan, out, None, None,
                                    None, None)

            def plain(x, softmax=softmax):
                return ff.flash_attention_forward_plain(
                    x[0], x[1], x[2], softmax=softmax,
                    out_dtype=torch.float32, **kw)

            kn = {"online": "K1", "bound": "K1b", "kmajor": "K5"}[form]
            errs = []
            for x in draws:
                o, lse = call(x)
                torch.cuda.synchronize()
                o_p, lse_p = plain(x)
                errs += [ctx.diff(o, o_p), ctx.diff(lse, lse_p)]
                _check(bool(torch.isfinite(o).all())
                       and o_p.abs().max().item() > 0,
                       f"fp32 Q {kn} over bf16 {name}: O not finite or "
                       f"all 0")
            o32, lse32 = call(draws[0])
            o16, lse16 = call(draws[0], torch.float16)
            torch.cuda.synchronize()
            top = max(1.0, o32.abs().max().item())
            e16 = ctx.diff(o16, o32.half())
            gate16 = 2.0 ** -10 * top if form == "kmajor" else 0.0
            ms = _call_ms(lambda: call(draws[0]), kn)
            ms16 = _call_ms(lambda: call(draws[0], torch.float16), kn)
            ms_kv = _call_ms(lambda: call((q, kf, vf)), kn)
            ms_p = cuda_time_ms(lambda: plain(draws[0]), iters=3, warmup=1)
            print(f"[fp32 Q over bf16] {kn} {name}: B={b} H={h} Hkv={hkv} "
                  f"Nq={nq} Nk={nk} d={d} max|dO| flat {errs[0]:.3e} "
                  f"peaked {errs[2]:.3e}, max|dLSE| {errs[1]:.3e} / "
                  f"{errs[3]:.3e} (gate {F32_GATE}); kernel {ms:.4f} ms "
                  f"({100 * bound['bound_ms'] / ms:.1f}% of its bound "
                  f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}), the "
                  f"fp32 K/V build on the upcast K/V {ms_kv:.4f} ms, "
                  f"library fp32 {lib_ms:.4f} ms + upcast {up_ms:.4f} ms, "
                  f"plain {ms_p:.4f} ms; fp16 O {ms16:.4f} ms, vs the fp32 "
                  f"O rounded {e16:.3e} (gate {gate16:.3e}) ({card})",
                  flush=True)
            _check(max(errs) <= F32_GATE, f"fp32 Q {kn} over bf16 {name}: "
                   f"max |diff| {max(errs):.3e} > {F32_GATE}")
            _check(o16.dtype == torch.float16 and e16 <= gate16
                   and ctx.diff(lse16, lse32) <= (F32_GATE if gate16
                                                  else 0.0),
                   f"fp16 O of {kn} {name}: {e16:.3e} > {gate16:.3e}")
            r = ctx.rec[f"{kn} fp32 Q over bf16"]
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            if form in recorded:
                r.update(ms=ms, plain_ms=ms_p, library_ms=lib_ms, **bound)
        del draws, q, k, v, kf, vf


def _phase_f32_bf16_decode(ctx):
    """K6 and K7 on an fp32 q over a bf16 cache against their plain
    versions at the serving batch (B=8, H=16, Hkv=4, 4224 live tokens of
    4352), d = 128, 64, 32 and 16, flat and peaked inputs (1e-4); K7 over
    the same keys in pages (128 tokens at d = 128, else 16) bit for bit
    against K6. At d = 128 each: the kernel's ms on a cold L2
    (torch.profiler), its bytes bound (fp32 q and O, bf16 K/V), the plain
    ms, and the library call (fp32 SDPA on the one-row query under the
    length mask, TF32 off, on the cache upcast to fp32) with the upcast's
    own ms."""
    torch = ctx.torch
    F = torch.nn.functional
    from cuda_flashattention_torch.ops.decode import (
        decode_attention, decode_attention_plain)
    from cuda_flashattention_torch.ops.paged import (
        paged_decode_attention, paged_decode_attention_plain)
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    dev, card = ctx.dev, ctx.card
    b, h, hkv = BATCH, 16, 4
    gen = torch.Generator(device=dev).manual_seed(23)
    lens = torch.full((b,), DEC_LIVE, dtype=torch.int32, device=dev)
    live = torch.arange(DEC_CAP, device=dev)[None, :] < lens[:, None]
    for d in (128, 64, 32, 16):
        page = PAGE if d == 128 else DEC_PAGE
        n_pages = DEC_CAP // page
        order = torch.randperm(b * n_pages, generator=gen, device=dev)
        table = order.view(b, n_pages).to(torch.int32)

        def paged(x):
            pages = x.view(b, hkv, n_pages, page, d).transpose(1, 2).reshape(
                b * n_pages, hkv, page, d)
            pool = torch.empty_like(pages)
            pool[order] = pages
            return pool

        errs, runs = {"K6": [], "K7": []}, None
        for peaked in (False, True):
            def u(*shape):
                return torch.rand(shape, generator=gen, device=dev) - 0.5
            q = u(b, h, d)
            k, v = u(b, hkv, DEC_CAP, d), u(b, hkv, DEC_CAP, d)
            if peaked:
                q, k = q * Q_PEAK, k * K_PEAK
            k, v = k.bfloat16(), v.bfloat16()
            pk, pv = paged(k), paged(v)
            o, lse = decode_attention(q, k, v, lens)
            o7, lse7 = paged_decode_attention(q, pk, pv, table, lens)
            torch.cuda.synchronize()
            o_p, lse_p = decode_attention_plain(q, k, v, lens)
            o7_p, lse7_p = paged_decode_attention_plain(q, pk, pv, table,
                                                        lens)
            errs["K6"].append(max(ctx.diff(o, o_p), ctx.diff(lse, lse_p)))
            errs["K7"].append(max(ctx.diff(o7, o7_p),
                                  ctx.diff(lse7, lse7_p)))
            _check(o.dtype == torch.float32 and o_p.abs().max().item() > 0
                   and max(errs["K6"] + errs["K7"]) <= F32_GATE,
                   f"fp32 q over bf16 cache d={d} peaked={peaked}: {errs}")
            _check(bool(torch.equal(o7, o) and torch.equal(lse7, lse)),
                   f"K7 fp32 q over bf16 pools d={d}: not bit for bit K6's")
            if not peaked:
                runs = (q, k, v, pk, pv, table)
        if d != 128:
            print(f"[decode fp32 q over bf16] K6 and K7 d={d}: max|diff| "
                  f"K6 {max(errs['K6']):.3e}, K7 {max(errs['K7']):.3e} "
                  f"(gate {F32_GATE}), K7 bit for bit K6 ({card})",
                  flush=True)
            continue
        q, k, v, pk, pv, table = runs
        up_ms = cuda_time_ms(lambda: (k.float(), v.float()),
                             before=ctx.l2_flush.zero_)
        kf, vf = k.float(), v.float()
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kf, vf, attn_mask=live[:, None, None, :],
            enable_gqa=True), before=ctx.l2_flush.zero_)
        tokens = b * hkv * DEC_LIVE
        for kn in ("K6", "K7"):
            if kn == "K6":
                def call():
                    return decode_attention(q, k, v, lens)

                def plain():
                    return decode_attention_plain(q, k, v, lens)
            else:
                def call():
                    return paged_decode_attention(q, pk, pv, table, lens)

                def plain():
                    return paged_decode_attention_plain(q, pk, pv, table,
                                                        lens)
            ms = _call_ms(call, kn, iters=5, before=ctx.l2_flush.zero_)
            ms_p = cuda_time_ms(plain, iters=5, before=ctx.l2_flush.zero_)
            nbytes = (2 * _nbytes(q) + b * h * 4 + b * 4 + tokens * d * 4
                      + (b * n_pages * 4 if kn == "K7" else 0))
            bound = _bound_f32(nbytes, 4.0 * h * d * DEC_LIVE * b)
            print(f"[decode fp32 q over bf16] {kn} d={d}"
                  + (f", {page}-token pages" if kn == "K7" else "")
                  + f": B={b} H={h} Hkv={hkv} {DEC_LIVE} live of {DEC_CAP}; "
                  f"max|diff| flat {errs[kn][0]:.3e} peaked "
                  f"{errs[kn][1]:.3e} (gate {F32_GATE}); kernel {ms:.4f} ms "
                  f"cold ({100 * bound['bound_ms'] / ms:.1f}% of its bound "
                  f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}), library "
                  f"fp32 {lib_ms:.4f} ms + upcast {up_ms:.4f} ms, plain "
                  f"{ms_p:.4f} ms ({card})", flush=True)
            r = ctx.rec[f"{kn} fp32 q over bf16"]
            r["max_abs_err"] = max(r["max_abs_err"], *errs[kn])
            r.update(ms=ms, plain_ms=ms_p, library_ms=lib_ms, **bound)
        del runs, q, k, v, pk, pv, kf, vf


def _phase_f32_bf16_serving(ctx):
    """Main path of an fp32 model served over bf16 caches: the 246M
    serving config with `dtype=torch.float32`, one bf16 cache per layer
    from `init_cache(..., dtype=torch.bfloat16)`, B=8 prompts of 4096
    tokens through `prefill_chunked(chunk=512)`, then 32 greedy
    `decode_one` steps; again with `cfg.window` = 1024. Per layer each
    chunk launches K1's fp32 build on itself (fp32 over fp32) and, after
    the first, reads the bf16 prefix with its fp32 Q as "auto" routes it,
    as the JAX function does: K1b with its guarded fallback (K1's fp32-Q-
    over-bf16 build, which exits at once) without a window, and K1's
    fp32-Q-over-bf16 build under the window (a causal read of 512 rows
    goes online); decode is K6's fp32-q-over-bf16 build. Counts: online 32
    (+ 28 under the window), bound 28 and fallback 28 without it, K6 128.
    K5's build for an fp32 Q over bf16 K/V is where "auto" sends a causal
    call past 5120 rows: `flash_attention_forward` on an fp32 Q over bf16
    K/V at [1, 16, 6144, 128] causal, K5 and its guarded K1 once each,
    within 1e-4 of the plain version. Against the same run on the
    plain attention functions: each run's last-chunk logits within
    F32_LOGIT_GATE · max(1, max |plain|) and its greedy tokens equal (or
    departing only where the plain run's two best logits lie within that
    gate). Then the paged run of the serving stage at the model's
    attention shape: bf16 pools of 4096 pages of 128 tokens, B=8 sequences
    of 4096 fp32 K/V tokens through `reserve_for` + `paged_bulk_append`,
    32 steps of `reserve_for` + `paged_append` + `paged_decode_step` on an
    fp32 q (K7), each bit for bit against K6 on a contiguous bf16 shadow
    and once within 1e-4 of the plain version; a sequence retires and its
    pages serve a new one."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.kv_cache import (
        append as cache_append, init_cache)
    from cuda_flashattention_torch.ops.paged import (
        PageAllocator, init_paged_cache, paged_append, paged_bulk_append,
        paged_decode_attention, paged_decode_attention_plain,
        paged_decode_step)
    dev, card = ctx.dev, ctx.card
    cfg = tfm.TransformerConfig(dtype=torch.float32, **CFG_KW)
    gen = torch.Generator(device=dev).manual_seed(24)
    model = tfm.Transformer(cfg, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, LONG_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    new, n_chunks = F32_CHUNK_NEW, LONG_PROMPT // LONG_CHUNK
    n_prefix = (n_chunks - 1) * cfg.n_layers

    def caches():
        return tuple(init_cache(BATCH, cfg.n_kv_heads, LONG_PROMPT + new,
                                cfg.d_head, dtype=torch.bfloat16, device=dev)
                     for _ in range(cfg.n_layers))

    def serve(m):
        """(last-chunk logits, tokens [B, 1 + new], each step's logits,
        prefill s, decode s)"""
        c = caches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, c = tfm.prefill_chunked(m, prompt, c, chunk=LONG_CHUNK)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        _check(all(x.k.dtype == torch.bfloat16 for x in c),
               "the caches are not bf16")
        tok = torch.argmax(lg, dim=-1).to(prompt.dtype)
        toks, steps = [tok], []
        t0 = time.perf_counter()
        for i in range(new):
            lg_dec, c = tfm.decode_one(m, tok, LONG_PROMPT + i, c)
            tok = torch.argmax(lg_dec, dim=-1).to(prompt.dtype)
            toks.append(tok)
            steps.append(lg_dec)
        torch.cuda.synchronize()
        return (lg, torch.stack(toks, 1), steps, prefill_s,
                time.perf_counter() - t0)

    serve(model)  # warm-up
    n_own = n_chunks * cfg.n_layers  # the chunks' own reads, fp32 over fp32
    for label, window in (("bf16 caches", 0),
                          ("bf16 caches, window 1024", LONG_WINDOW)):
        m = _windowed(model, window) if window else model
        ctx.zero_counts()
        lg, toks, steps, prefill_s, decode_s = serve(m)
        counts = dict(ctx.fwd_forms)
        n_dec = decode_attention.launches
        expect = (dict(online=n_own + n_prefix, bound=0, kmajor=0,
                       fallback=0) if window else
                  dict(online=n_own, bound=n_prefix, kmajor=0,
                       fallback=n_prefix))
        with _serving_on_plain_attention():
            lg_p, toks_p, steps_p, _, _ = serve(m)
        top = max(1.0, max(x.abs().max().item() for x in [lg_p] + steps_p))
        e_lg = max(ctx.diff(a, b_) for a, b_ in zip([lg] + steps,
                                                    [lg_p] + steps_p))
        same = (toks == toks_p).float().mean().item()
        departure, tie_ok = "", True
        if not torch.equal(toks, toks_p):
            step = int((toks != toks_p).any(0).nonzero()[0])
            at = lg_p if step == 0 else steps_p[step - 1]
            rows = toks[:, step] != toks_p[:, step]
            best = at[rows].float().topk(2, dim=-1).values
            gap = (best[:, 0] - best[:, 1]).max().item()
            tie_ok = gap <= F32_LOGIT_GATE * top
            departure = (f" (first departure at token {step}, where the "
                         f"plain run's two best logits lie {gap:.3e} apart)")
            e_lg = ctx.diff(lg, lg_p)  # past a departure the contexts differ
        print(f"[f32-over-bf16] {label}: fp32 model, B={BATCH} x "
              f"{LONG_PROMPT} tokens in chunks of {LONG_CHUNK}, then {new} "
              f"greedy steps: launches {counts} (expect {expect}), K6 "
              f"{n_dec} (expect {cfg.n_layers * new}); logits vs plain "
              f"attention max|d| {e_lg:.3e} (gate {F32_LOGIT_GATE} x "
              f"{top:.3f}); greedy tokens equal {same:.4f}{departure}; "
              f"prefill {prefill_s * 1e3:.3f} ms "
              f"({BATCH * LONG_PROMPT / prefill_s:.0f} prompt tok/s), decode "
              f"{decode_s / new * 1e3:.3f} ms/step ({card})", flush=True)
        _check(counts == expect and n_dec == cfg.n_layers * new,
               f"fp32 over bf16 {label}: launches {counts}, K6 {n_dec}")
        _check(bool(torch.isfinite(lg).all()) and e_lg <= F32_LOGIT_GATE * top,
               f"fp32 over bf16 {label}: logits {e_lg:.3e}")
        _check(tie_ok, f"fp32 over bf16 {label}: tokens depart from the "
               f"plain run{departure}")
        ctx.launches["K1 fp32"] += n_own
        ctx.launches["K1b fp32 Q over bf16"] += counts["bound"]
        # K1's build for an fp32 Q over bf16 K/V: the windowed prefix reads
        # and the guarded launches behind K1b (which exit at once)
        ctx.launches["K1 fp32 Q over bf16"] += (counts["online"] - n_own
                                                + counts["fallback"])
        ctx.launches["K6 fp32 q over bf16"] += n_dec
        del lg_p, steps_p
    del model

    # K5's build: "auto" on a causal call past 5120 rows
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward, flash_attention_forward_plain)
    b, h, hkv, nq, nk, d = F32_PATH[0], F32_PATH[1], F32_PATH[1], \
        F32_PATH[2], F32_PATH[2], F32_PATH[3]
    q = torch.rand((b, h, nq, d), generator=gen, device=dev) - 0.5
    k = (torch.rand((b, hkv, nk, d), generator=gen, device=dev)
         - 0.5).bfloat16()
    v = (torch.rand((b, hkv, nk, d), generator=gen, device=dev)
         - 0.5).bfloat16()
    ctx.zero_counts()
    o, lse = flash_attention_forward(q, k, v, causal=True)
    torch.cuda.synchronize()
    forms = dict(ctx.fwd_forms)
    o_p, lse_p = flash_attention_forward_plain(q, k, v, causal=True)
    e = max(ctx.diff(o, o_p), ctx.diff(lse, lse_p))
    print(f"[f32-over-bf16] flash_attention_forward on an fp32 Q over bf16 "
          f"K/V, [{b}, {h}, {nq}, {d}] causal: launches {forms} (expect "
          f"kmajor 1, fallback 1); max|diff| vs plain {e:.3e} (gate "
          f"{F32_GATE}) ({card})", flush=True)
    _check(forms == dict(online=0, bound=0, kmajor=1, fallback=1)
           and e <= F32_GATE and o.dtype == torch.float32,
           f"fp32 Q over bf16 K/V through K5: {forms}, {e:.3e}")
    ctx.launches["K5 fp32 Q over bf16"] += forms["kmajor"]
    ctx.launches["K1 fp32 Q over bf16"] += forms["fallback"]
    del q, k, v, o, o_p

    # the paged run over bf16 pools under an fp32 q
    b, hkv, h, d = BATCH, cfg.n_kv_heads, cfg.n_heads, cfg.d_head
    total = PAGED_PREFILL + F32BF16_PAGED_STEPS
    k_all = torch.rand((b, hkv, total, d), generator=gen, device=dev) - 0.5
    v_all = torch.rand((b, hkv, total, d), generator=gen, device=dev) - 0.5
    cache = init_paged_cache(N_PAGES, b, MAX_PAGES, hkv, PAGE, d,
                             dtype=torch.bfloat16, device=dev)
    alloc = PageAllocator(N_PAGES)
    shadow = init_cache(b, hkv, MAX_PAGES * PAGE, d, dtype=torch.bfloat16,
                        device=dev)
    for i in range(b):
        alloc.reserve_for(cache, i, PAGED_PREFILL)
    paged_bulk_append(cache, k_all[:, :, :PAGED_PREFILL],
                      v_all[:, :, :PAGED_PREFILL])
    cache_append(shadow, k_all[:, :, :PAGED_PREFILL],
                 v_all[:, :, :PAGED_PREFILL])
    _check(cache.k_pages.dtype == torch.bfloat16, "the pools are not bf16")
    ctx.zero_counts()
    n_k7, e_plain = 0, None
    for t in range(F32BF16_PAGED_STEPS):
        at = PAGED_PREFILL + t
        for i in range(b):
            alloc.reserve_for(cache, i, 1)
        paged_append(cache, k_all[:, :, at], v_all[:, :, at])
        cache_append(shadow, k_all[:, :, at:at + 1], v_all[:, :, at:at + 1])
        q = (torch.rand((b, h, d), generator=gen, device=dev) - 0.5) * Q_PEAK
        o, lse = paged_decode_step(q, cache)
        n_k7 = paged_decode_attention.launches
        lengths = torch.full((b,), at + 1, dtype=torch.int32, device=dev)
        o_c, lse_c = decode_attention(q, shadow.k, shadow.v, lengths)
        torch.cuda.synchronize()
        _check(bool(torch.equal(o, o_c) and torch.equal(lse, lse_c)),
               f"paged step {t} over bf16 pools: not bit for bit K6's")
        if t == F32BF16_PAGED_STEPS - 1:
            o_p, lse_p = paged_decode_attention_plain(
                q, cache.k_pages, cache.v_pages, cache.page_table,
                cache.lengths)
            e_plain = max(ctx.diff(o, o_p), ctx.diff(lse, lse_p))
            _check(e_plain <= F32_GATE, f"paged over bf16 pools vs plain "
                   f"{e_plain:.3e}")
    free_before = len(alloc.free)
    alloc.release_sequence(cache, 3)
    freed = len(alloc.free) - free_before
    alloc.reserve_for(cache, 3, PAGE)
    paged_append(cache, k_all[:, :, 0], v_all[:, :, 0])
    o, _ = paged_decode_step(q, cache)
    torch.cuda.synchronize()
    n_k7 = paged_decode_attention.launches
    print(f"[f32-over-bf16] paged run: bf16 pools of {N_PAGES} pages x "
          f"{PAGE} tokens, B={b} x {PAGED_PREFILL} fp32 K/V tokens, "
          f"{F32BF16_PAGED_STEPS} fp32-q decode steps bit for bit K6's on "
          f"the shadow, last step vs plain {e_plain:.3e} (gate {F32_GATE}); "
          f"retired sequence 3: {freed} pages back; K7 launches {n_k7} "
          f"({card})", flush=True)
    _check(n_k7 == F32BF16_PAGED_STEPS + 1 and freed == -(
        -(PAGED_PREFILL + F32BF16_PAGED_STEPS) // PAGE) and bool(
            torch.isfinite(o).all()),
           f"paged run: K7 {n_k7}, {freed} pages freed")
    ctx.launches["K7 fp32 q over bf16"] += n_k7
    del cache, shadow, alloc, k_all, v_all


# ---------------------------------------------------------------------------
# Wide heads (phases 25-26): the d = 256 builds of K1, K1b, K5, K6 and K7,
# decode at widths between the builds, and a model of Gemma 2 2B's widths
# (google/gemma-2-2b, config.json: hidden_size 2304, 8 heads over 4 KV
# heads, head_dim 256, intermediate_size 9216, vocab 256000, 26 layers) on
# the repo's block (RMSNorm + RoPE + SwiGLU), seeded weights
# ---------------------------------------------------------------------------

GEMMA_KW = dict(vocab_size=256000, d_model=2304, n_layers=26, n_heads=8,
                n_kv_heads=4, d_head=256, d_ff=9216, max_seq=8192)
# decode at widths between the builds (bf16 and int8 caches, read in place)
ANY_WIDTHS = (8, 48, 80, 96, 100, 200, 256)  # 100: element loads
# greedy decode steps after the chunked prefill; steps of the paged loop
GEMMA_CHUNK_NEW, GEMMA_PAGED_STEPS = 32, 32


def _phase_wide_kernels(ctx):
    """The d = 256 builds against their plain versions at the Gemma-width
    model's attention shapes (8 query heads over 4 KV heads, d 256), bf16
    gates (5e-3, O also within 2e-2 · max |plain O| on peaked inputs):
    K1 (online), K1b and K5 (pinned, K5 within 1e-4 of K1b) at the
    serving prefill (B=8, 512 causal), a ragged 500-row prefill, the
    chunked prefill's prefix (512 rows over 3584 keys), its windowed
    slice (512 over 1024, window 1024, kv_offset 1024) and a ragged GQA
    prefix (300 over 2999, causal, kv_offset 2699), over bf16, int8, fp8
    and mixed K/V, each quantized pair with and without `quantize_q`; K1
    under segment ids. Each form's ms at the prefill and the prefix
    (torch.profiler). K6 and K7 (128-token pages, bit for bit K6's) at
    B=8 with 4224 live tokens of a 4352-token cache over every cache: a
    bf16 q over bf16, int8, fp8 and mixed (`quantize_q` on int8 and
    mixed), an fp32 q over fp32, bf16 and int8 (1e-4). K6 at d in
    ANY_WIDTHS over bf16 and int8 caches, the cache read in place: the
    peak allocation of a call stays below the cache's bytes. The forward
    at d = 96 and 200 at the prefix, on zero-padded copies: the call
    against the next build's width, and the copies alone. Rows K1 / K1b
    / K5 / K6 / K7 d256: kernel ms, bound, plain ms, and SDPA on the same
    (dequantised) inputs."""
    torch = ctx.torch
    F = torch.nn.functional
    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.ops.decode import (
        decode_attention, decode_attention_plain)
    from cuda_flashattention_torch.ops.paged import (
        paged_decode_attention, paged_decode_attention_plain)
    from cuda_flashattention_torch.ops.quant import quantize_kv
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    dev, card = ctx.dev, ctx.card
    h, hkv, d = (GEMMA_KW["n_heads"], GEMMA_KW["n_kv_heads"],
                 GEMMA_KW["d_head"])
    gen = torch.Generator(device=dev).manual_seed(25)

    def u(*shape, peak=1.0, dtype=torch.bfloat16):
        return ((torch.rand(shape, generator=gen, device=dev) - 0.5)
                * peak).to(dtype)

    def stored(k, v, qtype):
        """(k, v, scales, dequantised k, v) as a cache of `qtype` holds
        them."""
        if qtype is None:
            return k, v, {}, k, v
        kv = quantize_kv(k, v, qtype)
        sc = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
        kd = (kv.k_q.float() * kv.k_scale[..., None]).to(k.dtype)
        vd = (kv.v_q.float() * kv.v_scale[..., None]).to(v.dtype)
        return kv.k_q, kv.v_q, sc, kd, vd

    def form_calls(form, q, k, v, sc, kw, qq):
        """(kernel call, plain call) of one forward form: online (K1), or
        K1b / K5 pinned through `_plan` + `_fwd_cuda` (no guarded
        fallback); fp32 O."""
        if form == "online":
            args = dict(softmax="online", out_dtype=torch.float32, **kw,
                        **sc)
            return (lambda: ff.flash_attention_forward(q, k, v, **args),
                    lambda: ff.flash_attention_forward_plain(q, k, v,
                                                             **args))
        plan = ff._plan(q, k, v, None, kw.get("causal", False),
                        kw.get("window", 0), kw.get("kv_offset", 0), None,
                        sc.get("k_scale"), sc.get("v_scale"), None, None,
                        "bound_unchecked", qq)
        plan = dataclasses.replace(plan, use_kmajor=form == "kmajor")
        return (lambda: ff._fwd_cuda(q, k, v, plan, torch.float32,
                                     sc.get("k_scale"), sc.get("v_scale"),
                                     None, None),
                lambda: ff.flash_attention_forward_plain(
                    q, k, v, softmax="bound_unchecked", quantize_q=qq,
                    out_dtype=torch.float32, **kw, **sc))

    def close(got, want, what):
        (o, lse), (o_p, lse_p) = got, want
        e_o, ref, ok = ctx.o_close(o, o_p)
        e_l = ctx.diff(lse, lse_p)
        _check(ok and e_l <= GATE and bool(torch.isfinite(o).all()),
               f"{what}: max|dO| {e_o:.3e} (max|O| {ref:.3e}) max|dLSE| "
               f"{e_l:.3e}")
        return max(e_o, e_l)

    kernel_of = {"online": "K1", "bound": "K1b", "kmajor": "K5"}
    cases = [
        ("prefill 512 causal", BATCH, 512, 512, dict(causal=True)),
        ("ragged 500 causal", BATCH, 500, 500, dict(causal=True)),
        ("prefix 512x3584", BATCH, 512, 3584, {}),
        ("windowed prefix 512x1024", BATCH, 512, 1024,
         dict(causal=True, window=LONG_WINDOW, kv_offset=LONG_WINDOW)),
        ("ragged GQA prefix 300x2999", 2, 300, 2999,
         dict(causal=True, kv_offset=2699)),
    ]
    # the rows of the kernels line: each kernel where the main path
    # runs it (K5: the fp8 cache's prefix reads)
    rows = {("K1", "prefill 512 causal", None),
            ("K1b", "prefix 512x3584", None),
            ("K5", "prefix 512x3584", "fp8")}
    timed = ("prefill 512 causal", "prefix 512x3584")
    for name, b, nq, nk, kw in cases:
        q = u(b, h, nq, d, peak=Q_PEAK)
        k0, v0 = u(b, hkv, nk, d, peak=K_PEAK), u(b, hkv, nk, d)
        flops = 4.0 * _visible_pairs(ctx, b, h, nq, nk, kw) * d
        line = []
        for qtype in (None, "int8", "fp8", "mixed"):
            k, v, sc, kd, vd = stored(k0, v0, qtype)
            lib_ms = (_library_ms(ctx, q, kd, vd, kw) if name in timed
                      else float("nan"))
            bound = _bound(_nbytes(q, k, v, *sc.values())
                           + b * h * nq * (4 * d + 4), flops)
            for qq in ((False, True) if qtype else (False,)):
                got = {}
                for form in ("online", "bound", "kmajor"):
                    if qq and form == "online":
                        continue  # quantize_q is a bound form's
                    kn = kernel_of[form]
                    call, plain = form_calls(form, q, k, v, sc, kw, qq)
                    got[form] = call()
                    torch.cuda.synchronize()
                    want = plain()
                    what = (f"{kn} d=256 {name} over {qtype or 'bf16'}"
                            + (" quantize_q" if qq else ""))
                    e = close(got[form], want, what)
                    r = ctx.rec[f"{kn} d256"]
                    r["max_abs_err"] = max(r["max_abs_err"], e)
                    if name not in timed:
                        continue
                    ms = _call_ms(call, kn)
                    line.append(f"{kn}{' qq' if qq else ''} "
                                f"{qtype or 'bf16'} {ms:.4f}")
                    if kn != "K1" and name == "prefix 512x3584":
                        # K1b and K5 over every K/V form: one-byte K/V
                        # converted before the walk, K5 on K1b's walk
                        print(f"[wide] {kn} d=256 {name} over "
                              f"{qtype or 'bf16'}"
                              + (" quantize_q" if qq else "")
                              + f": kernel {ms:.4f} ms ("
                              f"{100 * bound['bound_ms'] / ms:.1f}% of its "
                              f"bound {bound['bound_ms']:.4f} ms), SDPA"
                              + (" on the dequantised K/V" if qtype else "")
                              + f" {lib_ms:.4f} ms ({card})", flush=True)
                    if (kn, name, qtype) in rows and not qq:
                        ms_p = cuda_time_ms(plain, iters=2, warmup=1)
                        r.update(ms=ms, plain_ms=ms_p, library_ms=lib_ms,
                                 **bound)
                        print(f"[wide] {kn} d=256 {name} over "
                              f"{qtype or 'bf16'}: B={b} H={h} Hkv={hkv} "
                              f"max|diff| {e:.3e}; kernel {ms:.4f} ms "
                              f"({100 * bound['bound_ms'] / ms:.1f}% of its "
                              f"bound {bound['bound_ms']:.4f} ms, "
                              f"{bound['bound_by']}), library (SDPA"
                              + (" on the dequantised K/V" if qtype else "")
                              + f") {lib_ms:.4f} ms, plain {ms_p:.4f} ms "
                              f"({card})", flush=True)
                e_k = max(ctx.diff(got["kmajor"][0], got["bound"][0]),
                          ctx.diff(got["kmajor"][1], got["bound"][1]))
                _check(e_k <= 1e-4, f"K5 vs K1b d=256 {name} {qtype}: "
                       f"{e_k:.3e}")
        print(f"[wide] d=256 {name}: K1, K1b and K5 within the bf16 gates "
              f"over bf16, int8, fp8 and mixed K/V (quantize_q on each "
              f"quantized pair), K5 within 1e-4 of K1b"
              + (f"; kernel ms: {', '.join(line)}" if line else "")
              + f" ({card})", flush=True)
        del q, k0, v0, k, v, sc, kd, vd, got

    # a d between builds runs on zero-padded copies of Q, K and V: what
    # the copy costs a call at the chunked prefill's prefix read
    from cuda_flashattention_torch.ops.common import pad_heads, run_dim
    for dw in (96, 200):
        dn = run_dim(dw)
        calls = {}
        for width in (dw, dn):
            q = u(BATCH, h, 512, width, peak=Q_PEAK)
            k, v = u(BATCH, hkv, 3584, width, peak=K_PEAK), u(BATCH, hkv,
                                                               3584, width)
            calls[width] = cuda_time_ms(
                lambda: ff.flash_attention_forward(q, k, v,
                                                   out_dtype=torch.float32),
                iters=10)
            if width == dw:
                pad_ms = cuda_time_ms(lambda: pad_heads("forward", q, k, v),
                                      iters=10)
                pad_mb = (_nbytes(q, k, v) * (dn / dw + 1)) / 1e6
        print(f"[wide] d={dw} on the d={dn} build (zero-padded copies), "
              f"prefix 512x3584 B={BATCH} H={h} Hkv={hkv}: the call "
              f"{calls[dw]:.4f} ms against {calls[dn]:.4f} ms at d={dn}; "
              f"the copies alone {pad_ms:.4f} ms ({pad_mb:.1f} MB read and "
              f"written) ({card})", flush=True)
        del q, k, v

    # K1 under segment ids (its SEG build at d = 256)
    b, n = 2, 1024
    ids = torch.repeat_interleave(
        torch.arange(4, device=dev),
        torch.tensor([300, 1, 500, 223], device=dev))[None].expand(
            b, n).contiguous()
    q, k, v = (u(b, h, n, d, peak=Q_PEAK), u(b, hkv, n, d, peak=K_PEAK),
               u(b, hkv, n, d))
    for causal in (True, False):
        kw = dict(causal=causal, q_segment_ids=ids, kv_segment_ids=ids,
                  out_dtype=torch.float32)
        got = ff.flash_attention_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        e = close(got, ff.flash_attention_forward_plain(q, k, v, **kw),
                  f"K1 d=256 segment ids causal={causal}")
        ctx.rec["K1 d256"]["max_abs_err"] = max(
            ctx.rec["K1 d256"]["max_abs_err"], e)
    print(f"[wide] K1 d=256 under segment ids (B={b}, N={n}, segments 300, "
          f"1, 500, 223), causal and not: within the bf16 gates ({card})",
          flush=True)
    del q, k, v, got

    # K6 and K7 at d = 256 over every cache
    b = BATCH
    lens = torch.full((b,), DEC_LIVE, dtype=torch.int32, device=dev)
    live = torch.arange(DEC_CAP, device=dev)[None, :] < lens[:, None]
    n_pages = DEC_CAP // PAGE
    order = torch.randperm(b * n_pages, generator=gen, device=dev)
    table = order.view(b, n_pages).to(torch.int32)

    def paged(x):
        """The cache [B, Hkv, N, ...] as PAGE-token pages behind `table`."""
        pages = x.view(b, hkv, n_pages, PAGE, *x.shape[3:]).transpose(
            1, 2).reshape(b * n_pages, hkv, PAGE, *x.shape[3:])
        pool = torch.empty_like(pages)
        pool[order] = pages
        return pool

    dec_rows = [(torch.bfloat16, None, None, False),
                (torch.bfloat16, "int8", None, False),
                (torch.bfloat16, "int8", None, True),
                (torch.bfloat16, "fp8", None, False),
                (torch.bfloat16, "mixed", None, False),
                (torch.bfloat16, "mixed", None, True),
                (torch.float32, None, torch.float32, False),
                (torch.float32, None, torch.bfloat16, False),
                (torch.float32, "int8", None, False)]
    for qdt, qtype, cdt, qq in dec_rows:
        q = u(b, h, d, peak=Q_PEAK, dtype=qdt)
        kc = u(b, hkv, DEC_CAP, d, peak=K_PEAK, dtype=cdt or qdt)
        vc = u(b, hkv, DEC_CAP, d, dtype=cdt or qdt)
        k, v, sc, kd, vd = stored(kc, vc, qtype)
        extra = dict(quantize_q=True) if qq else {}
        f32 = qdt == torch.float32 and not qq
        gate = F32_GATE if f32 else GATE
        errs = {}
        o, lse = decode_attention(q, k, v, lens, **sc, **extra)
        torch.cuda.synchronize()
        o_p, lse_p = decode_attention_plain(q, k, v, lens, **sc, **extra)
        errs["K6"] = max(ctx.diff(o, o_p), ctx.diff(lse, lse_p))
        pk, pv = paged(k), paged(v)
        psc = {n_: paged(x) for n_, x in sc.items()}
        o7, lse7 = paged_decode_attention(q, pk, pv, table, lens, **psc,
                                          **extra)
        torch.cuda.synchronize()
        o7p, lse7p = paged_decode_attention_plain(q, pk, pv, table, lens,
                                                  **psc, **extra)
        errs["K7"] = max(ctx.diff(o7, o7p), ctx.diff(lse7, lse7p))
        top = o_p.float().abs().max().item()
        what = (f"d=256 decode, {qdt} q over a "
                f"{qtype or (cdt or qdt)} cache" + (" quantize_q" if qq
                                                     else ""))
        _check(top > 0 and max(errs.values()) <= gate
               and (f32 or ctx.diff(o, o_p) <= REL_GATE * top),
               f"{what}: max|diff| {errs}, max|O| {top:.3e}")
        _check(bool(torch.equal(o7, o) and torch.equal(lse7, lse)),
               f"{what}: K7 not bit for bit K6's")
        for kn in ("K6", "K7"):
            r = ctx.rec[f"{kn} d256"]
            r["max_abs_err"] = max(r["max_abs_err"], errs[kn])
        line = ""
        if qdt == torch.bfloat16 and qtype is None:
            tokens = b * hkv * DEC_LIVE
            for kn, call, plain in (
                    ("K6", lambda: decode_attention(q, k, v, lens),
                     lambda: decode_attention_plain(q, k, v, lens)),
                    ("K7", lambda: paged_decode_attention(q, pk, pv, table,
                                                          lens),
                     lambda: paged_decode_attention_plain(q, pk, pv, table,
                                                          lens))):
                ms = _call_ms(call, kn, iters=5, before=ctx.l2_flush.zero_)
                ms_p = cuda_time_ms(plain, iters=3,
                                    before=ctx.l2_flush.zero_)
                lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=live[:, None, None, :],
                    enable_gqa=True), before=ctx.l2_flush.zero_)
                nbytes = (2 * _nbytes(q) + b * (h + 1) * 4
                          + tokens * d * 4
                          + (b * n_pages * 4 if kn == "K7" else 0))
                bound = _bound(nbytes, 4.0 * h * d * DEC_LIVE * b)
                ctx.rec[f"{kn} d256"].update(ms=ms, plain_ms=ms_p,
                                             library_ms=lib_ms, **bound)
                line += (f"; {kn} {ms:.4f} ms cold ("
                         f"{100 * bound['bound_ms'] / ms:.1f}% of its bound "
                         f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}), "
                         f"library {lib_ms:.4f} ms, plain {ms_p:.4f} ms")
        print(f"[wide] {what}: B={b} H={h} Hkv={hkv} {DEC_LIVE} live of "
              f"{DEC_CAP}; max|diff| K6 {errs['K6']:.3e} K7 "
              f"{errs['K7']:.3e} (gate {gate}); K7 bit for bit K6's"
              f"{line} ({card})", flush=True)
        del q, kc, vc, k, v, sc, kd, vd, pk, pv, psc

    # K6 at widths between its builds, the cache read as it lies
    for dw in ANY_WIDTHS:
        for qtype in (None, "int8"):
            q = u(b, h, dw, peak=Q_PEAK)
            k, v, sc, _, _ = stored(u(b, hkv, DEC_CAP, dw, peak=K_PEAK),
                                    u(b, hkv, DEC_CAP, dw), qtype)
            cache_bytes = _nbytes(k, v, *sc.values())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            o, lse = decode_attention(q, k, v, lens, **sc)
            torch.cuda.synchronize()
            grown = torch.cuda.max_memory_allocated() - base
            o_p, lse_p = decode_attention_plain(q, k, v, lens, **sc)
            e_o, ref, ok = ctx.o_close(o, o_p)
            e_l = ctx.diff(lse, lse_p)
            ms = _call_ms(lambda: decode_attention(q, k, v, lens, **sc),
                          "K6", iters=5, before=ctx.l2_flush.zero_)
            print(f"[wide] K6 d={dw} over a {qtype or 'bf16'} cache "
                  f"[{b}, {hkv}, {DEC_CAP}, {dw}], {DEC_LIVE} live: "
                  f"max|dO| {e_o:.3e} (max|O| {ref:.3e}) max|dLSE| "
                  f"{e_l:.3e}; the call's peak allocation {grown} B < the "
                  f"cache's {cache_bytes} B; kernel {ms:.4f} ms cold "
                  f"({card})", flush=True)
            _check(ok and e_l <= GATE and o.shape == q.shape,
                   f"K6 d={dw} {qtype}: dO {e_o:.3e} dLSE {e_l:.3e}")
            _check(grown < cache_bytes, f"K6 d={dw} {qtype}: the call "
                   f"allocated {grown} B, the cache is {cache_bytes} B")
            del q, k, v, sc, o, lse, o_p, lse_p


def _phase_gemma_serving(ctx):
    """Main path of serving at Gemma 2 2B's widths (GEMMA_KW: 26 layers,
    d_model 2304, 8 query heads over 4 KV heads of d_head 256, d_ff 9216,
    vocab 256000, bf16; weights from a seeded generator, nothing
    downloaded). `generate()`: B=8 prompts of 512 tokens, 128 greedy
    tokens, over a bf16 and an int8 cache: K1 (its d = 256 build) once
    per layer, K6 once per layer and token; the bf16 run's tokens against
    the same model on the plain attention functions (equal, or departing
    only where the plain run's two best logits lie within LOGIT_GATE),
    its prefill logits within LOGIT_GATE of the plain path's, the int8
    cache replayed on the bf16 run's tokens within QUANT_LOGIT_GATE of its
    last-step logits. `prefill_chunked(chunk=512)`: B=8 prompts of 4096
    tokens, then 32 greedy steps, over bf16, int8 and fp8 caches and, with
    `cfg.window` = 1024, an int8 cache: per form launches (own chunks K1
    8 · 26; the prefix reads K1b over bf16 and int8, K5 over fp8 and under
    the window, 7 · 26, each behind its guarded K1; K6 32 · 26), the last
    chunk's logits within LOGIT_GATE of the run on the plain attention
    functions and, without a window, within LOGIT_GATE / QUANT_LOGIT_GATE
    / FP8_LOGIT_GATE of a whole-prompt `prefill` over a bf16 cache; the
    greedy tokens against the plain run's. The paged loop at the model's
    attention shape: bf16 and int8 pools of 4096 pages of 128 tokens, B=8
    sequences of 4096 tokens through `reserve_for` + `paged_bulk_append`,
    32 steps of `reserve_for` + `paged_append` + `paged_decode_step`
    (K7), each bit for bit K6's on a contiguous shadow and the last within
    the gates of the plain version; a sequence retires and its pages
    serve a new one. Prefill ms, decode tok/s, chunked-prefill ms and
    paged step ms once each. No depth or width is cut."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.models.generate import generate
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.kv_cache import (
        append as cache_append, init_cache)
    from cuda_flashattention_torch.ops.paged import (
        PageAllocator, init_paged_cache, paged_append, paged_bulk_append,
        paged_decode_attention, paged_decode_attention_plain,
        paged_decode_step)
    dev, card = ctx.dev, ctx.card
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **GEMMA_KW)
    n_layers = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(26)
    model = tfm.Transformer(cfg, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    print(f"[gemma] {n_params / 1e9:.3f}B parameters "
          f"({_nbytes(*model.parameters()) / 2**30:.2f} GiB in bf16): "
          f"vocab {cfg.vocab_size}, d_model {cfg.d_model}, {n_layers} "
          f"layers, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
          f"d_head {cfg.d_head}, d_ff {cfg.d_ff} ({card})", flush=True)
    generate(model, prompt, 2)  # warm-up
    torch.cuda.synchronize()

    def departure(toks, toks_p, logits_at):
        """'' when the token rows agree, else where they first part and
        whether the plain run's two best logits there lie within
        LOGIT_GATE (a tie that rounding may break either way)."""
        if torch.equal(toks, toks_p):
            return "", True
        step = int((toks != toks_p).any(0).nonzero()[0])
        at = logits_at(step)
        rows = toks[:, step] != toks_p[:, step]
        best = at[rows].float().topk(2, dim=-1).values
        gap = (best[:, 0] - best[:, 1]).max().item()
        return (f" (first departure at token {step}, where the plain run's "
                f"two best logits lie {gap:.3e} apart)",
                gap <= LOGIT_GATE)

    def count(kn, n):
        ctx.launches[kn] += n
        ctx.launches[f"{kn} d256"] += n

    # ---- generate(): bf16 and int8 caches
    caches = tfm.init_caches(cfg, BATCH, PROMPT + NEW, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg_k, _ = tfm.prefill(model, prompt, caches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    with _serving_on_plain_attention():
        caches = tfm.init_caches(cfg, BATCH, PROMPT + NEW, device=dev)
        lg_p, _ = tfm.prefill(model, prompt, caches)
    e_prefill = ctx.diff(lg_k, lg_p)
    del caches
    runs = {}
    for label, qtype in (("bf16 cache", None), ("int8 cache", "int8")):
        ctx.zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, logits = generate(model, prompt, NEW, qtype=qtype)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fwd, n_dec = ctx.fwd_forms["online"], decode_attention.launches
        _check(n_fwd == n_layers and n_dec == n_layers * NEW
               and sum(ctx.fwd_forms.values()) == n_fwd,
               f"gemma generate {label}: launches {ctx.fwd_forms}, K6 "
               f"{n_dec}")
        _check(tuple(out.shape) == (BATCH, PROMPT + NEW)
               and bool(((out >= 0) & (out < cfg.vocab_size)).all())
               and bool(torch.isfinite(logits).all()),
               f"gemma generate {label}: tokens or logits")
        count("K1", n_fwd)
        count("K6", n_dec)
        runs[label] = (out, logits)
        print(f"[gemma] generate {label}: B={BATCH} prompt={PROMPT} "
              f"new={NEW}: launches K1 {n_fwd} (expect {n_layers}), K6 "
              f"{n_dec} (expect {n_layers * NEW}); {wall:.3f} s, prefill "
              f"{prefill_s * 1e3:.3f} ms (bf16 cache, timed alone), decode "
              f"{BATCH * NEW / (wall - prefill_s):.1f} tok/s (the run's "
              f"time less that prefill) ({card})", flush=True)
    out, logits = runs["bf16 cache"]
    with _serving_on_plain_attention():
        out_p, logits_p = generate(model, prompt, NEW)
    steps_p = {}

    def plain_logits_at(step):
        """The plain run's logits before new token `step`."""
        if step == 0:
            return lg_p
        if not steps_p:
            with _serving_on_plain_attention():
                c = tfm.init_caches(cfg, BATCH, PROMPT + NEW, device=dev)
                _, c = tfm.prefill(model, prompt, c)
                for i in range(NEW - 1):
                    lg, c = tfm.decode_one(model, out_p[:, PROMPT + i],
                                           PROMPT + i, c)
                    steps_p[i + 1] = lg
        return steps_p[step]

    dep, tie_ok = departure(out[:, PROMPT:], out_p[:, PROMPT:],
                            plain_logits_at)
    e_last = ctx.diff(logits, logits_p) if not dep else float("nan")
    caches = tfm.init_caches(cfg, BATCH, PROMPT + NEW, qtype="int8",
                             device=dev)
    lg8, caches = tfm.prefill(model, prompt, caches)
    for i in range(NEW):
        lg8, caches = tfm.decode_one(model, out[:, PROMPT + i], PROMPT + i,
                                     caches)
    e8 = ctx.diff(lg8, logits)
    del caches
    same = (out == out_p).float().mean().item()
    same8 = (runs["int8 cache"][0] == out).float().mean().item()
    print(f"[gemma] generate vs the plain attention functions: prefill "
          f"logits max|d| {e_prefill:.3e} (gate {LOGIT_GATE}); bf16 "
          f"cache's tokens equal {same:.4f}{dep}; last-step logits max|d| "
          f"{e_last:.3e}; the int8 cache on the bf16 run's tokens: "
          f"last-step logits max|d| {e8:.3e} (gate {QUANT_LOGIT_GATE}); "
          f"the int8 run's free greedy tokens equal to the bf16 run's "
          f"{same8:.4f} ({card})", flush=True)
    _check(e_prefill <= LOGIT_GATE, f"gemma prefill logits {e_prefill:.3e}")
    _check(tie_ok, f"gemma generate: tokens depart from the plain run{dep}")
    _check(dep or e_last <= LOGIT_GATE, f"gemma last logits {e_last:.3e}")
    _check(e8 <= QUANT_LOGIT_GATE, f"gemma int8-cache logits {e8:.3e}")
    del runs, out, out_p, logits, logits_p, lg8, steps_p

    # ---- prefill_chunked(chunk=512) + greedy steps
    new, n_chunks = GEMMA_CHUNK_NEW, LONG_PROMPT // LONG_CHUNK
    own, n_prefix = n_chunks * n_layers, (n_chunks - 1) * n_layers
    long_prompt = torch.randint(0, cfg.vocab_size, (BATCH, LONG_PROMPT),
                                generator=gen, device=dev, dtype=torch.int32)

    def serve(m, qtype):
        """(last-chunk logits, tokens [B, 1 + new], each step's logits,
        prefill s, decode s)"""
        c = tfm.init_caches(m.cfg, BATCH, LONG_PROMPT + new, qtype=qtype,
                            device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, c = tfm.prefill_chunked(m, long_prompt, c, chunk=LONG_CHUNK)
        torch.cuda.synchronize()
        p_s = time.perf_counter() - t0
        tok = torch.argmax(lg, dim=-1).to(long_prompt.dtype)
        toks, steps = [tok], []
        t0 = time.perf_counter()
        for i in range(new):
            lg_dec, c = tfm.decode_one(m, tok, LONG_PROMPT + i, c)
            tok = torch.argmax(lg_dec, dim=-1).to(long_prompt.dtype)
            toks.append(tok)
            steps.append(lg_dec)
        torch.cuda.synchronize()
        return lg, torch.stack(toks, 1), steps, p_s, time.perf_counter() - t0

    serve(model, None)  # warm-up
    c = tfm.init_caches(cfg, BATCH, LONG_PROMPT, device=dev)
    lg_whole, c = tfm.prefill(model, long_prompt, c)
    del c
    whole_gate = {None: LOGIT_GATE, "int8": QUANT_LOGIT_GATE,
                  "fp8": FP8_LOGIT_GATE}
    chunk_s = None
    for label, qtype, window in (("bf16 cache", None, 0),
                                 ("int8 cache", "int8", 0),
                                 ("fp8 cache", "fp8", 0),
                                 ("int8 cache, window 1024", "int8",
                                  LONG_WINDOW)):
        m = _windowed(model, window) if window else model
        ctx.zero_counts()
        lg, toks, steps, p_s, d_s = serve(m, qtype)
        counts, n_dec = dict(ctx.fwd_forms), decode_attention.launches
        # the prefix reads: K1b over bf16 and int8 caches, K5 over fp8 and
        # under the window (a causal quantized read), each checked
        prefix_form = "kmajor" if qtype == "fp8" or window else "bound"
        expect = dict(online=own, bound=0, kmajor=0, fallback=n_prefix)
        expect[prefix_form] = n_prefix
        with _serving_on_plain_attention():
            lg_p, toks_p, steps_p, _, _ = serve(m, qtype)
        e_lg = ctx.diff(lg, lg_p)
        dep, tie_ok = departure(
            toks, toks_p, lambda s: lg_p if s == 0 else steps_p[s - 1])
        e_whole = float("nan") if window else ctx.diff(lg, lg_whole)
        if chunk_s is None:
            chunk_s = p_s
        print(f"[gemma] prefill_chunked {label}: B={BATCH} x {LONG_PROMPT} "
              f"tokens in chunks of {LONG_CHUNK}, then {new} greedy steps: "
              f"launches {counts} (expect {expect}), K6 {n_dec} (expect "
              f"{n_layers * new}); last-chunk logits vs plain attention "
              f"max|d| {e_lg:.3e} (gate {LOGIT_GATE}), vs whole-prompt "
              f"prefill over bf16 {e_whole:.3e} (gate "
              f"{whole_gate[qtype]}); greedy tokens equal to the plain "
              f"run's {(toks == toks_p).float().mean().item():.4f}{dep}; "
              f"chunked prefill {p_s * 1e3:.3f} ms "
              f"({BATCH * LONG_PROMPT / p_s:.0f} prompt tok/s), decode "
              f"{d_s / new * 1e3:.3f} ms/step ({card})", flush=True)
        _check(counts == expect and n_dec == n_layers * new,
               f"gemma chunked {label}: launches {counts}, K6 {n_dec}")
        _check(bool(torch.isfinite(lg).all()) and e_lg <= LOGIT_GATE,
               f"gemma chunked {label}: logits vs plain {e_lg:.3e}")
        _check(window or e_whole <= whole_gate[qtype],
               f"gemma chunked {label}: vs whole prefill {e_whole:.3e}")
        _check(tie_ok, f"gemma chunked {label}: tokens depart from the "
               f"plain run{dep}")
        count("K1", counts["online"])
        count("K1b", counts["bound"])
        count("K5", counts["kmajor"])
        count("K6", n_dec)
        del lg_p, steps_p, steps
    del lg_whole

    # ---- the paged loop at the model's attention shape
    b, h, hkv, d = BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    steps = GEMMA_PAGED_STEPS
    total = PAGED_PREFILL + steps
    k_all = ctx.mk(b, hkv, total, d)
    v_all = ctx.mk(b, hkv, total, d)
    step_ms = None
    for label, qtype in (("bf16 pools", None), ("int8 pools", "int8")):
        cache = init_paged_cache(N_PAGES, b, MAX_PAGES, hkv, PAGE, d,
                                 qtype=qtype, device=dev)
        alloc = PageAllocator(N_PAGES)
        shadow = init_cache(b, hkv, MAX_PAGES * PAGE, d, qtype=qtype,
                            device=dev)
        for i in range(b):
            alloc.reserve_for(cache, i, PAGED_PREFILL)
        paged_bulk_append(cache, k_all[:, :, :PAGED_PREFILL],
                          v_all[:, :, :PAGED_PREFILL])
        cache_append(shadow, k_all[:, :, :PAGED_PREFILL],
                     v_all[:, :, :PAGED_PREFILL])
        ctx.zero_counts()
        times, e_plain = [], None
        for t in range(steps):
            at = PAGED_PREFILL + t
            for i in range(b):
                alloc.reserve_for(cache, i, 1)
            paged_append(cache, k_all[:, :, at], v_all[:, :, at])
            cache_append(shadow, k_all[:, :, at:at + 1],
                         v_all[:, :, at:at + 1])
            q = ctx.mk(b, h, d, peak=Q_PEAK * K_PEAK)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            o, lse = paged_decode_step(q, cache)
            e1.record()
            n_k7 = paged_decode_attention.launches
            o_c, lse_c = decode_attention(
                q, shadow.k, shadow.v, cache.lengths,
                k_scale=shadow.k_scale, v_scale=shadow.v_scale)
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
            _check(bool(torch.equal(o, o_c) and torch.equal(lse, lse_c)),
                   f"gemma paged {label} step {t}: not bit for bit K6's")
        o_p, lse_p = paged_decode_attention_plain(
            q, cache.k_pages, cache.v_pages, cache.page_table,
            cache.lengths, k_scale=cache.k_scale, v_scale=cache.v_scale)
        (e_o, ref, ok), e_l = ctx.o_close(o, o_p), ctx.diff(lse, lse_p)
        _check(ok and e_l <= GATE, f"gemma paged {label}: dO {e_o:.3e} "
               f"(max|O| {ref:.3e}) dLSE {e_l:.3e}")
        free_before = len(alloc.free)
        alloc.release_sequence(cache, 3)
        freed = len(alloc.free) - free_before
        alloc.reserve_for(cache, 3, PAGE)
        paged_append(cache, k_all[:, :, 0], v_all[:, :, 0])
        o, _ = paged_decode_step(q, cache)
        torch.cuda.synchronize()
        n_k7 = paged_decode_attention.launches
        _check(n_k7 == steps + 1 and freed == -(-total // PAGE)
               and bool(torch.isfinite(o).all()),
               f"gemma paged {label}: K7 {n_k7}, {freed} pages freed")
        count("K7", n_k7)
        r = ctx.rec["K7 d256"]
        r["max_abs_err"] = max(r["max_abs_err"], e_o, e_l)
        med = statistics.median(times)
        if step_ms is None:
            step_ms = med
        print(f"[gemma] paged loop, {label}: {N_PAGES} pages x {PAGE} "
              f"tokens x {hkv} KV heads x d {d} "
              f"({_nbytes(cache.k_pages, cache.v_pages) / 2**30:.2f} GiB), "
              f"B={b} x {PAGED_PREFILL} tokens, {steps} steps bit for bit "
              f"K6's on the shadow, the last vs plain max|dO| {e_o:.3e} "
              f"(max|O| {ref:.3e}) max|dLSE| {e_l:.3e}; retired sequence "
              f"3: {freed} pages back and reused; K7 launches {n_k7}; "
              f"paged_decode_step {med:.4f} ms (median) ({card})",
              flush=True)
        del cache, shadow, alloc
    del k_all, v_all, model
    print(f"[gemma] summary: prefill {prefill_s * 1e3:.3f} ms (B={BATCH} x "
          f"{PROMPT}), chunked prefill {chunk_s * 1e3:.3f} ms (B={BATCH} x "
          f"{LONG_PROMPT}, bf16 cache), paged step {step_ms:.4f} ms "
          f"({card})", flush=True)


# ---------------------------------------------------------------------------
# Phase 27: the backward at d = 256 (K4, K2 + K3 and the prologue's d = 256
# builds) and the Gemma-width model trained through make_train_step
# ---------------------------------------------------------------------------

GEMMA_TRAIN_T = 4096


def _phase_wide_backward(ctx, f32=False):
    """The d = 256 builds of K4, K2 + K3 and the prologue against the plain
    backward at the Gemma-width layer's shapes (8 query heads over 4 KV
    heads): the training shape [1, 8, 4096, 256] causal, the same under
    window 1024, segment ids causal and not (B=2, 1000 rows, ragged
    segments), a ragged 300 x 400 with kv_offset -20 (empty rows, unseen
    keys) and d = 200 on heads zero-padded to 256. bf16: peaked inputs (Q
    x8, K x4), gate per gradient max |diff| <= BWD_GATE · max |plain|;
    the prologue's D within 1e-5 · max(1, max |plain D|) and K4's
    accumulator zeroed. `f32` (phase 29): fp32 inputs, peaked and flat,
    each gradient within F32_GATE · max(1, max |plain|) of the plain fp32
    backward (TF32 off), on the fp32 d = 256 builds. Per case (peaked
    inputs) the kernels' device ms (torch.profiler), their bounds
    (products over the visible pairs over the bf16 rate, or in fp32 the
    TF32 rate, `_bound_f32`; the prologue's bytes over the memory rate),
    the plain backward's ms and the library call's (SDPA's autograd
    backward on the same inputs); the training shape's numbers are the
    rows "K4 d256", "K2 d256", "K3 d256" and "prologue d256" (in fp32 "K4
    f32 d256", "K2 f32 d256", "K3 f32 d256")."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops import flash_bwd as fb
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    dev, card, rec = ctx.dev, ctx.card, ctx.rec
    h, hkv, d = (GEMMA_KW["n_heads"], GEMMA_KW["n_kv_heads"],
                 GEMMA_KW["d_head"])
    gen = torch.Generator(device=dev).manual_seed(29 if f32 else 27)
    dtype = torch.float32 if f32 else torch.bfloat16
    tag, row = ("wide-f32-bwd", "f32 d256") if f32 else ("wide-bwd", "d256")

    def u(*shape, peak=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) - 0.5)
                * peak).to(dtype)

    def gate_of(ref):
        return F32_GATE * max(1.0, ref) if f32 else BWD_GATE * ref

    seg = torch.repeat_interleave(
        torch.arange(4, device=dev),
        torch.tensor([300, 1, 450, 249], device=dev))[None].expand(
            2, 1000).contiguous()
    t = GEMMA_TRAIN_T
    cases = [
        ("training 4096 causal", 1, t, t, d, dict(causal=True)),
        ("training 4096 window 1024", 1, t, t, d,
         dict(causal=True, window=LONG_WINDOW)),
        ("ragged 1000 segments causal", 2, 1000, 1000, d,
         dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)),
        ("ragged 1000 segments", 2, 1000, 1000, d,
         dict(q_segment_ids=seg, kv_segment_ids=seg)),
        ("ragged 300x400 kv_offset -20", 2, 300, 400, d,
         dict(causal=True, kv_offset=-20)),
        ("d=200 on the d=256 build, 1000 causal", 1, 1000, 1000, 200,
         dict(causal=True)),
    ]
    failures = []
    for (name, b, nq, nk, dd, kw), peaked in (
            (case, peaked) for case in cases
            for peaked in ((True, False) if f32 else (True,))):
        qk_peak = (Q_PEAK, K_PEAK) if peaked else (1.0, 1.0)
        q, do = u(b, h, nq, dd, peak=qk_peak[0]), u(b, h, nq, dd)
        k, v = u(b, hkv, nk, dd, peak=qk_peak[1]), u(b, hkv, nk, dd)
        o, lse = flash_attention_forward(q, k, v, **kw)
        args = (q, k, v, o, lse, do)
        fused = fb.flash_attention_backward(*args, fused=True, **kw)
        split = fb.flash_attention_backward(*args, fused=False, **kw)
        torch.cuda.synchronize()
        plain = fb.flash_attention_backward_plain(*args, **kw)
        lines = []
        for label, got, kerns in (("K4", fused, ("K4",) * 3),
                                  ("K2+K3", split, ("K3", "K2", "K2"))):
            line = []
            for gname, g, w, kern in zip(("dQ", "dK", "dV"), got, plain,
                                         kerns):
                e, ref = ctx.diff(g, w), w.float().abs().max().item()
                line.append(f"{gname} {e:.3e}/{ref:.3e}")
                r = rec[f"{kern} {row}"]
                r["max_abs_err"] = max(r["max_abs_err"], e)
                if not (ref > 0 and e <= gate_of(ref) and g.dtype == dtype
                        and bool(torch.isfinite(g).all())
                        and g.shape == w.shape):
                    failures.append(
                        f"{tag} {name} (Q x{qk_peak[0]:g}) {label} "
                        f"{gname}: max|diff| {e:.3e}, max|ref| {ref:.3e}")
            lines.append(f"{label} {', '.join(line)}")
        del fused, split, plain
        gate_text = (f"gate {F32_GATE} x max(1, max|ref|)" if f32
                     else f"gate {BWD_GATE} x max|ref|")
        if not peaked:
            print(f"[{tag}] {name} (flat inputs): vs plain max|diff|/max|ref|"
                  f": {'; '.join(lines)} ({gate_text}) ({card})", flush=True)
            del q, k, v, o, lse, do, args
            continue
        timed = name.startswith("training 4096 causal")
        dev_ms = _device_ms_by_kernel(lambda: (
            fb.flash_attention_backward(*args, fused=True, **kw),
            fb.flash_attention_backward(*args, fused=False, **kw)),
            ("K2", "K3", "K4"), iters=3)
        _check(all(math.isfinite(x) for x in dev_ms.values()),
               f"{tag} {name}: the profiler recorded no launch of a "
               f"backward kernel: {dev_ms}")
        ms_p = cuda_time_ms(lambda: fb.flash_attention_backward_plain(
            *args, **kw), iters=2, warmup=1)
        if kw == dict(causal=True):
            # SDPA's causal form (is_causal), as the d = 128 rows time it
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o_l = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=True, enable_gqa=True)
            lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
                o_l, leaves, do, retain_graph=True), iters=10)
            del leaves, o_l
        else:
            lib_ms = _library_ms(ctx, q, k, v, kw, backward=True, do=do)
        pairs = _visible_pairs(ctx, b, h, nq, nk, kw)
        read = _nbytes(q, k, v, o, lse, do)
        # products per visible (query, key) pair: K2 S, dP, dV, dK; K3 S,
        # dP, dQ; K4 all five; 2·d operations each
        bounds = {kn: (_bound_f32 if f32 else _bound)(
            read + written, 2.0 * pairs * dd * products)
            for kn, products, written in (("K2", 4, _nbytes(k, v)),
                                          ("K3", 3, _nbytes(q)),
                                          ("K4", 5, _nbytes(q, k, v)))}
        if timed:
            for kn in ("K2", "K3", "K4"):
                rec[f"{kn} {row}"].update(ms=dev_ms[kn], plain_ms=ms_p,
                                          library_ms=lib_ms, **bounds[kn])
        print(f"[{tag}] {name}: B={b} H={h} Hkv={hkv} Nq={nq} Nk={nk} "
              f"d={dd} vs plain max|diff|/max|ref|: {'; '.join(lines)} "
              f"({gate_text}); device K4 {dev_ms['K4']:.4f} ms "
              f"({_vs_bound(dev_ms['K4'], bounds['K4'])}), K2 "
              f"{dev_ms['K2']:.4f} ms ({_vs_bound(dev_ms['K2'], bounds['K2'])})"
              f", K3 {dev_ms['K3']:.4f} ms "
              f"({_vs_bound(dev_ms['K3'], bounds['K3'])}); plain {ms_p:.4f} "
              f"ms; library (SDPA {'fp32 ' if f32 else ''}backward, "
              + ("is_causal" if kw == dict(causal=True)
                 else "boolean mask" if _mask(ctx, nq, nk, kw) is not None
                 else "no mask") + f") {lib_ms:.4f} ms ({card})",
              flush=True)
        if dd == d and not f32:
            # the prologue's D, and K4's accumulator zeroed
            acc = torch.full(q.shape, 7.0, device=dev)
            got = fb._launch_delta(o, do, acc)
            want = fb.delta_plain(o, do)
            torch.cuda.synchronize()
            e = ctx.diff(got, want)
            gate = 1e-5 * max(1.0, want.abs().max().item())
            r = rec["prologue d256"]
            r["max_abs_err"] = max(r["max_abs_err"], e)
            if not (e <= gate and torch.count_nonzero(acc).item() == 0):
                failures.append(f"d=256 {name} prologue: max|dD| {e:.3e} "
                                f"(gate {gate:.3e}), or dQ's accumulator "
                                f"not zero")
            if timed:
                ms = _call_ms(lambda: fb._launch_delta(o, do, acc),
                              "K4 D prologue", iters=10)

                def plain_d():
                    fb.delta_plain(o, do)
                    torch.zeros(q.shape, dtype=torch.float32, device=dev)
                ms_pd = cuda_time_ms(plain_d, iters=10)
                lib = cuda_time_ms(lambda: (do.float() * o.float()).sum(-1),
                                   iters=10)
                bound = _bound(_nbytes(o, do, got, acc), 0.0)
                r.update(ms=ms, plain_ms=ms_pd, library_ms=lib, **bound)
                print(f"[wide-bwd] prologue d=256 {name}: max|dD| {e:.3e} "
                      f"(gate {gate:.3e}); kernel {ms:.4f} ms "
                      f"({100 * bound['bound_ms'] / ms:.1f}% of its bound "
                      f"{bound['bound_ms']:.4f} ms, bytes: O and dO read, D "
                      f"and the fp32 accumulator written); plain "
                      f"{ms_pd:.4f} ms; library (do.float() * "
                      f"o.float()).sum(-1) {lib:.4f} ms ({card})",
                      flush=True)
            del acc, got, want
        del q, k, v, o, lse, do, args
    _check(not failures, "; ".join(failures))


def _timed_train_steps(ctx, m, tokens, tag, train_flops, rows):
    """2 warm-up and TIMED_STEPS timed `make_train_step` steps of m with
    SGD(1e-4) on one batch: median step ms, tokens/s, TFLOP/s
    (`train_flops` a step), peak GiB and the losses printed; the launches
    over the timed steps checked (K1 = K4 = the prologue = TIMED_STEPS ·
    layers, K2 = K3 = 0) and added to `rows` (the kernels' rows for the
    forward, K4 and the prologue). Returns the step."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    t = tokens.shape[1]
    step = tfm.make_train_step(m, torch.optim.SGD(m.parameters(), lr=1e-4))
    for _ in range(2):
        step(tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx.zero_counts()
    step_s, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = dict(fwd=ctx.fwd_forms["online"],
                  total=flash_attention_forward.launches, **ctx.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect = TIMED_STEPS * m.cfg.n_layers
    step_ms = statistics.median(step_s) * 1e3
    print(f"[{tag}] launches over {TIMED_STEPS} steps: K1 "
          f"{counts['fwd']}, K4 {counts['fused']}, the prologue "
          f"{counts['delta']}, K2 {counts['dkdv']}, K3 {counts['dq']} "
          f"(expect {expect}, {expect}, {expect}, 0, 0); step "
          f"{step_ms:.3f} ms (median of {TIMED_STEPS}: "
          f"{', '.join(f'{x * 1e3:.3f}' for x in step_s)}), "
          f"{t / step_ms * 1e3:.1f} tokens/s, "
          f"{train_flops / step_ms / 1e9:.1f} TFLOP/s "
          f"({train_flops / 1e12:.3f} TFLOP a step), peak memory "
          f"{peak:.2f} GiB; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)} ({ctx.card})",
          flush=True)
    _check(counts == dict(fwd=expect, total=expect, fused=expect,
                          dkdv=0, dq=0, delta=expect),
           f"{tag} launch counts {counts}")
    _check(all(math.isfinite(x) for x in losses), f"{tag} losses {losses}")
    for key, kernel_rows in rows.items():
        for row in kernel_rows:
            ctx.launches[row] += counts[key]
    return step


def _phase_gemma_training(ctx):
    """Main path of training at Gemma 2 2B's widths (GEMMA_KW, bf16,
    seeded weights, full width and depth: 26 layers, d_head 256, 8 query
    heads over 4 KV heads; B=1 x T=4096 tokens, one seeded batch):
    `make_train_step` with SGD(1e-4), 2 warm-up steps then 5 timed ones:
    median step ms, tokens/s, TFLOP/s counted as bench.py counts a train
    step, peak GiB; launches over the timed steps K1 = K4 = the prologue
    = 26 x 5 (each also counted in its d256 row), K2 = K3 = 0; a profile
    of one step by kernel group. The loss and every parameter's gradient
    of one step against the same step on the plain attention functions
    (loss within LOSS_GATE, relative L2 per gradient within GRAD_GATE);
    one step through the split backward (K2 and K3 26 times each) at the
    same gates; the windowed model (`cfg.window` = 1024) the same way;
    10 Adam(1e-3) steps that must lower the loss. No depth or width is
    cut."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops import attention
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward, flash_attention_backward_plain)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward, flash_attention_forward_plain)
    from cuda_flashattention_torch.utils.profiling import kernel_times
    from cuda_flashattention_torch.utils.timing import attention_flops
    dev, card, launches = ctx.dev, ctx.card, ctx.launches
    bwd_launches = ctx.bwd_launches
    t = GEMMA_TRAIN_T
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16,
                                **{**GEMMA_KW, "max_seq": t})
    n = cfg.n_layers

    def fresh(c):
        return tfm.Transformer(
            c, generator=torch.Generator(device=dev).manual_seed(27))

    model = fresh(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (1, t), device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(28),
                           dtype=torch.int32)
    print(f"[gemma-train] {n_params / 1e9:.3f}B parameters, {n} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads of d_head {cfg.d_head}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; B=1 T={t}, bf16, SGD(1e-4) "
          f"({card})", flush=True)
    train_flops = (6.0 * n_params * t
                   + 3 * attention_flops(1, cfg.n_heads, t, t, cfg.d_head,
                                         causal=True) * n)

    rows = dict(fwd=["K1", "K1 d256"], fused=["K4", "K4 d256"],
                delta=["K4 D prologue", "prologue d256"])

    def timed_steps(m, tag):
        return _timed_train_steps(ctx, m, tokens, tag, train_flops, rows)

    names = [nm for nm, _ in model.named_parameters()]

    def loss_and_grads(m):
        m.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(m, tokens)
        loss.backward()
        grads = [p.grad.clone() for p in m.parameters()]
        m.zero_grad(set_to_none=True)
        return loss.item(), grads

    def rel_l2(ga, gb):
        errs = [((a.float() - b.float()).norm() / b.float().norm()).item()
                for a, b in zip(ga, gb)]
        i = max(range(len(errs)), key=errs.__getitem__)
        return errs[i], names[i]

    plain_bwd = (lambda q, k, v, o, lse, do, block_sizes=None, fused=None,
                 **kw:
                 flash_attention_backward_plain(q, k, v, o, lse, do, **kw))

    def against_plain(m, tag):
        """The loss and every gradient of one step through the kernels
        against the same on the plain attention functions."""
        loss_k, grads_k = loss_and_grads(m)
        with mock.patch.object(attention, "flash_attention_forward",
                               flash_attention_forward_plain), \
                mock.patch.object(attention, "flash_attention_backward",
                                  plain_bwd):
            loss_p, grads_p = loss_and_grads(m)
        e_grad, worst = rel_l2(grads_k, grads_p)
        del grads_p
        print(f"[{tag}] kernels vs plain attention ({n} layers): loss "
              f"{loss_k:.6f} vs {loss_p:.6f} (|d| "
              f"{abs(loss_k - loss_p):.3e}, gate {LOSS_GATE}); worst "
              f"gradient relative L2 {e_grad:.3e} ({worst}; gate "
              f"{GRAD_GATE})", flush=True)
        _check(abs(loss_k - loss_p) <= LOSS_GATE,
               f"{tag}: kernel vs plain loss {loss_k} vs {loss_p}")
        _check(e_grad <= GRAD_GATE, f"{tag}: kernel vs plain gradient of "
               f"{worst}: relative L2 {e_grad:.3e}")
        return loss_k, grads_k

    # ---- the timed steps, a profile, the plain comparison, the split path
    step = timed_steps(model, "gemma-train")
    prof = kernel_times(lambda: step(tokens))
    groups = {}
    for nm, ms in prof.ms.items():
        groups[_group_of(nm)] = groups.get(_group_of(nm), 0.0) + ms
    print(f"[gemma-train] profile of one step: {sum(prof.count.values())} "
          f"kernels, device busy {prof.busy_ms:.3f} ms of a profiled wall "
          f"of {prof.wall_ms:.3f} ms ({prof.busy_ms / prof.wall_ms:.1%})"
          + "".join(f"; {g} {ms:.3f} ms ({ms / prof.busy_ms:.1%})"
                    for g, ms in sorted(groups.items(),
                                        key=lambda kv: -kv[1]))
          + f" ({card})", flush=True)
    del step
    loss_k, grads_k = against_plain(model, "gemma-train")
    ctx.zero_counts()
    with mock.patch.object(attention, "flash_attention_backward",
                           functools.partial(flash_attention_backward,
                                             fused=False)):
        loss_s, grads_s = loss_and_grads(model)
    torch.cuda.synchronize()
    counts = dict(fwd=flash_attention_forward.launches, **bwd_launches)
    e_split, worst = rel_l2(grads_s, grads_k)
    del grads_s, grads_k
    print(f"[gemma-train] split backward: launches K1 {counts['fwd']}, K2 "
          f"{counts['dkdv']}, K3 {counts['dq']}, K4 {counts['fused']}, the "
          f"prologue {counts['delta']} (expect {n} each, K4 0); loss "
          f"{loss_s:.6f}; worst gradient relative L2 to the fused backward "
          f"{e_split:.3e} ({worst}; gate {GRAD_GATE})", flush=True)
    _check(counts == dict(fwd=n, fused=0, dkdv=n, dq=n, delta=n),
           f"gemma split-backward launch counts {counts}")
    _check(abs(loss_s - loss_k) <= LOSS_GATE and e_split <= GRAD_GATE,
           f"gemma split vs fused backward: loss {loss_s} vs {loss_k}, "
           f"gradient of {worst} {e_split:.3e}")
    for kn in ("K1", "K2", "K3"):
        c = counts["fwd" if kn == "K1" else "dkdv" if kn == "K2" else "dq"]
        launches[kn] += c
        launches[f"{kn} d256"] += c
    launches["K4 D prologue"] += counts["delta"]
    launches["prologue d256"] += counts["delta"]
    del model

    # ---- the windowed model (cfg.window = 1024)
    torch.cuda.empty_cache()
    wmodel = fresh(dataclasses.replace(cfg, window=LONG_WINDOW))
    wstep = timed_steps(wmodel, f"gemma-wtrain window {LONG_WINDOW}")
    del wstep
    against_plain(wmodel, f"gemma-wtrain window {LONG_WINDOW}")
    del wmodel

    # ---- loss falls: 10 Adam steps on a fresh model and the same batch
    torch.cuda.empty_cache()
    model = fresh(cfg)
    step = tfm.make_train_step(model,
                               torch.optim.Adam(model.parameters(), lr=1e-3))
    adam = [step(tokens).item() for _ in range(ADAM_STEPS)]
    print(f"[gemma-train] Adam(1e-3), {ADAM_STEPS} steps, {n} layers: "
          f"losses {', '.join(f'{x:.4f}' for x in adam)}", flush=True)
    _check(all(math.isfinite(x) for x in adam) and adam[-1] < adam[0],
           f"gemma Adam losses did not fall: {adam}")
    del model, step


# ---------------------------------------------------------------------------
# Phase 28: fp32 at d = 256 in the forward (K1, K1b and K5 on an fp32 Q over
# fp32, bf16 and one-byte K/V; K8 at d = 256) and an fp32 Gemma-width model
# served
# ---------------------------------------------------------------------------

# greedy tokens of the fp32 Gemma-width serving runs (the bf16 runs' 128
# cut so that the phase fits its share of the script's time)
GEMMA_F32_NEW = 32
WIDE_F32_KV = ("fp32", "bf16", "int8", "fp8", "mixed")
K8_WIDE = (1, 8, 4096, 256)  # B, H, N, d of the K8 rows


def _stored_f32(kv, k, v):
    """fp32 k, v stored as `kv` (fp32, bf16, or a quantized pair): (k, v,
    their scales, and the fp32 K/V that the stored ones stand for)."""
    from cuda_flashattention_torch.ops.quant import quantize_kv
    if kv == "fp32":
        return k, v, {}, k, v
    if kv == "bf16":
        kb, vb = k.bfloat16(), v.bfloat16()
        return kb, vb, {}, kb.float(), vb.float()
    q = quantize_kv(k, v, kv)
    return (q.k_q, q.v_q, dict(k_scale=q.k_scale, v_scale=q.v_scale),
            q.k_q.float() * q.k_scale[..., None],
            q.v_q.float() * q.v_scale[..., None])


def _phase_wide_f32_kernels(ctx):
    """The fp32-Q builds at d = 256 against their plain fp32 versions at
    the Gemma-width model's attention shapes (8 query heads over 4 KV
    heads), TF32 off, on flat and on peaked (Q x8, K x4) inputs: K1
    (online), K1b and K5 (pinned, no guarded fallback) and what "auto"
    routes to (its guarded fallback behind a bound form) at the serving
    prefill (B=8, 512 causal), a ragged 500-row prefill, the chunked
    prefill's prefix (512 x 3584), its windowed slice (512 x 1024, window
    1024, kv_offset 1024) and a ragged GQA prefix (300 x 2999 causal,
    kv_offset 2699), over fp32 (32-key split tiles), bf16 and int8, fp8
    and mixed K/V: O and LSE within 1e-4, K5 within 1e-4 of K1b. At the
    prefix: fp16 O equal to the fp32 O rounded (K5 within one fp16 ulp),
    `quantize_q` (the int8 build on the host's int8 Q over int8 and mixed
    keys, 5e-3; dropped over fp8 keys, 1e-4), d = 200 on heads padded to
    256; K1 under segment ids over fp32, bf16 and int8; a loose bound
    returning the online kernel's bits. Each form's ms at the prefill, the
    prefix and the windowed slice beside its fp32 bound and fp32 SDPA on
    the same (upcast or dequantised) inputs; rows "K1 f32 d256", "K1b f32
    d256", "K5 f32 d256". Then K8 at [1, 8, 4096, 256] in bf16 (5e-3 and
    2e-2 · max |plain O|) and fp32 (1e-4), causal and not, through
    `fa1_attention` (rows "K8 d256", "K8 f32 d256")."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.ops.fa1 import (
        fa1_attention, fa1_attention_plain)
    from cuda_flashattention_torch.utils.timing import (
        attention_flops, cuda_time_ms)
    dev, card = ctx.dev, ctx.card
    h, hkv, d = (GEMMA_KW["n_heads"], GEMMA_KW["n_kv_heads"],
                 GEMMA_KW["d_head"])
    gen = torch.Generator(device=dev).manual_seed(28)

    def u(*shape, peak=1.0):
        return (torch.rand(shape, generator=gen, device=dev) - 0.5) * peak

    def calls(form, q, k, v, sc, kw, qq=False, out_dtype=torch.float32):
        """(kernel call, plain call) of one form: K1 (online), or K1b / K5
        pinned through `_plan` + `_fwd_cuda` (no guarded fallback)."""
        if form == "online":
            args = dict(softmax="online", out_dtype=out_dtype, **kw, **sc)
            return (lambda: ff.flash_attention_forward(q, k, v, **args),
                    lambda: ff.flash_attention_forward_plain(q, k, v,
                                                             **args))
        plan = ff._plan(q, k, v, None, kw.get("causal", False),
                        kw.get("window", 0), kw.get("kv_offset", 0), None,
                        sc.get("k_scale"), sc.get("v_scale"), None, None,
                        "bound_unchecked", qq)
        plan = dataclasses.replace(plan, use_kmajor=form == "kmajor")
        return (lambda: ff._fwd_cuda(q, k, v, plan, out_dtype,
                                     sc.get("k_scale"), sc.get("v_scale"),
                                     None, None),
                lambda: ff.flash_attention_forward_plain(
                    q, k, v, softmax="bound_unchecked", quantize_q=qq,
                    out_dtype=out_dtype, **kw, **sc))

    def close(got, want, what, gate=F32_GATE):
        (o, lse), (o_p, lse_p) = got, want
        e = max(ctx.diff(o, o_p), ctx.diff(lse, lse_p))
        _check(e <= gate and o_p.abs().max().item() > 0
               and bool(torch.isfinite(o).all()),
               f"{what}: max|diff| {e:.3e} (gate {gate})")
        return e

    def note(kn, e):
        r = ctx.rec[f"{kn} f32 d256"]
        r["max_abs_err"] = max(r["max_abs_err"], e)

    kernel_of = {"online": "K1", "bound": "K1b", "kmajor": "K5"}
    cases = [
        ("prefill 512 causal", BATCH, 512, 512, dict(causal=True)),
        ("ragged 500 causal", BATCH, 500, 500, dict(causal=True)),
        ("prefix 512x3584", BATCH, 512, 3584, {}),
        ("windowed prefix 512x1024", BATCH, 512, 1024,
         dict(causal=True, window=LONG_WINDOW, kv_offset=LONG_WINDOW)),
        ("ragged GQA prefix 300x2999", 2, 300, 2999,
         dict(causal=True, kv_offset=2699)),
    ]
    # the rows of the kernels line: each kernel where the main path runs
    # it (K1 on the chunks, K1b on the prefix reads without a window, K5
    # on the windowed reads of an int8 cache)
    rows = {("K1", "prefill 512 causal", "fp32"),
            ("K1b", "prefix 512x3584", "fp32"),
            ("K5", "windowed prefix 512x1024", "int8")}
    timed = ("prefill 512 causal", "prefix 512x3584",
             "windowed prefix 512x1024")
    for name, b, nq, nk, kw in cases:
        flops = 4.0 * _visible_pairs(ctx, b, h, nq, nk, kw) * d
        worst = 0.0
        for peaked in (False, True):
            q = u(b, h, nq, d, peak=Q_PEAK if peaked else 1.0)
            k0 = u(b, hkv, nk, d, peak=K_PEAK if peaked else 1.0)
            v0 = u(b, hkv, nk, d)
            for kv in WIDE_F32_KV:
                k, v, sc, kd, vd = _stored_f32(kv, k0, v0)
                got, line = {}, []
                if not peaked and name in timed:
                    lib_ms = _library_ms(ctx, q, kd, vd, kw)
                    bound = _bound_f32(_nbytes(q, k, v, *sc.values())
                                       + b * h * nq * (4 * d + 4), flops)
                for form in ("online", "bound", "kmajor"):
                    kn = kernel_of[form]
                    call, plain = calls(form, q, k, v, sc, kw)
                    got[form] = call()
                    torch.cuda.synchronize()
                    e = close(got[form], plain(),
                              f"{kn} fp32 d=256 {name} over {kv}"
                              + (" peaked" if peaked else ""))
                    note(kn, e)
                    worst = max(worst, e)
                    if peaked or name not in timed:
                        continue
                    ms = _call_ms(call, kn)
                    line.append(f"{kn} {ms:.4f} "
                                f"({100 * bound['bound_ms'] / ms:.1f}%)")
                    if (kn, name, kv) in rows:
                        ms_p = cuda_time_ms(plain, iters=2, warmup=1)
                        ctx.rec[f"{kn} f32 d256"].update(
                            ms=ms, plain_ms=ms_p, library_ms=lib_ms, **bound)
                        line.append(f"plain {ms_p:.4f}")
                e_k = max(ctx.diff(got["kmajor"][0], got["bound"][0]),
                          ctx.diff(got["kmajor"][1], got["bound"][1]))
                _check(e_k <= 1e-4, f"K5 vs K1b fp32 d=256 {name} {kv}: "
                       f"{e_k:.3e}")
                # "auto": the form the JAX rule routes to, with its guarded
                # fallback behind a bound form
                plan = ff._plan(q, k, v, None, kw.get("causal", False),
                                kw.get("window", 0), kw.get("kv_offset", 0),
                                None, sc.get("k_scale"), sc.get("v_scale"),
                                None, None, "auto", False)
                kn = ("K5" if plan.use_kmajor else
                      "K1b" if plan.use_bound else "K1")
                args = dict(out_dtype=torch.float32, **kw, **sc)
                got_auto = ff.flash_attention_forward(q, k, v, **args)
                torch.cuda.synchronize()
                e = close(got_auto, ff.flash_attention_forward_plain(
                    q, k, v, **args), f"auto ({kn}) fp32 d=256 {name} over "
                    f"{kv}" + (" peaked" if peaked else ""))
                note(kn, e)
                worst = max(worst, e)
                if line:
                    print(f"[wide-f32] {name} over {kv} K/V, B={b} H={h} "
                          f"Hkv={hkv}: kernel ms (share of the fp32 bound "
                          f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}) "
                          f"{', '.join(line)}; fp32 SDPA (TF32 off) on the "
                          f"{'upcast' if kv != 'fp32' else 'same'} K/V "
                          f"{lib_ms:.4f} ms; K5 vs K1b {e_k:.3e} ({card})",
                          flush=True)
            del q, k0, v0, k, v, sc, kd, vd, got
        print(f"[wide-f32] d=256 {name}: K1, K1b and K5 pinned and what "
              f"\"auto\" routes to, on an fp32 Q over fp32, bf16, int8, fp8 "
              f"and mixed K/V, flat and peaked, within 1e-4 of the plain fp32 "
              f"version (worst {worst:.3e}), K5 within 1e-4 of K1b ({card})",
              flush=True)

    # at the prefix, peaked: fp16 O, quantize_q, d = 200
    b, nq, nk = BATCH, 512, 3584
    q = u(b, h, nq, d, peak=Q_PEAK)
    k0, v0 = u(b, hkv, nk, d, peak=K_PEAK), u(b, hkv, nk, d)
    for kv in ("fp32", "bf16"):
        k, v, sc, _, _ = _stored_f32(kv, k0, v0)
        for form in ("online", "bound", "kmajor"):
            o32, lse32 = calls(form, q, k, v, sc, {})[0]()
            o16, lse16 = calls(form, q, k, v, sc, {},
                               out_dtype=torch.float16)[0]()
            torch.cuda.synchronize()
            ulp = 2.0 ** -10 if form == "kmajor" else 0.0
            e = ctx.diff(o16, o32.half())
            _check(o16.dtype == torch.float16
                   and e <= ulp * max(1.0, o32.abs().max().item())
                   and ctx.diff(lse16, lse32) <= (F32_GATE if ulp else 0.0),
                   f"{kernel_of[form]} fp32 d=256 fp16 O over {kv}: {e:.3e}")
    for kv in ("int8", "mixed", "fp8"):
        k, v, sc, _, _ = _stored_f32(kv, k0, v0)
        for form in ("bound", "kmajor"):
            call, plain = calls(form, q, k, v, sc, {}, qq=True)
            got = call()
            torch.cuda.synchronize()
            # over fp8 keys an fp32 Q drops quantize_q (the JAX rule)
            e = close(got, plain(), f"{kernel_of[form]} fp32 d=256 "
                      f"quantize_q over {kv}",
                      F32_GATE if kv == "fp8" else GATE)
            if kv == "fp8":
                note(kernel_of[form], e)
    q2 = q[..., :200].contiguous()
    k2, v2 = k0[..., :200].contiguous(), v0[..., :200].contiguous()
    for form in ("online", "bound", "kmajor"):
        call, plain = calls(form, q2, k2, v2, {}, {})
        got = call()
        torch.cuda.synchronize()
        _check(got[0].shape == q2.shape, "d = 200: O's width")
        note(kernel_of[form], close(got, plain(), f"{kernel_of[form]} "
                                    f"fp32 d=200 on padded heads"))
    print(f"[wide-f32] prefix 512x3584: fp16 O equal to the fp32 O rounded "
          f"(K5 within one fp16 ulp) over fp32 and bf16 K/V; quantize_q "
          f"over int8 and mixed within {GATE}, over fp8 (dropped) within "
          f"{F32_GATE}; d = 200 on padded heads within {F32_GATE} ({card})",
          flush=True)
    del q, k0, v0, q2, k2, v2

    # K1 under segment ids; a loose bound
    bs, n = 2, 1024
    ids = torch.repeat_interleave(
        torch.arange(4, device=dev),
        torch.tensor([300, 1, 500, 223], device=dev))[None].expand(
            bs, n).contiguous()
    q = u(bs, h, n, d, peak=Q_PEAK)
    k0, v0 = u(bs, hkv, n, d, peak=K_PEAK), u(bs, hkv, n, d)
    for kv in ("fp32", "bf16", "int8"):
        k, v, sc, _, _ = _stored_f32(kv, k0, v0)
        for causal in (True, False):
            kw = dict(causal=causal, q_segment_ids=ids, kv_segment_ids=ids,
                      **sc)
            got = ff.flash_attention_forward(q, k, v, **kw)
            torch.cuda.synchronize()
            note("K1", close(got, ff.flash_attention_forward_plain(
                q, k, v, **kw), f"K1 fp32 d=256 segment ids over {kv} "
                f"causal={causal}"))
    q = u(1, 4, 256, d).abs() * 20
    k0, v0 = -u(1, 4, 256, d).abs() * 20, u(1, 4, 256, d)
    k0[:, :, 0] = k0[:, :, 0].abs()  # one key far above the rows' scores
    for kv in ("fp32", "bf16"):
        k, v, sc, _, _ = _stored_f32(kv, k0, v0)
        before = dict(ctx.fwd_forms)
        got = ff.flash_attention_forward(q, k, v, softmax="bound")
        online = ff.flash_attention_forward(q, k, v, softmax="online")
        torch.cuda.synchronize()
        grown = ctx.fwd_forms["fallback"] - before["fallback"]
        _check(grown == 1 and torch.equal(got[0], online[0])
               and torch.equal(got[1], online[1]),
               f"fp32 d=256 loose bound over {kv}: the fallback ran "
               f"{grown} times or its bits differ from the online kernel's")
    print(f"[wide-f32] K1 under segment ids (B={bs}, N={n}; fp32, bf16, "
          f"int8 K/V; causal and not) within {F32_GATE}; a loose bound "
          f"(fp32, bf16 K/V) returns the online kernel's bits ({card})",
          flush=True)
    del q, k0, v0, k, v

    # K8 at d = 256, bf16 and fp32, through its entry point
    b, hh, n, dd = K8_WIDE
    for dtype, row in ((torch.bfloat16, "K8 d256"),
                       (torch.float32, "K8 f32 d256")):
        q, k, v = (u(b, hh, n, dd, peak=Q_PEAK).to(dtype),
                   u(b, hh, n, dd, peak=K_PEAK).to(dtype),
                   u(b, hh, n, dd).to(dtype))
        ctx.zero_counts()
        outs = {c: fa1_attention(q, k, v, causal=c) for c in (True, False)}
        torch.cuda.synchronize()
        ctx.launches[row] += fa1_attention.launches
        _check(fa1_attention.launches == 2, f"{row}: launches "
               f"{fa1_attention.launches}")
        for causal in (True, False):
            o_p = fa1_attention_plain(q, k, v, causal=causal)
            e, ref = ctx.diff(outs[causal], o_p), o_p.float().abs().max().item()
            ok = (e <= F32_GATE if dtype == torch.float32
                  else e <= min(GATE, REL_GATE * ref))
            _check(ok and ref > 0, f"{row} causal={causal}: max|dO| {e:.3e} "
                   f"(max|O| {ref:.3e})")
            ctx.rec[row]["max_abs_err"] = max(ctx.rec[row]["max_abs_err"], e)
            ms = _call_ms(lambda: fa1_attention(q, k, v, causal=causal),
                          "K8")
            bound = (_bound_f32 if dtype == torch.float32 else _bound)(
                _nbytes(q, k, v, q),
                attention_flops(b, hh, n, n, dd, causal=causal))
            lib_ms = _library_ms(ctx, q, k, v, dict(causal=causal))
            line = (f"kernel {ms:.4f} ms ({100 * bound['bound_ms'] / ms:.1f}% "
                    f"of its bound {bound['bound_ms']:.4f} ms, "
                    f"{bound['bound_by']}), SDPA {lib_ms:.4f} ms")
            if causal:
                ms_p = cuda_time_ms(lambda: fa1_attention_plain(
                    q, k, v, causal=True), iters=2, warmup=1)
                ctx.rec[row].update(ms=ms, plain_ms=ms_p, library_ms=lib_ms,
                                    **bound)
                line += f", plain {ms_p:.4f} ms"
            print(f"[wide-f32] {row} [{b}, {hh}, {n}, {dd}] causal={causal}: "
                  f"max|dO| {e:.3e} (max|O| {ref:.3e}); {line} ({card})",
                  flush=True)
        del q, k, v, outs


def _phase_gemma_f32_serving(ctx):
    """Main path of serving an fp32 model at Gemma 2 2B's widths
    (`TransformerConfig(dtype=torch.float32, **GEMMA_KW)`: 26 layers,
    d_model 2304, 8 query heads over 4 KV heads of d_head 256, d_ff 9216,
    vocab 256000; seeded weights, 10.5 GB in fp32, no cut of width or
    depth). `generate()`: B=8 prompts of 512 tokens, 32 greedy tokens,
    over an fp32 and an int8 cache (K1's fp32 d = 256 build 26, K6 26 x
    32 per run); each against the same loop on the plain attention
    functions (prefill logits within F32_LOGIT_GATE · max(1, max |plain|),
    greedy tokens equal or departing only at a tie within that gate), the
    int8 cache replayed on the fp32 cache's tokens within QUANT_LOGIT_GATE
    of its last-step logits. `prefill_chunked(chunk=512)`: B=8 prompts of
    4096 tokens, then 32 greedy steps, over fp32, bf16, int8 and fp8
    caches and, with `cfg.window` = 1024, an int8 cache: per form launches
    (own chunks K1 8 · 26; the prefix reads K1b, or K5 under the window,
    7 · 26, each behind its guarded K1; K6 32 · 26), the last chunk's
    logits and the greedy tokens against the run on the plain attention
    functions. Chunked-prefill ms and prompt tokens/s, decode ms a step,
    peak GiB, and a profile by kernel group of one chunked prefill over
    the fp32 cache."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.models.generate import generate
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.kv_cache import init_cache
    from cuda_flashattention_torch.utils.profiling import kernel_times
    dev, card = ctx.dev, ctx.card
    cfg = tfm.TransformerConfig(dtype=torch.float32, **GEMMA_KW)
    n_layers, new = cfg.n_layers, GEMMA_F32_NEW
    gen = torch.Generator(device=dev).manual_seed(28)
    model = tfm.Transformer(cfg, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    print(f"[gemma-f32] {sum(p.numel() for p in model.parameters()) / 1e9:.3f}"
          f"B parameters ({_nbytes(*model.parameters()) / 2**30:.2f} GiB in "
          f"fp32): vocab {cfg.vocab_size}, d_model {cfg.d_model}, {n_layers} "
          f"layers, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
          f"d_head {cfg.d_head}, d_ff {cfg.d_ff} ({card})", flush=True)

    def count(row, n):
        ctx.launches[row] += n

    def departure(toks, toks_p, logits_at, gate):
        """'' when the token rows agree, else where they first part and
        whether the plain run's two best logits there lie within the
        gate (a tie that fp32 rounding may break either way)."""
        if torch.equal(toks, toks_p):
            return "", True
        step = int((toks != toks_p).any(0).nonzero()[0])
        at = logits_at(step)
        rows = toks[:, step] != toks_p[:, step]
        best = at[rows].float().topk(2, dim=-1).values
        gap = (best[:, 0] - best[:, 1]).max().item()
        return (f" (first departure at token {step}, where the plain run's "
                f"two best logits lie {gap:.3e} apart)", gap <= gate)

    def gate_of(lg_p):
        return F32_LOGIT_GATE * max(1.0, lg_p.abs().max().item())

    def greedy(m, caches, lg, start, tok_in=None):
        """Greedy decode steps from the prefill's logits: (tokens [B,
        new] as generate() appends them, each step's logits); `tok_in`
        teacher-forces the tokens fed."""
        tok = torch.argmax(lg, dim=-1).to(prompt.dtype)
        toks, steps = [], []
        for i in range(new):
            toks.append(tok)
            feed = tok if tok_in is None else tok_in[:, i]
            lg, caches = tfm.decode_one(m, feed, start + i, caches)
            steps.append(lg)
            tok = torch.argmax(lg, dim=-1).to(prompt.dtype)
        return torch.stack(toks, 1), steps

    # ---- generate(): fp32 and int8 caches
    generate(model, prompt, 2)  # warm-up
    torch.cuda.synchronize()
    runs = {}
    for label, qtype in (("fp32 cache", None), ("int8 cache", "int8")):
        ctx.zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, logits = generate(model, prompt, new, qtype=qtype)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fwd, n_dec = ctx.fwd_forms["online"], decode_attention.launches
        _check(n_fwd == n_layers and n_dec == n_layers * new
               and sum(ctx.fwd_forms.values()) == n_fwd,
               f"gemma fp32 generate {label}: launches {ctx.fwd_forms}, K6 "
               f"{n_dec}")
        _check(tuple(out.shape) == (BATCH, PROMPT + new)
               and bool(torch.isfinite(logits).all()),
               f"gemma fp32 generate {label}: tokens or logits")
        count("K1 f32 d256", n_fwd)
        count("K6 d256", n_dec)
        caches = tfm.init_caches(cfg, BATCH, PROMPT + new, qtype=qtype,
                                 device=dev)
        lg_k, _ = tfm.prefill(model, prompt, caches)
        with _serving_on_plain_attention():
            caches = tfm.init_caches(cfg, BATCH, PROMPT + new, qtype=qtype,
                                     device=dev)
            lg_p, caches = tfm.prefill(model, prompt, caches)
            toks_p, steps_p = greedy(model, caches, lg_p, PROMPT)
        del caches
        e_prefill = ctx.diff(lg_k, lg_p)
        dep, tie_ok = departure(
            out[:, PROMPT:], toks_p,
            lambda s: lg_p if s == 0 else steps_p[s - 1], gate_of(lg_p))
        e_last = ctx.diff(logits, steps_p[-1]) if not dep else float("nan")
        print(f"[gemma-f32] generate {label}: B={BATCH} prompt={PROMPT} "
              f"new={new}: launches K1 {n_fwd} (expect {n_layers}), K6 "
              f"{n_dec} (expect {n_layers * new}); {wall:.3f} s, decode "
              f"{BATCH * new / wall:.1f} tok/s (the run's tokens over its "
              f"wall); vs the plain attention functions: prefill logits "
              f"max|d| {e_prefill:.3e} (gate {gate_of(lg_p):.3e}), tokens "
              f"equal {(out[:, PROMPT:] == toks_p).float().mean().item():.4f}"
              f"{dep}, last-step logits max|d| {e_last:.3e} ({card})",
              flush=True)
        _check(e_prefill <= gate_of(lg_p),
               f"gemma fp32 {label}: prefill logits {e_prefill:.3e}")
        _check(tie_ok, f"gemma fp32 {label}: tokens depart from the plain "
               f"run{dep}")
        _check(bool(dep) or e_last <= gate_of(steps_p[-1]),
               f"gemma fp32 {label}: last logits {e_last:.3e}")
        runs[label] = (out, logits)
        del lg_k, lg_p, steps_p
    out, logits = runs["fp32 cache"]
    caches = tfm.init_caches(cfg, BATCH, PROMPT + new, qtype="int8",
                             device=dev)
    lg8, caches = tfm.prefill(model, prompt, caches)
    _, steps8 = greedy(model, caches, lg8, PROMPT, tok_in=out[:, PROMPT:])
    e8 = ctx.diff(steps8[-1], logits)
    print(f"[gemma-f32] the int8 cache on the fp32 cache's tokens: last-step "
          f"logits max|d| {e8:.3e} (gate {QUANT_LOGIT_GATE}) ({card})",
          flush=True)
    _check(e8 <= QUANT_LOGIT_GATE, f"gemma fp32 int8-cache logits {e8:.3e}")
    del caches, runs, out, logits, steps8

    # ---- prefill_chunked(chunk=512) + greedy steps
    n_chunks = LONG_PROMPT // LONG_CHUNK
    own, n_prefix = n_chunks * n_layers, (n_chunks - 1) * n_layers
    long_prompt = torch.randint(0, cfg.vocab_size, (BATCH, LONG_PROMPT),
                                generator=gen, device=dev, dtype=torch.int32)

    def caches_of(cache):
        if cache == "bf16":
            return tuple(init_cache(BATCH, cfg.n_kv_heads, LONG_PROMPT + new,
                                    cfg.d_head, dtype=torch.bfloat16,
                                    device=dev) for _ in range(n_layers))
        return tfm.init_caches(cfg, BATCH, LONG_PROMPT + new,
                               qtype=None if cache == "fp32" else cache,
                               device=dev)

    def prefill(m, cache):
        c = caches_of(cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, c = tfm.prefill_chunked(m, long_prompt, c, chunk=LONG_CHUNK)
        torch.cuda.synchronize()
        return lg, c, time.perf_counter() - t0

    def serve(m, cache):
        """(last-chunk logits, tokens [B, new], each step's logits,
        prefill s, decode s)"""
        lg, c, p_s = prefill(m, cache)
        t0 = time.perf_counter()
        toks, steps = greedy(m, c, lg, LONG_PROMPT)
        torch.cuda.synchronize()
        return lg, toks, steps, p_s, time.perf_counter() - t0

    prefill(model, "fp32")  # warm-up
    peak = 0.0
    for label, cache, window in (("fp32 cache", "fp32", 0),
                                 ("bf16 cache", "bf16", 0),
                                 ("int8 cache", "int8", 0),
                                 ("fp8 cache", "fp8", 0),
                                 ("int8 cache, window 1024", "int8",
                                  LONG_WINDOW)):
        m = _windowed(model, window) if window else model
        ctx.zero_counts()
        torch.cuda.reset_peak_memory_stats()
        lg, toks, steps, p_s, d_s = serve(m, cache)
        peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
        counts, n_dec = dict(ctx.fwd_forms), decode_attention.launches
        # the prefix reads: K1b, or K5 under the window (a causal read of
        # a quantized cache), each behind its guarded K1
        prefix_form = "kmajor" if window else "bound"
        expect = dict(online=own, bound=0, kmajor=0, fallback=n_prefix)
        expect[prefix_form] = n_prefix
        with _serving_on_plain_attention():
            lg_p, toks_p, steps_p, _, _ = serve(m, cache)
        e_lg = ctx.diff(lg, lg_p)
        dep, tie_ok = departure(
            toks, toks_p, lambda s: lg_p if s == 0 else steps_p[s - 1],
            gate_of(lg_p))
        print(f"[gemma-f32] prefill_chunked {label}: B={BATCH} x "
              f"{LONG_PROMPT} tokens in chunks of {LONG_CHUNK}, then {new} "
              f"greedy steps: launches {counts} (expect {expect}), K6 "
              f"{n_dec} (expect {n_layers * new}); last-chunk logits vs "
              f"plain attention max|d| {e_lg:.3e} (gate "
              f"{gate_of(lg_p):.3e}); greedy tokens equal to the plain "
              f"run's {(toks == toks_p).float().mean().item():.4f}{dep}; "
              f"chunked prefill {p_s * 1e3:.3f} ms "
              f"({BATCH * LONG_PROMPT / p_s:.0f} prompt tok/s), decode "
              f"{d_s / new * 1e3:.3f} ms/step ({BATCH * new / d_s:.1f} "
              f"tok/s) ({card})", flush=True)
        _check(counts == expect and n_dec == n_layers * new,
               f"gemma fp32 chunked {label}: launches {counts}, K6 {n_dec}")
        _check(bool(torch.isfinite(lg).all()) and e_lg <= gate_of(lg_p),
               f"gemma fp32 chunked {label}: logits vs plain {e_lg:.3e}")
        _check(tie_ok, f"gemma fp32 chunked {label}: tokens depart from "
               f"the plain run{dep}")
        count("K1 f32 d256", counts["online"])
        count("K1b f32 d256", counts["bound"])
        count("K5 f32 d256", counts["kmajor"])
        count("K6 d256", n_dec)
        del lg_p, steps_p, steps
    print(f"[gemma-f32] peak allocated over the chunked runs {peak:.2f} GiB "
          f"({card})", flush=True)

    # where one chunked prefill's time goes (fp32 cache)
    try:
        prof = kernel_times(lambda: prefill(model, "fp32"), iters=1)
    except RuntimeError as e:  # the profiler's windows all came back empty
        print(f"[gemma-f32] profile of one chunked prefill: not measured "
              f"({e})", flush=True)
        del model
        return
    groups = {}
    for kname, t in prof.ms.items():
        groups[_group_of(kname)] = groups.get(_group_of(kname), 0.0) + t
    print(f"[gemma-f32] profile of one chunked prefill over the fp32 cache: "
          f"{sum(prof.count.values())} kernels, device busy "
          f"{prof.busy_ms:.3f} ms of a profiled wall of {prof.wall_ms:.3f} "
          f"ms ({prof.busy_ms / prof.wall_ms:.1%}): "
          + ", ".join(f"{g} {t:.3f} ms ({t / prof.busy_ms:.1%})"
                      for g, t in sorted(groups.items(),
                                         key=lambda kv: -kv[1]))
          + f" ({card})", flush=True)
    del model


# ---------------------------------------------------------------------------
# Phase 29: fp32 at d = 256 in the backward (K4, K2 + K3), K9 at d = 256
# and between builds, an fp32 ring attention at d = 256, and the fp32
# Gemma-width model trained
# ---------------------------------------------------------------------------

# the fp32 Gemma-width model's gates against the plain attention functions:
# the loss relative, every gradient in relative L2
F32_LOSS_REL_GATE = 1e-4
F32_GRAD_GATE = 1e-3
# the fp32 ring attention at d = 256: 4 ranks, shards of the training T
F32_RING_N = 4 * GEMMA_TRAIN_T


def _phase_wide_ring(ctx):
    """K9 at d = 256 and between builds. Its paths: the example stage at d =
    256 (bf16, `--width 256`; row "K9 d256") and `device_ring_matmul` on
    fp32 shards at the example's n=4 L=1024 d=256 (row "K9 f32 d256"),
    launches counted. Then at n=4 L=1024 and n=8 L=8192, d = 256, in bf16
    and fp32, and at n=4 L=1024 d = 200 (x and W zero-padded to 256):
    against the plain ring and tile((Σ x_i) @ W) in fp32 (bf16 within
    min(K9_GATE, REL_GATE · max |ref|), fp32 within F32_GATE · max(1,
    max |ref|)), 5 repeats bit for bit; the kernel's ms (torch.profiler),
    its bound (`_k9_bound`), the plain ring's ms and one `torch.einsum`
    over the shards (TF32 off)."""
    torch = ctx.torch
    from cuda_flashattention_torch.examples import device_ring as stage
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    dev, card = ctx.dev, ctx.card
    gen = torch.Generator(device=dev).manual_seed(30)

    def draw(dtype, *shape):
        return (torch.rand(shape, generator=gen, device=dev) - 0.5).to(dtype)

    ctx.zero_counts()
    rc = stage.main(["--ranks", "4", "--width", "256"])
    n = device_ring_matmul.launches
    ctx.launches["K9 d256"] += n
    print(f"[K9 d256] the example stage at d=256 returned {rc}; K9 "
          f"launches {n}", flush=True)
    _check(rc == 0 and n > 0, f"the device-ring stage at d=256 returned "
           f"{rc} after {n} launches")
    mesh4 = _shared_card_mesh(ctx, 4)
    x, w = draw(torch.float32, 4 * K9_SHAPES[0], 256), draw(
        torch.float32, 256, 256)
    ctx.zero_counts()
    device_ring_matmul(x, w, mesh4)
    torch.cuda.synchronize()
    n = device_ring_matmul.launches
    ctx.launches["K9 f32 d256"] += n
    _check(n == 1, f"fp32 K9 d=256 path: {n} launches")
    for dtype, row in ((torch.bfloat16, "K9 d256"),
                       (torch.float32, "K9 f32 d256")):
        f32 = dtype == torch.float32
        for n, rows, d in ((4, K9_SHAPES[0], 256), (8, K9_SHAPES[1], 256),
                           (4, K9_SHAPES[0], 200)):
            ring_devices = [dev] * n
            mesh = _shared_card_mesh(ctx, n)
            x, w = draw(dtype, n * rows, d), draw(dtype, d, d)
            o = device_ring_matmul(x, w, mesh)
            torch.cuda.synchronize()
            grid = device_ring_matmul.last_grid
            ref = (x.float().view(n, rows, d).sum(0) @ w.float()).repeat(n, 1)
            top = ref.abs().max().item()
            gate = (F32_GATE * max(1.0, top) if f32
                    else min(K9_GATE, REL_GATE * top))
            o_p = ring_matmul_plain(x, w, mesh)
            errs = [ctx.diff(o, ref), ctx.diff(o, o_p)]
            same = sum(torch.equal(device_ring_matmul(x, w, mesh), o)
                       for _ in range(5))
            ms_k = _device_ms_by_kernel(
                lambda: device_ring_matmul(x, w, mesh), ("K9",),
                iters=K9_ITERS)["K9"]
            ms_p = cuda_time_ms(lambda: ring_matmul_plain(x, w, mesh),
                                iters=K9_ITERS)
            x3 = x.view(n, rows, d)
            ms_lib = cuda_time_ms(lambda: torch.einsum("nld,de->le", x3, w),
                                  iters=K9_ITERS)
            bound = _k9_bound(ring_devices, rows, d, f32=f32)
            print(f"[K9 d256] {'fp32' if f32 else 'bf16'} n={n} ranks "
                  f"(sharing card 0), L={rows} d={d}: grid {grid[0]} spans "
                  f"x {grid[1]} ranks; vs tile((sum x_i) @ W) {errs[0]:.3e},"
                  f" vs the plain ring {errs[1]:.3e} (gate {gate:.3e}, max"
                  f"|ref| {top:.3e}); repeats equal {same}/5; kernel "
                  f"{ms_k:.4f} ms ({_vs_bound(ms_k, bound)}), plain ring "
                  f"{ms_p:.4f} ms, one einsum {ms_lib:.4f} ms ({card})",
                  flush=True)
            _check(top > 0 and max(errs) <= gate and same == 5
                   and bool(torch.isfinite(o).all()),
                   f"K9 {dtype} n={n} L={rows} d={d}: {errs} (gate "
                   f"{gate:.3e}), {same}/5 repeats")
            r = ctx.rec[row]
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            if (n, rows, d) == (4, K9_SHAPES[0], 256):  # the paths' shape
                r.update(ms=ms_k, plain_ms=ms_p, library_ms=ms_lib, **bound)
            del x, w, o, o_p, ref, x3


def _phase_f32_wide_ring_attention(ctx):
    """One fp32 `ring_attention` forward and backward at d = 256 over 4
    ranks sharing card 0: B=1, 8 query heads over 4 KV heads,
    N = F32_RING_N (shards of 4096, the training T), causal; against one
    `flash_attention` call on the whole sequence: O within F32_GATE, each
    gradient at the ring's gates (`_phase_ring_attention`: O within
    min(GATE, REL_GATE · max |ref|), each gradient within BWD_GATE · max
    |ref|; the line also gives each as a share of max |ref|, ~1e-4 in
    fp32, where the two sum 16384 rows' products in other orders);
    forward launches and K4 launches 10 each (the causal ring's 4 · 5 / 2
    steps), counted under the fp32 d = 256 rows; ring and one-call
    ms."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops.attention import flash_attention
    from cuda_flashattention_torch.parallel.ring import ring_attention
    from cuda_flashattention_torch.utils.timing import cuda_time_ms
    n_ranks, n, d = RING_RANKS, F32_RING_N, GEMMA_KW["d_head"]
    h, hkv = GEMMA_KW["n_heads"], GEMMA_KW["n_kv_heads"]
    mesh = _shared_card_mesh(ctx, n_ranks)
    gen = torch.Generator(device=ctx.dev).manual_seed(31)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=ctx.dev) - 0.5

    q = u(1, h, n, d).requires_grad_()
    k, v = u(1, hkv, n, d).requires_grad_(), u(1, hkv, n, d).requires_grad_()
    do = u(1, h, n, d)
    ctx.zero_counts()
    o = ring_attention(q, k, v, mesh, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    forms = dict(ctx.fwd_forms)
    n_fwd = forms["online"] + forms["bound"] + forms["kmajor"]
    n_bwd = ctx.bwd_launches["fused"]
    for form, row in (("online", "K1 f32 d256"), ("bound", "K1b f32 d256"),
                      ("kmajor", "K5 f32 d256")):
        ctx.launches[row] += forms[form]
    ctx.launches["K4 f32 d256"] += n_bwd
    ctx.launches["prologue d256"] += ctx.bwd_launches["delta"]
    o_ref = flash_attention(q, k, v, causal=True)
    grads_ref = torch.autograd.grad(o_ref, (q, k, v), do)
    e_o, top = ctx.diff(o, o_ref), o_ref.abs().max().item()
    line = []
    ok = (top > 0 and e_o <= min(GATE, REL_GATE * top)
          and bool(torch.isfinite(o).all()))
    for name, g, w in zip(("dQ", "dK", "dV"), grads, grads_ref):
        e, ref = ctx.diff(g, w), w.abs().max().item()
        line.append(f"{name} {e:.3e} ({e / ref:.1e} of max|ref| {ref:.3e})")
        ok = (ok and ref > 0 and e <= BWD_GATE * ref
              and bool(torch.isfinite(g).all()))
    expect = n_ranks * (n_ranks + 1) // 2
    t = {}
    for name, fn in (("ring", lambda *a, **kw: ring_attention(
            *a, mesh=mesh, **kw)), ("one call", flash_attention)):
        t[name] = cuda_time_ms(lambda: torch.autograd.grad(
            fn(q, k, v, causal=True), (q, k, v), do), iters=2, warmup=1)
    print(f"[f32-ring-d256] B=1 H={h} Hkv={hkv} N={n} d={d} fp32 over "
          f"{n_ranks} ranks sharing card 0, causal: forward launches {n_fwd} "
          f"(online {forms['online']}, bound {forms['bound']}, K-major "
          f"{forms['kmajor']}), K4 {n_bwd} (expect {expect} each); vs one "
          f"call: max|dO| {e_o:.3e} (max|O| {top:.3e}; gate min({GATE}, "
          f"{REL_GATE} x max|O|)), gradients max|diff| {', '.join(line)} "
          f"(gate {BWD_GATE} x max|ref|); forward+backward ring "
          f"{t['ring']:.3f} ms, one call {t['one call']:.3f} ms "
          f"({ctx.card})", flush=True)
    _check(ok, f"fp32 ring at d=256: O {e_o:.3e}, gradients {line}")
    _check(n_fwd == expect and n_bwd == expect
           and ctx.bwd_launches["dkdv"] == ctx.bwd_launches["dq"] == 0,
           f"fp32 ring at d=256 launch counts {forms} {ctx.bwd_launches}")


def _phase_gemma_f32_training(ctx):
    """Main path of training an fp32 model at Gemma 2 2B's widths
    (`TransformerConfig(dtype=torch.float32, **GEMMA_KW)`: 26 layers,
    d_model 2304, 8 query heads over 4 KV heads of d_head 256, d_ff 9216,
    vocab 256000; seeded weights, 9.74 GiB in fp32), B=1 x T=4096 tokens,
    one seeded batch: `make_train_step` with SGD(1e-4), 2 warm-up steps
    then 5 timed ones at full depth: median step ms, tokens/s, TFLOP/s as
    bench.py counts a step, peak GiB; launches over the timed steps K1 =
    K4 = the prologue = 26 x 5 (the fp32 d = 256 builds: rows "K1 f32
    d256", "K4 f32 d256", "prologue d256"), K2 = K3 = 0; a profile of one
    step by kernel group. The loss and every gradient of one step against
    the same step on the plain attention functions, at full depth (the
    kernels' gradients wait on the host while the plain step runs): loss
    within F32_LOSS_REL_GATE relative, each gradient within F32_GRAD_GATE
    relative L2; one step through the split backward (K2 = K3 = 26; rows
    "K2 f32 d256", "K3 f32 d256") against the fused one at the same
    gates; the windowed model (`cfg.window` = 1024) the same way; then
    10 Adam(1e-3) steps, also at full depth (the moments' 19.5 GiB fit:
    ~66 GiB), that must lower the loss, and their peak GiB. No depth or
    width is cut."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops import attention
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward, flash_attention_backward_plain)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward, flash_attention_forward_plain)
    from cuda_flashattention_torch.utils.profiling import kernel_times
    from cuda_flashattention_torch.utils.timing import attention_flops
    dev, card, launches = ctx.dev, ctx.card, ctx.launches
    bwd_launches = ctx.bwd_launches
    t = GEMMA_TRAIN_T
    cfg = tfm.TransformerConfig(dtype=torch.float32,
                                **{**GEMMA_KW, "max_seq": t})
    n = cfg.n_layers

    def fresh(c):
        return tfm.Transformer(
            c, generator=torch.Generator(device=dev).manual_seed(29))

    model = fresh(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (1, t), device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(30),
                           dtype=torch.int32)
    print(f"[gemma-f32-train] {n_params / 1e9:.3f}B parameters "
          f"({_nbytes(*model.parameters()) / 2**30:.2f} GiB in fp32), {n} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads of d_head {cfg.d_head}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; B=1 T={t}, fp32 (TF32 off), "
          f"SGD(1e-4) ({card})", flush=True)
    train_flops = (6.0 * n_params * t
                   + 3 * attention_flops(1, cfg.n_heads, t, t, cfg.d_head,
                                         causal=True) * n)

    rows = dict(fwd=["K1 f32 d256"], fused=["K4 f32 d256"],
                delta=["prologue d256"])

    def timed_steps(m, tag):
        return _timed_train_steps(ctx, m, tokens, tag, train_flops, rows)

    names = [nm for nm, _ in model.named_parameters()]

    def step_grads(m):
        """The loss of one forward and backward of m, its gradients left
        in the parameters' .grad."""
        m.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(m, tokens)
        loss.backward()
        return loss.item()

    def on_host(m):
        """m's gradients copied to the host, and dropped on the card."""
        grads = [p.grad.to("cpu") for p in m.parameters()]
        m.zero_grad(set_to_none=True)
        return grads

    def rel_l2(m, ref_host):
        """The worst relative L2 distance of m's gradients from ref_host
        (the reference), and its parameter's name; drops m's."""
        errs = []
        for p, r in zip(m.parameters(), ref_host):
            r = r.to(dev)
            errs.append(((p.grad - r).norm() / r.norm()).item())
        m.zero_grad(set_to_none=True)
        i = max(range(len(errs)), key=errs.__getitem__)
        return errs[i], names[i]

    plain_bwd = (lambda q, k, v, o, lse, do, block_sizes=None, fused=None,
                 **kw:
                 flash_attention_backward_plain(q, k, v, o, lse, do, **kw))

    def against_plain(m, tag):
        """The loss and every gradient of one step on the plain attention
        functions against the same through the kernels; the kernels'
        (loss, gradients on the host)."""
        loss_k = step_grads(m)
        grads_k = on_host(m)
        with mock.patch.object(attention, "flash_attention_forward",
                               flash_attention_forward_plain), \
                mock.patch.object(attention, "flash_attention_backward",
                                  plain_bwd):
            loss_p = step_grads(m)
        errs = []
        for p, gk in zip(m.parameters(), grads_k):
            errs.append(((gk.to(dev) - p.grad).norm()
                         / p.grad.norm()).item())
        m.zero_grad(set_to_none=True)
        i = max(range(len(errs)), key=errs.__getitem__)
        e_grad, worst = errs[i], names[i]
        e_loss = abs(loss_k - loss_p) / abs(loss_p)
        print(f"[{tag}] kernels vs plain attention ({m.cfg.n_layers} "
              f"layers): loss {loss_k:.7f} vs {loss_p:.7f} (relative "
              f"{e_loss:.3e}, gate {F32_LOSS_REL_GATE}); worst gradient "
              f"relative L2 {e_grad:.3e} ({worst}; gate {F32_GRAD_GATE}; "
              f"the bf16 model's gate in phase 27: {GRAD_GATE}) ({card})",
              flush=True)
        _check(e_loss <= F32_LOSS_REL_GATE,
               f"{tag}: kernel vs plain loss {loss_k} vs {loss_p}")
        _check(e_grad <= F32_GRAD_GATE, f"{tag}: kernel vs plain gradient "
               f"of {worst}: relative L2 {e_grad:.3e}")
        return loss_k, grads_k

    # ---- the timed steps, a profile, the plain comparison, the split path
    step = timed_steps(model, "gemma-f32-train")
    prof = kernel_times(lambda: step(tokens))
    groups = {}
    for nm, ms in prof.ms.items():
        groups[_group_of(nm)] = groups.get(_group_of(nm), 0.0) + ms
    print(f"[gemma-f32-train] profile of one step: "
          f"{sum(prof.count.values())} kernels, device busy "
          f"{prof.busy_ms:.3f} ms of a profiled wall of {prof.wall_ms:.3f} "
          f"ms ({prof.busy_ms / prof.wall_ms:.1%})"
          + "".join(f"; {g} {ms:.3f} ms ({ms / prof.busy_ms:.1%})"
                    for g, ms in sorted(groups.items(),
                                        key=lambda kv: -kv[1]))
          + f" ({card})", flush=True)
    del step
    torch.cuda.empty_cache()
    loss_k, grads_k = against_plain(model, "gemma-f32-train")
    ctx.zero_counts()
    with mock.patch.object(attention, "flash_attention_backward",
                           functools.partial(flash_attention_backward,
                                             fused=False)):
        loss_s = step_grads(model)
    torch.cuda.synchronize()
    counts = dict(fwd=flash_attention_forward.launches, **bwd_launches)
    e_split, worst = rel_l2(model, grads_k)
    del grads_k
    e_loss = abs(loss_s - loss_k) / abs(loss_k)
    print(f"[gemma-f32-train] split backward: launches K1 {counts['fwd']}, "
          f"K2 {counts['dkdv']}, K3 {counts['dq']}, K4 {counts['fused']}, "
          f"the prologue {counts['delta']} (expect {n} each, K4 0); loss "
          f"{loss_s:.7f} (relative {e_loss:.3e} to the fused step's); worst "
          f"gradient relative L2 to the fused backward {e_split:.3e} "
          f"({worst}; gate {F32_GRAD_GATE})", flush=True)
    _check(counts == dict(fwd=n, fused=0, dkdv=n, dq=n, delta=n),
           f"gemma fp32 split-backward launch counts {counts}")
    _check(e_loss <= F32_LOSS_REL_GATE and e_split <= F32_GRAD_GATE,
           f"gemma fp32 split vs fused backward: loss {loss_s} vs {loss_k}, "
           f"gradient of {worst} {e_split:.3e}")
    for row, c in (("K1 f32 d256", counts["fwd"]),
                   ("K2 f32 d256", counts["dkdv"]),
                   ("K3 f32 d256", counts["dq"]),
                   ("prologue d256", counts["delta"])):
        launches[row] += c
    del model
    torch.cuda.empty_cache()

    # ---- the windowed model (cfg.window = 1024)
    wmodel = fresh(dataclasses.replace(cfg, window=LONG_WINDOW))
    wstep = timed_steps(wmodel, f"gemma-f32-wtrain window {LONG_WINDOW}")
    del wstep
    torch.cuda.empty_cache()
    against_plain(wmodel, f"gemma-f32-wtrain window {LONG_WINDOW}")
    del wmodel
    torch.cuda.empty_cache()

    # ---- loss falls: 10 Adam steps on a fresh model and the same batch
    # (foreach=False: the moments are updated a tensor at a time, with no
    # temporaries the size of every parameter)
    model = fresh(cfg)
    step = tfm.make_train_step(model, torch.optim.Adam(
        model.parameters(), lr=1e-3, foreach=False))
    torch.cuda.reset_peak_memory_stats()
    adam = [step(tokens).item() for _ in range(ADAM_STEPS)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[gemma-f32-train] Adam(1e-3), {ADAM_STEPS} steps, {n} "
          f"layers: losses "
          f"{', '.join(f'{x:.4f}' for x in adam)}; peak memory {peak:.2f} "
          f"GiB ({card})", flush=True)
    _check(all(math.isfinite(x) for x in adam) and adam[-1] < adam[0],
           f"gemma fp32 Adam losses did not fall: {adam}")
    del model, step


def _phase_utils(ctx):
    """Checkpoint, trace, kernel report, memory snapshot and monitor on
    the card. The 271M training config takes 2 `make_train_step` steps
    (SGD with momentum, so the optimizer has state; K1 and K4 once per
    layer and step), is saved with `utils/checkpoint.py`, restored into a
    fresh model and optimizer, and each copy takes one more step through
    the split backward (K2 + K3, which add no atomics, so the two copies
    can be held bit for bit): losses, gradients and parameters equal.
    Then one fused step under `utils/profiling.trace` + `annotate`, whose
    Chrome trace must name K1 and K4; one `kernel_report` of K1 at [1, 16,
    4096, 128] causal at `device_peaks`' rates; a memory snapshot
    (`save_device_memory_profile`) and `memory_stats`; one `poll_once`."""
    import os
    import pickle
    import tempfile
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops import attention
    from cuda_flashattention_torch.ops import flash_bwd as fb
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    from cuda_flashattention_torch.utils import checkpoint as ckpt
    from cuda_flashattention_torch.utils.monitor import poll_once
    from cuda_flashattention_torch.utils.profiling import (
        TRACE_FILE, annotate, kernel_report, save_device_memory_profile,
        trace)
    from cuda_flashattention_torch.utils.timing import (
        attention_flops, cuda_time_ms, device_peaks, memory_stats)
    dev, card = ctx.dev, ctx.card
    tcfg = tfm.TransformerConfig(**TRAIN_KW)
    gen = torch.Generator(device=dev).manual_seed(25)
    tokens = torch.randint(0, tcfg.vocab_size, (1, TRAIN_T), generator=gen,
                           device=dev)

    def fresh(seed):
        m = tfm.Transformer(tcfg, generator=torch.Generator(
            device=dev).manual_seed(seed))
        opt = torch.optim.SGD(m.parameters(), lr=1e-4, momentum=0.9)
        return m, opt, tfm.make_train_step(m, opt)

    model, opt, step = fresh(0)
    ctx.zero_counts()
    losses = [step(tokens).item() for _ in range(2)]
    torch.cuda.synchronize()
    counts = dict(ctx.bwd_launches)
    n_fwd = _forward_launches(ctx, add=False)
    _check(n_fwd == 2 * tcfg.n_layers and counts["fused"] == 2 * tcfg.n_layers,
           f"checkpointed training: forward {n_fwd}, backward {counts}")
    ctx.launches["K1"] += n_fwd
    ctx.launches["K4"] += counts["fused"]
    ctx.launches["K4 D prologue"] += counts["delta"]
    split = mock.patch.object(attention, "flash_attention_backward",
                              functools.partial(fb.flash_attention_backward,
                                                fused=False))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = ckpt.save(os.path.join(tmp, "step2"),
                         {"model": model.state_dict(),
                          "opt": opt.state_dict()})
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        model2, opt2, step2 = fresh(1)
        step2(tokens)  # builds the optimizer state that `like` shows
        t0 = time.perf_counter()
        state = ckpt.restore(path, {"model": model2.state_dict(),
                                    "opt": opt2.state_dict()})
        model2.load_state_dict(state["model"])
        opt2.load_state_dict(state["opt"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    same_params = all(torch.equal(a, b_) for a, b_ in
                      zip(model.parameters(), model2.parameters()))
    ctx.zero_counts()
    with split:
        loss_a = step(tokens).item()
        loss_b = step2(tokens).item()
    torch.cuda.synchronize()
    split_counts = dict(ctx.bwd_launches)
    same_grads = all(torch.equal(a.grad, b_.grad) for a, b_ in
                     zip(model.parameters(), model2.parameters()))
    same_after = all(torch.equal(a, b_) for a, b_ in
                     zip(model.parameters(), model2.parameters()))
    print(f"[checkpoint] 271M config, 2 SGD(momentum) steps (losses "
          f"{losses[0]:.4f}, {losses[1]:.4f}): saved {size / 2**20:.1f} MiB "
          f"in {save_s * 1e3:.1f} ms, restored into a fresh model in "
          f"{restore_s * 1e3:.1f} ms; parameters equal {same_params}; one "
          f"more step each (K2 {split_counts['dkdv']}, K3 "
          f"{split_counts['dq']}): loss {loss_a:.6f} vs {loss_b:.6f}, "
          f"gradients equal {same_grads}, parameters after equal "
          f"{same_after} ({card})", flush=True)
    _check(same_params and loss_a == loss_b and same_grads and same_after
           and split_counts["dkdv"] == split_counts["dq"]
           == 2 * tcfg.n_layers,
           "the restored model does not resume the run")
    ctx.launches["K2"] += split_counts["dkdv"]
    ctx.launches["K3"] += split_counts["dq"]
    ctx.launches["K1"] += _forward_launches(ctx, add=False)
    ctx.launches["K4 D prologue"] += split_counts["delta"]
    del model2, opt2, step2, state

    with tempfile.TemporaryDirectory() as tmp:
        ctx.zero_counts()
        with trace(tmp):
            with annotate("train_step"):
                step(tokens)
                torch.cuda.synchronize()
        events = json.load(open(os.path.join(tmp, TRACE_FILE)))[
            "traceEvents"]
        names = {e.get("name", "") for e in events}
        labels = {_kernel_of(n) for n in names} - {""}
        counts = dict(ctx.bwd_launches)
        n_fwd = _forward_launches(ctx)
        ctx.launches["K4"] += counts["fused"]
        ctx.launches["K4 D prologue"] += counts["delta"]
        print(f"[trace] one train step under utils.profiling.trace: "
              f"{len(events)} events in {TRACE_FILE}, package kernels "
              f"{sorted(labels)}, annotation present "
              f"{'train_step' in names} ({card})", flush=True)
        _check({"K1", "K4"} <= labels and "train_step" in names,
               f"the trace names {sorted(labels)}")
    del model, opt, step

    q = ctx.mk(1, 16, TRAIN_T, 128, peak=Q_PEAK)
    k, v = ctx.mk(1, 16, TRAIN_T, 128, peak=K_PEAK), ctx.mk(1, 16, TRAIN_T,
                                                           128)
    ms = cuda_time_ms(lambda: flash_attention_forward(q, k, v, causal=True))
    peaks = device_peaks()
    report = kernel_report(
        "K1 [1, 16, 4096, 128] causal bf16", ms / 1e3,
        attention_flops(1, 16, TRAIN_T, TRAIN_T, 128, causal=True),
        _nbytes(q, k, v, q) + 16 * TRAIN_T * 4)
    print(f"[kernel_report] device_peaks {peaks} ({card})", flush=True)
    _check(math.isfinite(report["tflops"]) and report["tflops"] > 0,
           f"kernel_report {report}")
    del q, k, v

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "memory.pickle")
        save_device_memory_profile(path)
        snapshot = pickle.load(open(path, "rb"))
        n_seg = len(snapshot.get("segments", []))
        stats = memory_stats()
        print(f"[memory] snapshot: {n_seg} segments, "
              f"{os.path.getsize(path)} bytes; memory_stats: "
              f"{len(stats)} keys, in use "
              f"{stats.get('allocated_bytes.all.current', 0) / 2**30:.2f} "
              f"GiB, peak {stats.get('allocated_bytes.all.peak', 0) / 2**30:.2f}"
              f" GiB, bytes_limit {stats.get('bytes_limit', 0) / 2**30:.2f} "
              f"GiB ({card})", flush=True)
        _check(n_seg > 0 and stats.get("bytes_limit", 0) > 0,
               "no memory snapshot or counters")
    rows = poll_once()
    _check(len(rows) == ctx.torch.cuda.device_count() and rows[0][3] > 0,
           f"poll_once gave {rows}")


# The tuning phase (17): the tuners' shapes, the training shape the
# 128-key K1 is held at, and the timed iterations per candidate (few: the
# sweep is a check that every built tile runs and of the cache)
TUNE_ITERS = 5
TUNE_FWD = (1, 16, 16, 4096, 128)  # B, H, Hkv, N, d: causal
TUNE_DECODE = (8, 16, 4, 4352, 4224, 128)  # B, H, Hkv, capacity, live, d
TUNE_SEG_N = 1024
TUNE_DECODE_STEPS = 16


def _vs_bound(ms, bound):
    """A row's time as a share of its bound, for its printed line."""
    return (f"{100 * bound['bound_ms'] / ms:.1f}% of its bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")


def _tuner_sweeps(ctx, autotune):
    """Print every measured sweep; fail on a candidate that did not run."""
    for key, sweep in autotune.sweeps.items():
        what = json.loads(key)[3:]
        line = ", ".join(f"{c}: " + ("FAILED" if ms is None else f"{ms:.4f}")
                         for c, ms in sweep)
        print(f"[tuning] sweep {what}: {line} ms ({ctx.card})", flush=True)
        _check(all(ms is not None for _, ms in sweep),
               f"tuner sweep {what}: a candidate failed: {line}")


def _phase_tuning(ctx):
    """The tuning path. The tuners of `utils/autotune.py` over a
    temporary `CFA_AUTOTUNE_CACHE`: "fwd" and "bwd" at [1, 16, 4096, 128]
    causal, the decode split size at B=8 H=16 Hkv=4 with 4224 live tokens
    of 4352, the page size at the same context. Every candidate must run
    (a failure fails the phase, though the tuner only skips it) and match
    the plain version; a second call must hit the cache (the timer then
    raises). The 128-key builds of K1 (training shape causal, not causal,
    window 1024; segment ids at N=1024) and K1b (the chunked-prefill
    prefix) against the plain version and their 64-key builds, with
    times, bounds and SDPA's time; the backward's prologue (D and K4's
    zeroed accumulator) against the plain D, timed, and one CUDA backward
    under torch.profiler with no aten::sum / zeros / zero_. Then the 246M
    serving config's `prefill` (B=8 × 512) and `prefill_chunked` (B=8 ×
    4096, chunk 512, bf16 cache) with the tuned tiles and, where the
    tuner kept 64 keys, again at 128 keys; then `decode_one` steps with
    the tuned split size; logits against the plain path at LOGIT_GATE."""
    torch = ctx.torch
    import os
    import tempfile
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops import flash_bwd as fb
    from cuda_flashattention_torch.ops.common import BlockSizes
    from cuda_flashattention_torch.ops.decode import (
        decode_attention, decode_attention_plain)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward, flash_attention_forward_plain)
    from cuda_flashattention_torch.ops.paged import (
        paged_decode_attention, paged_decode_attention_plain)
    from cuda_flashattention_torch.utils import autotune
    from cuda_flashattention_torch.utils.timing import (
        attention_flops, cuda_time_ms)
    dev, card, mk, diff = ctx.dev, ctx.card, ctx.mk, ctx.diff
    rec, launches = ctx.rec, ctx.launches
    key128 = flash_attention_forward.key128_launches

    # ---- the tuners -----------------------------------------------------
    b, h, hkv, n, d = TUNE_FWD
    db, dh, dhkv, cap, live, dd = TUNE_DECODE
    saved = os.environ.get("CFA_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CFA_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
        try:
            autotune._MEM_CACHE.clear()
            autotune.sweeps.clear()
            shape = dict(nq=n, nk=n, d=d, batch=b, heads=h, kv_heads=hkv,
                         causal=True, iters=TUNE_ITERS)
            dshape = dict(ctx=cap, heads=dh, kv_heads=dhkv, d=dd, batch=db,
                          live=live, iters=TUNE_ITERS)
            t0 = time.perf_counter()
            fwd = autotune.autotune_block_sizes(**shape)
            bwd = autotune.autotune_block_sizes(mode="bwd", **shape)
            split = autotune.autotune_decode_block_k(**dshape)
            page = autotune.autotune_page_size(**dshape)
            tune_s = time.perf_counter() - t0
            _tuner_sweeps(ctx, autotune)
            print(f"[tuning] winners: fwd {fwd}, bwd ({bwd.block_q_bwd}, "
                  f"{bwd.block_k_bwd}), decode block_k {split}, page size "
                  f"{page}; the four sweeps took {tune_s:.2f} s ({card})",
                  flush=True)
            _check(len(autotune._disk_cache_load()) == 4,
                   "the tuners' winners were not all written to the cache")
            # a second call measures nothing: from the process's cache,
            # then from the disk's
            real = autotune.time_fn

            def poisoned(*a, **k):
                raise RuntimeError("the tuner measured on a cached key")
            autotune.time_fn = poisoned
            try:
                for _ in range(2):
                    _check(autotune.autotune_block_sizes(**shape) == fwd
                           and autotune.autotune_block_sizes(
                               mode="bwd", **shape) == bwd
                           and autotune.autotune_decode_block_k(
                               **dshape) == split
                           and autotune.autotune_page_size(**dshape) == page,
                           "a second tuner call did not return the winner")
                    autotune._MEM_CACHE.clear()
            finally:
                autotune.time_fn = real
            print("[tuning] second calls: every winner from the cache, the "
                  "timer untouched (process cache, then the disk's)",
                  flush=True)
        finally:
            if saved is None:
                os.environ.pop("CFA_AUTOTUNE_CACHE", None)
            else:
                os.environ["CFA_AUTOTUNE_CACHE"] = saved
    _check(fwd.block_k in (64, 128) and fwd.block_q == 128
           and (bwd.block_q_bwd, bwd.block_k_bwd) == (64, 128)
           and split in autotune.decode_candidates(cap)
           and page in autotune.page_candidates(cap),
           f"tuners returned an unbuilt choice {fwd} {bwd} {split} {page}")

    # ---- every candidate against the plain version ----------------------
    q, k, v = (mk(b, h, n, d, peak=Q_PEAK), mk(b, hkv, n, d, peak=K_PEAK),
               mk(b, hkv, n, d))
    do = mk(b, h, n, d)
    want = flash_attention_forward_plain(q, k, v, causal=True)
    for bq, bk in autotune.candidate_blocks(n, n, d, causal=True):
        got = flash_attention_forward(q, k, v, causal=True,
                                      block_sizes=BlockSizes(bq, bk))
        torch.cuda.synchronize()
        (e_o, ref, ok), e_l = ctx.o_close(got[0], want[0]), diff(got[1],
                                                                 want[1])
        print(f"[tuning] fwd candidate ({bq}, {bk}): vs plain max|dO| "
              f"{e_o:.3e} (max|O| {ref:.3e}) max|dLSE| {e_l:.3e}",
              flush=True)
        _check(ok and e_l <= GATE, f"fwd candidate ({bq}, {bk}) vs plain")
    o, lse = flash_attention_forward(q, k, v, causal=True)
    want_g = fb.flash_attention_backward_plain(q, k, v, o, lse, do,
                                               causal=True)
    for bq, bk in autotune.candidate_blocks(n, n, d, causal=True,
                                            mode="bwd"):
        got = fb.flash_attention_backward(
            q, k, v, o, lse, do, causal=True,
            block_sizes=BlockSizes(block_q_bwd=bq, block_k_bwd=bk))
        torch.cuda.synchronize()
        line = _grads_close(ctx, got, want_g, f"bwd candidate ({bq}, {bk})")
        print(f"[tuning] bwd candidate ({bq}, {bk}): vs plain {line}",
              flush=True)
    del want, want_g
    dq = mk(db, dh, dd, peak=Q_PEAK)
    dk, dv = mk(db, dhkv, cap, dd, peak=K_PEAK), mk(db, dhkv, cap, dd)
    lengths = torch.full((db,), live, dtype=torch.int32, device=dev)
    want = decode_attention_plain(dq, dk, dv, lengths)
    for bk in autotune.decode_candidates(cap):
        got = decode_attention(dq, dk, dv, lengths, block_k=bk)
        torch.cuda.synchronize()
        (e_o, ref, ok), e_l = ctx.o_close(got[0], want[0]), diff(got[1],
                                                                 want[1])
        _check(ok and e_l <= GATE, f"decode block_k {bk}: {e_o:.3e} / "
               f"{e_l:.3e}")
    print(f"[tuning] decode candidates {autotune.decode_candidates(cap)}: "
          f"each within the gates of the plain version", flush=True)

    def paged(x, ps):
        """The cache [B, Hkv, cap, d] as a pool of pages of `ps` keys,
        sequence b's pages b·per_seq, ..., zeros past the capacity."""
        per_seq = -(-cap // ps)
        x = torch.nn.functional.pad(x, (0, 0, 0, per_seq * ps - cap))
        return x.reshape(db, dhkv, per_seq, ps, dd).transpose(1, 2).reshape(
            db * per_seq, dhkv, ps, dd).contiguous()

    for ps in autotune.page_candidates(cap):
        pk, pv = paged(dk, ps), paged(dv, ps)
        table = torch.arange(pk.shape[0], dtype=torch.int32,
                             device=dev).reshape(db, -1)
        got = paged_decode_attention(dq, pk, pv, table, lengths)
        torch.cuda.synchronize()
        (e_o, ref, ok), e_l = ctx.o_close(got[0], want[0]), diff(got[1],
                                                                 want[1])
        _check(ok and e_l <= GATE, f"page size {ps}: {e_o:.3e} / {e_l:.3e}")
        e_p = diff(got[0], paged_decode_attention_plain(
            dq, pk, pv, table, lengths)[0])
        _check(e_p <= GATE, f"page size {ps} vs its plain version {e_p}")
        del pk, pv
    print(f"[tuning] page candidates {autotune.page_candidates(cap)}: K7 "
          f"over the same keys in pages of each size within the gates of "
          f"the plain decode", flush=True)
    del dq, dk, dv, want, got

    # ---- the 128-key builds against plain and the 64-key builds ---------
    seg_ids = torch.repeat_interleave(
        torch.arange(4, device=dev),
        torch.tensor([300, 1, 250, TUNE_SEG_N - 551], device=dev))[None]
    cases = [("4096 causal", (b, h, hkv, n, n), dict(causal=True)),
             ("4096 not causal", (b, h, hkv, n, n), dict(causal=False)),
             ("4096 window 1024", (b, h, hkv, n, n),
              dict(causal=True, window=1024)),
             ("segments 1024 causal", (1, h, hkv, TUNE_SEG_N, TUNE_SEG_N),
              dict(causal=True, q_segment_ids=seg_ids,
                   kv_segment_ids=seg_ids)),
             ("segments 1024", (1, h, hkv, TUNE_SEG_N, TUNE_SEG_N),
              dict(q_segment_ids=seg_ids, kv_segment_ids=seg_ids))]
    t128 = BlockSizes(block_k=128)
    for name, (cb, ch, chkv, cnq, cnk), kw in cases:
        q, k, v = (mk(cb, ch, cnq, d, peak=Q_PEAK),
                   mk(cb, chkv, cnk, d, peak=K_PEAK), mk(cb, chkv, cnk, d))
        kw = dict(kw, softmax="online")
        got = flash_attention_forward(q, k, v, block_sizes=t128, **kw)
        k64 = flash_attention_forward(q, k, v, **kw)
        want = flash_attention_forward_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        (e_o, ref, ok), e_l = ctx.o_close(got[0], want[0]), diff(got[1],
                                                                 want[1])
        (e_6, _, ok6), e_l6 = ctx.o_close(got[0], k64[0]), diff(got[1],
                                                                k64[1])
        rec["K1 bf16 128-key"]["max_abs_err"] = max(
            rec["K1 bf16 128-key"]["max_abs_err"], e_o, e_l)
        ms = _call_ms(lambda: flash_attention_forward(
            q, k, v, block_sizes=t128, **kw), "K1", iters=5)
        ms64 = _call_ms(lambda: flash_attention_forward(q, k, v, **kw), "K1",
                        iters=5)
        pairs = _visible_pairs(ctx, cb, ch, cnq, cnk, kw)
        bound = _bound(_nbytes(q, k, v, got[0], got[1]), 4.0 * d * pairs)
        line = (f"[tuning] K1 128-key, {name} [{cb}, {ch}, {cnq}, {d}] "
                f"Hkv={chkv}: vs plain max|dO| {e_o:.3e} (max|O| {ref:.3e}) "
                f"max|dLSE| {e_l:.3e}; vs 64-key max|dO| {e_6:.3e} max|dLSE| "
                f"{e_l6:.3e}; kernel alone {ms:.4f} ms, 64-key build "
                f"{ms64:.4f} ms ({_vs_bound(ms, bound)})")
        if name == "4096 causal":
            ms_p = cuda_time_ms(lambda: flash_attention_forward_plain(
                q, k, v, **kw), iters=3)
            lib = cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=ch != chkv),
                iters=10)
            rec["K1 bf16 128-key"].update(ms=ms, plain_ms=ms_p,
                                          library_ms=lib, **bound)
            line += f"; plain {ms_p:.4f} ms; library call {lib:.4f} ms"
        print(line + f" ({card})", flush=True)
        _check(ok and e_l <= GATE and ok6 and e_l6 <= GATE,
               f"K1 128-key {name}: plain {e_o:.3e}/{e_l:.3e}, 64-key "
               f"{e_6:.3e}/{e_l6:.3e}")
        del q, k, v, got, k64, want
    # K1b at the chunked-prefill prefix (every key visible, "auto": the
    # bound form behind its guard)
    pb, ph, phkv, pnq, pnk = 8, 16, 4, 512, LONG_PROMPT - LONG_CHUNK
    q, k, v = (mk(pb, ph, pnq, d, peak=Q_PEAK),
               mk(pb, phkv, pnk, d, peak=K_PEAK), mk(pb, phkv, pnk, d))
    kw = dict(out_dtype=torch.float32)
    before = dict(key128)
    got = flash_attention_forward(q, k, v, block_sizes=t128, **kw)
    _check(key128["bound"] == before["bound"] + 1,
           f"the prefix read did not take K1b's 128-key build: {key128}")
    k64 = flash_attention_forward(q, k, v, **kw)
    want = flash_attention_forward_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    (e_o, ref, ok), e_l = ctx.o_close(got[0], want[0]), diff(got[1], want[1])
    (e_6, _, ok6), e_l6 = ctx.o_close(got[0], k64[0]), diff(got[1], k64[1])
    ms = _call_ms(lambda: flash_attention_forward(q, k, v, block_sizes=t128,
                                                  **kw), "K1b", iters=5)
    ms64 = _call_ms(lambda: flash_attention_forward(q, k, v, **kw), "K1b",
                    iters=5)
    ms_p = cuda_time_ms(lambda: flash_attention_forward_plain(q, k, v, **kw),
                        iters=3)
    lib = _library_ms(ctx, q, k, v, {})
    bound = _bound(_nbytes(q, k, v, got[0], got[1]),
                   attention_flops(pb, ph, pnq, pnk, d))
    rec["K1b bf16 128-key"].update(
        max_abs_err=max(e_o, e_l), ms=ms, plain_ms=ms_p, library_ms=lib,
        **bound)
    print(f"[tuning] K1b 128-key, prefix B={pb} H={ph} Hkv={phkv} {pnq} x "
          f"{pnk}: vs plain max|dO| {e_o:.3e} (max|O| {ref:.3e}) max|dLSE| "
          f"{e_l:.3e}; vs 64-key max|dO| {e_6:.3e} max|dLSE| {e_l6:.3e}; "
          f"kernel alone {ms:.4f} ms, 64-key build {ms64:.4f} ms "
          f"({_vs_bound(ms, bound)}); plain {ms_p:.4f} ms; library call "
          f"{lib:.4f} ms ({card})", flush=True)
    _check(ok and e_l <= GATE and ok6 and e_l6 <= GATE,
           f"K1b 128-key prefix: plain {e_o:.3e}/{e_l:.3e}, 64-key "
           f"{e_6:.3e}/{e_l6:.3e}")
    del q, k, v, got, k64, want

    # ---- the backward's prologue ----------------------------------------
    o, do = mk(b, h, n, d), mk(b, h, n, d)
    acc = torch.full((b, h, n, d), 7.0, device=dev)
    got = fb._launch_delta(o, do, acc)
    want = fb.delta_plain(o, do)
    torch.cuda.synchronize()
    e = diff(got, want)
    gate = 1e-5 * max(1.0, want.abs().max().item())
    _check(e <= gate and torch.count_nonzero(acc).item() == 0,
           f"prologue D {e:.3e} > {gate:.3e}, or dQ's accumulator not zero")
    ms = _call_ms(lambda: fb._launch_delta(o, do, acc), "K4 D prologue",
                  iters=10)

    def plain():
        fb.delta_plain(o, do)
        torch.zeros((b, h, n, d), dtype=torch.float32, device=dev)
    ms_p = cuda_time_ms(plain, iters=10)
    lib = cuda_time_ms(lambda: (do.float() * o.float()).sum(-1), iters=10)
    bound = _bound(_nbytes(o, do, got, acc), 0.0)
    rec["K4 D prologue"].update(max_abs_err=e, ms=ms, plain_ms=ms_p,
                                library_ms=lib, **bound)
    print(f"[tuning] prologue (D and K4's zeroed accumulator) [{b}, {h}, "
          f"{n}, {d}] bf16: vs plain max|dD| {e:.3e} (gate {gate:.3e}); "
          f"kernel alone {ms:.4f} ms ({_vs_bound(ms, bound)}: O and dO read, "
          f"D and the fp32 accumulator written); plain (the reduction and "
          f"torch.zeros) {ms_p:.4f} ms; library call "
          f"(do.float() * o.float()).sum(-1) {lib:.4f} ms ({card})",
          flush=True)
    # no PyTorch reduction or zeroing is left in the CUDA backward
    q, k, v = mk(b, h, n, d), mk(b, hkv, n, d), mk(b, hkv, n, d)
    o, lse = flash_attention_forward(q, k, v, causal=True)
    fb.flash_attention_backward(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fb.flash_attention_backward(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
    ops = sorted({e.name for e in prof.events() if e.name.startswith("aten::")})
    print(f"[tuning] one CUDA backward at d={d}: aten ops {ops}", flush=True)
    _check(not set(ops) & {"aten::sum", "aten::zeros", "aten::zero_"},
           f"the CUDA backward still runs {ops}")
    del q, k, v, o, lse, do, acc, got, want

    # ---- the serving model with the tuned tiles -------------------------
    torch.cuda.empty_cache()
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **CFG_KW)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tfm.Transformer(cfg, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, LONG_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    tiles = [fwd] + ([t128] if fwd.block_k != 128 else [])
    for bs in tiles:
        ctx.zero_counts()
        caches = tfm.init_caches(cfg, BATCH, PROMPT, device=dev)
        lg, _ = tfm.prefill(model, prompt[:, :PROMPT], caches,
                            block_sizes=bs)
        caches = tfm.init_caches(cfg, BATCH, LONG_PROMPT + TUNE_DECODE_STEPS,
                                 device=dev)
        lg_c, caches = tfm.prefill_chunked(model, prompt, caches, LONG_CHUNK,
                                           block_sizes=bs)
        tokens = []
        tok = lg_c.argmax(-1)
        n_dec0 = decode_attention.launches
        for i in range(TUNE_DECODE_STEPS):
            tokens.append(tok)
            lg_d, caches = tfm.decode_one(model, tok, LONG_PROMPT + i,
                                          caches, block_k=split)
            tok = lg_d.argmax(-1)
        torch.cuda.synchronize()
        n_dec = decode_attention.launches - n_dec0
        forms, k128 = dict(ctx.fwd_forms), dict(key128)
        with _serving_on_plain_attention():
            caches = tfm.init_caches(cfg, BATCH, PROMPT, device=dev)
            lg_p, _ = tfm.prefill(model, prompt[:, :PROMPT], caches)
            caches = tfm.init_caches(cfg, BATCH,
                                     LONG_PROMPT + TUNE_DECODE_STEPS,
                                     device=dev)
            lg_cp, caches = tfm.prefill_chunked(model, prompt, caches,
                                                LONG_CHUNK)
            for i, t in enumerate(tokens):
                lg_dp, caches = tfm.decode_one(model, t, LONG_PROMPT + i,
                                               caches)
        e_p, e_c, e_d = (diff(lg, lg_p), diff(lg_c, lg_cp),
                         diff(lg_d, lg_dp))
        chunks = LONG_PROMPT // LONG_CHUNK
        print(f"[tuning] 246M serving config with block_k {bs.block_k} and "
              f"decode block_k {split}: prefill B={BATCH} x {PROMPT}, "
              f"chunked prefill B={BATCH} x {LONG_PROMPT} (chunk "
              f"{LONG_CHUNK}), {TUNE_DECODE_STEPS} decode steps; logits vs "
              f"the plain path max|d| prefill {e_p:.3e}, chunked {e_c:.3e}, "
              f"last decode step {e_d:.3e} (gate {LOGIT_GATE}); launches "
              f"{forms}, of the 128-key builds {k128}, K6 {n_dec}",
              flush=True)
        _check(max(e_p, e_c, e_d) <= LOGIT_GATE
               and all(bool(torch.isfinite(x).all()) for x in
                       (lg, lg_c, lg_d)),
               f"tuned serving logits {e_p:.3e} {e_c:.3e} {e_d:.3e}")
        _check(n_dec == cfg.n_layers * TUNE_DECODE_STEPS,
               f"tuned decode launches {n_dec}")
        expect_online = cfg.n_layers * (1 + chunks)
        _check(forms["online"] == expect_online
               and forms["bound"] == cfg.n_layers * (chunks - 1),
               f"tuned serving forward launches {forms}")
        if bs.block_k == 128:
            _check(k128["online"] == expect_online
                   and k128["bound"] == forms["bound"],
                   f"the 128-key builds were not launched on the path: "
                   f"{k128}")
            launches["K1 bf16 128-key"] += k128["online"]
            launches["K1b bf16 128-key"] += k128["bound"]
        launches["K1"] += forms["online"] - k128["online"]
        launches["K1b"] += forms["bound"] - k128["bound"]
        launches["K6"] += n_dec
    del model, caches


def _ladder_rows() -> int:
    """Rows per rank of stage 04 at the reference's shape."""
    from cuda_flashattention_torch.examples import _ladder
    n = LADDER_RANKS
    while _ladder.LADDER_SEQ % n:
        n -= 1
    return _ladder.LADDER_SEQ // n


def _phase_ladder(ctx):
    """Ladder stages 00-07 through their `main` at the reference's
    shapes (SEQ 5096, d 64; 8 ranks on card 0; stages 05 and 06 at their
    own: the fp32 model at d_head 16, fp32 pools at d 32), each of which
    must print its pass line; the fp32 launches of stages 03 and 04
    against the ring's schedule, and those of stages 05 (K1 on padded
    heads, K6) and 06 (K7, and K6 for the shadow) against theirs (counts
    zeroed before each stage, read after it); stage 04 again over
    distinct cards when two or more are visible; the torch oracle against
    the native C++ oracle."""
    import importlib
    import io
    torch = ctx.torch
    from cuda_flashattention_torch.examples import _ladder
    from cuda_flashattention_torch.examples import generate as stage05
    from cuda_flashattention_torch.examples import paged_serving as stage06
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.naive import naive_attention
    from cuda_flashattention_torch.ops.paged import paged_decode_attention
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    from cuda_flashattention_torch.runtime import native

    seq = _ladder.LADDER_SEQ
    n = LADDER_RANKS
    while seq % n:
        n -= 1
    tri = n * (n - 1) // 2
    # stage 04: the full ring (n² steps, each K1b behind its guarded
    # fallback), then the causal ring twice (its check, then under
    # autograd): n diagonal steps on K1 and n(n − 1)/2 full ones on K1b
    # each, and one backward of n(n + 1)/2 K4 steps: blocks ahead skipped
    # stage 05: the teacher-forced rollout (NEW forwards of every layer on
    # K1, a short causal call), then two generate() runs (a prefill of
    # every layer on K1, NEW decode steps of every layer on K6); stage 06:
    # per step one K7 call and one K6 call on the shadow
    layers, new = stage05.CFG.n_layers, stage05.NEW
    none = dict(online=0, bound=0, kmajor=0, fallback=0, fused=0, decode=0,
                paged=0)
    expect = {
        "03": dict(none, bound=1, fallback=1),
        "04": dict(none, online=2 * n, bound=n * n + 2 * tri,
                   fallback=n * n + 2 * tri, fused=n * (n + 1) // 2),
        "05": dict(none, online=layers * (new + 2), decode=2 * layers * new),
        "06": dict(none, decode=stage06.STEPS, paged=stage06.STEPS),
    }
    one = ["--ranks", str(LADDER_RANKS), "--one-card"]
    runs = [("00", "psum_vecadd", one), ("01", "ppermute_verify", one),
            ("02", "overlap", one), ("03", "attention_1chip", []),
            ("04", "ring_attention", one), ("05", "generate", []),
            ("06", "paged_serving", []),
            ("07", "device_ring",
             ["--ranks", "4"] if torch.cuda.device_count() < 2 else [])]
    if torch.cuda.device_count() > 1:
        runs.append(("04", "ring_attention", ["--ranks", str(LADDER_RANKS)]))
    for num, name, argv in runs:
        stage = importlib.import_module(
            f"cuda_flashattention_torch.examples.{name}")
        ctx.zero_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = stage.main(argv)
        wall = time.perf_counter() - t0
        text = out.getvalue()
        print("".join(f"[ladder {num}] {line}\n"
                      for line in text.splitlines()), end="", flush=True)
        counts = dict(ctx.fwd_forms, fused=ctx.bwd_launches["fused"],
                      decode=decode_attention.launches,
                      paged=paged_decode_attention.launches)
        print(f"[ladder {num}] {name} {' '.join(argv)}: rc {rc}, "
              f"{wall:.2f} s of wall; forward launches by form and K4: "
              f"{counts}" + (f" (expect {expect[num]})" if num in expect
                             else ""), flush=True)
        _check(rc == 0 and "Test PASSED!" in text,
               f"ladder stage {num} {name} {argv}: rc {rc}")
        if num in expect:
            _check(counts == expect[num], f"ladder stage {num} launch counts "
                   f"{counts}, expected {expect[num]}")
            narrow = num == "05"  # d_head 16, on heads padded to 64
            ctx.launches["K1 fp32 d<64" if narrow else "K1 fp32"] += (
                counts["online"])
            ctx.launches["K1b fp32"] += counts["bound"]
            ctx.launches["K4 fp32"] += counts["fused"]
            ctx.launches["K6 fp32"] += counts["decode"]
            ctx.launches["K7 fp32"] += counts["paged"]
        if num == "07":
            _check(device_ring_matmul.launches > 0, "stage 07 launched no K9")
    if not native.available():
        print("[ladder] the native oracle does not build here: its check "
              "is skipped", flush=True)
        return
    gen = torch.Generator(device=ctx.dev).manual_seed(5)
    q, k, v = (torch.rand((1, 2, 256, 64), generator=gen, device=ctx.dev)
               - 0.5 for _ in range(3))
    for causal in (False, True):
        o_t, lse_t = naive_attention(q, k, v, causal=causal)
        o_n, lse_n = native.naive_attention_native(q, k, v, causal=causal)
        e_o = float(abs(o_t.cpu().numpy() - o_n).max())
        e_l = float(abs(lse_t.cpu().numpy() - lse_n).max())
        print(f"[ladder] torch oracle on the card against the native C++ "
              f"oracle ({native.num_threads()} threads), [1, 2, 256, 64] "
              f"causal={causal}: max|dO| {e_o:.3e}, max|dLSE| {e_l:.3e} "
              f"(gate 1e-5 / 1e-4)", flush=True)
        _check(e_o <= 1e-5 and e_l <= 1e-4,
               f"torch vs native oracle: {e_o:.3e} / {e_l:.3e}")


# ---------------------------------------------------------------------------
# Phase 31: fp16 and mixed float types. fp16 runs the fp16 units' builds
# (csrc/*_f16.cu: bf16's kernels with fp16 operands, `.f16` wgmma, P and dS
# rounded to fp16); Q, K, V (dO, x, W) of mixed float types run the fp32
# builds on exactly upcast operands, rounding P (dS) to the type JAX rounds
# it to. Their kernel rows, an fp16 serving model and an fp16 training
# model on their main paths, and the mixed serving paths.
# ---------------------------------------------------------------------------

F16_ROWS = ("K1 f16", "K1b f16", "K5 f16", "K6 f16", "K7 f16", "K2 f16",
            "K3 f16", "K4 f16", "prologue f16", "K8 f16", "K9 f16")
MIXED_ROWS = ("forward mixed", "decode mixed", "backward mixed", "K8 mixed",
              "K9 mixed")
# the training shape (B, H, Hkv, Nq, Nk, d; causal), the wide-head shape
F16_TRAIN = (1, 16, 16, 4096, 4096, 128)
F16_WIDE = (1, 8, 4, 4096, 4096, 256)
# the Gemma-width model's chunked-prefill prefix read (B, H, Hkv, Nq, Nk, d)
F16_GEMMA_PREFIX = (8, 8, 4, 512, 3584, 256)
# fp16's P under the bound softmax is 2^(s − c) rounded to fp16 (least
# subnormal 2^-24), as JAX rounds it: peaked inputs of the bound forms
# keep c within ~8 log2 units of the scores (Q x4, K x1); online forms and
# decode take Q x8, K x4 as the bf16 rows do
F16_BOUND_PEAK = (4.0, 1.0)
# the mixed forms' gate: 1e-4 · max(1, max |plain|) plus one ulp of P's and
# of O's type at max |plain| (a P at a rounding boundary may round the
# other way in the kernel's and the plain version's fp32 sums)
ULP = {"torch.float32": 0.0, "torch.bfloat16": 2.0 ** -7,
       "torch.float16": 2.0 ** -10}
# decode steps of the fp16 and mixed chunked-serving runs; the paged loop
F16_CHUNK_NEW, F16_PAGED_STEPS = 16, 16
# the fp16 training comparison's loss scale (`_phase_f16_training`)
F16_LOSS_SCALE = 2.0 ** 16


def _mixed_gate(o_ref, p_dtype, out_dtype, v_top=None):
    top = o_ref.float().abs().max().item()
    v_top = top if v_top is None else v_top
    return (1e-4 * max(1.0, top) + ULP[str(out_dtype)] * top
            + ULP[str(p_dtype)] * v_top)


def _u16(ctx, shape, peak=1.0, dtype=None):
    torch = ctx.torch
    x = (torch.rand(shape, generator=ctx.gen, device=ctx.dev) - 0.5) * peak
    return x.to(dtype or torch.float16)


def _rec_row(ctx, row, errs, ms=None, plain_ms=None, library_ms=None,
             bound=None):
    r = ctx.rec[row]
    r["max_abs_err"] = max([r["max_abs_err"], *errs])
    if ms is not None:
        r.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)


def _phase_f16_kernels(ctx):
    """Every fp16 build against its plain version: K1 (online), K1b and K5
    (pinned, `_plan` + `_fwd_cuda`) at the training shape [1, 16, 4096,
    128] causal, at the chunked prefill's prefix (512 x 3584; fp16 and int8
    K/V) and at [1, 8, 4096, 256] over 4 KV heads causal, flat and peaked,
    O within GATE and 2e-2 · max |plain|, LSE within GATE; K5 within 1e-4
    of K1b (fp32 O); fp16 O equal to the fp32 O rounded (K1, K1b). K6 at B=8
    H=16 Hkv=4 over 4224 live of 4352 fp16 and int8 keys, and at d = 256;
    K7 bit for bit K6 on the same keys. K4, K2 + K3 and the prologue at the
    training shape and at d = 256, each gradient within 2e-2 · max |plain|.
    K8 at [1, 16, 4096, 128] causal; K9 at n=4 L=1024 d=128 against the
    fp32 reference. Each row: kernel ms, bound (2 bytes an element, 989
    TFLOP/s), plain ms, SDPA in fp16 (its backward for K2-K4)."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops import flash_bwd as fb
    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.ops.decode import (
        decode_attention, decode_attention_plain)
    from cuda_flashattention_torch.ops.fa1 import (
        fa1_attention, fa1_attention_plain)
    from cuda_flashattention_torch.ops.paged import (
        init_paged_cache, paged_decode_attention)
    from cuda_flashattention_torch.ops.quant import quantize_kv
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    from cuda_flashattention_torch.utils.timing import (
        attention_flops, cuda_time_ms)
    card, h16 = ctx.card, torch.float16

    def pinned(form, q, k, v, kw, out=h16, scales=None):
        scales = scales or {}
        softmax = "online" if form == "online" else "bound_unchecked"
        plan = ff._plan(q, k, v, None, kw.get("causal", False),
                        kw.get("window", 0), kw.get("kv_offset", 0), None,
                        scales.get("k_scale"), scales.get("v_scale"), None,
                        None, softmax, False)
        if form != "online":
            plan = dataclasses.replace(plan, use_kmajor=form == "kmajor")
        return ff._fwd_cuda(q, k, v, plan, out, scales.get("k_scale"),
                            scales.get("v_scale"), None, None)

    # ---- the forward: K1, K1b, K5
    cases = [("train [1, 16, 4096, 128] causal", F16_TRAIN,
              dict(causal=True), None, ("online",)),
             ("prefix 512x3584", F32Q_PREFIX, {}, None, ("bound", "kmajor")),
             ("prefix 512x3584 int8", F32Q_PREFIX, {}, "int8", ()),
             ("[1, 8, 4096, 256] causal", F16_WIDE, dict(causal=True), None,
              ()),
             ("Gemma prefix 512x3584 d=256 int8", F16_GEMMA_PREFIX, {},
              "int8", ())]
    # timed and printed, not recorded: the fp16 unit's converted builds
    timed_only = ("Gemma prefix 512x3584 d=256 int8",)
    for name, (b, h, hkv, nq, nk, d), kw, qtype, recorded in cases:
        pairs = _visible_pairs(ctx, b, h, nq, nk, kw)
        bound = _bound(2 * (2 * b * h * nq * d + 2 * b * hkv * nk * d)
                       + 4 * b * h * nq, 4.0 * d * pairs)
        for form in ("online", "bound", "kmajor"):
            kn = {"online": "K1", "bound": "K1b", "kmajor": "K5"}[form]
            sq, sk = (Q_PEAK, K_PEAK) if form == "online" else F16_BOUND_PEAK
            errs, draws = [], []
            for peaked in (False, True):
                q = _u16(ctx, (b, h, nq, d), sq if peaked else 1.0)
                k = _u16(ctx, (b, hkv, nk, d), sk if peaked else 1.0)
                v = _u16(ctx, (b, hkv, nk, d))
                sc = {}
                if qtype:
                    kv = quantize_kv(k, v, qtype)
                    k, v = kv.k_q, kv.v_q
                    sc = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
                o, lse = pinned(form, q, k, v, kw, scales=sc)
                torch.cuda.synchronize()
                softmax = "online" if form == "online" else "bound_unchecked"
                o_p, lse_p = ff.flash_attention_forward_plain(
                    q, k, v, softmax=softmax, **kw, **sc)
                e, ref, ok = ctx.o_close(o, o_p)
                e_l = ctx.diff(lse, lse_p)
                errs += [e, e_l]
                _check(ok and e_l <= GATE and o.dtype == h16,
                       f"{kn} f16 {name} peaked={peaked}: O {e:.3e} of "
                       f"{ref:.3e}, LSE {e_l:.3e}")
                draws.append((q, k, v, sc))
            q, k, v, sc = draws[0]
            o32, _ = pinned(form, q, k, v, kw, torch.float32, sc)
            o16, _ = pinned(form, q, k, v, kw, h16, sc)
            torch.cuda.synchronize()
            e16 = ctx.diff(o16, o32.half())
            gate16 = (2.0 ** -10 * max(1.0, o32.abs().max().item())
                      if form == "kmajor" else 0.0)
            _check(e16 <= gate16, f"{kn} f16 {name}: fp16 O vs the fp32 O "
                   f"rounded {e16:.3e} > {gate16:.3e}")
            if form == "kmajor":
                o1b, _ = pinned("bound", q, k, v, kw, torch.float32, sc)
                e5 = ctx.diff(o32, o1b)
                _check(e5 <= 1e-4, f"K5 f16 {name} vs K1b: {e5:.3e}")
            line = (f"[f16] {kn} {name}: max|dO| flat {errs[0]:.3e} peaked "
                    f"{errs[2]:.3e}, max|dLSE| {max(errs[1], errs[3]):.3e} "
                    f"(gates {GATE}, {REL_GATE} x max|O|); fp16 O vs fp32 "
                    f"O rounded {e16:.3e}")
            if form in recorded or (name in timed_only and form != "online"):
                ms = _call_ms(lambda: pinned(form, q, k, v, kw, h16, sc), kn)
                ms_p = cuda_time_ms(lambda: ff.flash_attention_forward_plain(
                    q, k, v, softmax="online" if form == "online"
                    else "bound_unchecked", **kw, **sc), iters=3, warmup=1)
                kd, vd = k, v
                if qtype:  # SDPA on the dequantised K/V
                    kd = (k.float() * sc["k_scale"][..., None]).half()
                    vd = (v.float() * sc["v_scale"][..., None]).half()
                lib = _library_ms(ctx, q, kd, vd, kw)
                share = 100 * bound["bound_ms"] / ms
                line += (f"; kernel {ms:.4f} ms ({share:.1f}% of its bound "
                         f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}),"
                         f" plain {ms_p:.4f} ms, SDPA fp16"
                         + (" on the dequantised K/V" if qtype else "")
                         + f" {lib:.4f} ms")
                if name in timed_only:
                    _rec_row(ctx, f"{kn} f16", errs)
                else:
                    _rec_row(ctx, f"{kn} f16", errs, ms, ms_p, lib, bound)
            else:
                _rec_row(ctx, f"{kn} f16", errs)
            print(line + f" ({card})", flush=True)
        del draws

    # ---- decode: K6, K7 bit for bit
    for d, b, h, hkv in ((128, 8, 16, 4), (256, 8, 8, 4)):
        for qtype in (None, "int8"):
            q = _u16(ctx, (b, h, d), Q_PEAK)
            k = _u16(ctx, (b, hkv, DEC_CAP, d), K_PEAK)
            v = _u16(ctx, (b, hkv, DEC_CAP, d))
            sc = {}
            if qtype:
                kv = quantize_kv(k, v, qtype)
                k, v = kv.k_q, kv.v_q
                sc = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
            lens = torch.full((b,), DEC_LIVE, dtype=torch.int32,
                              device=ctx.dev)
            o, lse = decode_attention(q, k, v, lens, **sc)
            o_p, lse_p = decode_attention_plain(q, k, v, lens, **sc)
            torch.cuda.synchronize()
            e, ref, ok = ctx.o_close(o, o_p)
            e_l = ctx.diff(lse, lse_p)
            _check(ok and e_l <= GATE and o.dtype == h16,
                   f"K6 f16 d={d} {qtype}: O {e:.3e} of {ref:.3e}, LSE "
                   f"{e_l:.3e}")
            # K7 over pools holding the same keys in 128-token pages
            n_pg = DEC_CAP // PAGE
            pool = init_paged_cache(b * n_pg, b, n_pg, hkv, PAGE, d,
                                    qtype=qtype, dtype=h16, device=ctx.dev)
            table = torch.arange(b * n_pg, device=ctx.dev,
                                 dtype=torch.int32).view(b, n_pg)

            def pages(x):
                return x.view(b, hkv, n_pg, PAGE, *x.shape[3:]).transpose(
                    1, 2).reshape(b * n_pg, hkv, PAGE, *x.shape[3:])
            pool.k_pages.copy_(pages(k))
            pool.v_pages.copy_(pages(v))
            psc = {}
            if qtype:
                pool.k_scale.copy_(pages(sc["k_scale"]))
                pool.v_scale.copy_(pages(sc["v_scale"]))
                psc = dict(k_scale=pool.k_scale, v_scale=pool.v_scale)
            o7, lse7 = paged_decode_attention(q, pool.k_pages, pool.v_pages,
                                              table, lens, **psc)
            torch.cuda.synchronize()
            _check(bool(torch.equal(o7, o) and torch.equal(lse7, lse)),
                   f"K7 f16 d={d} {qtype}: not bit for bit K6's")
            line = (f"[f16] K6 B={b} H={h} Hkv={hkv} d={d} {qtype or 'fp16'}"
                    f" cache, {DEC_LIVE} live: max|dO| {e:.3e} of "
                    f"{ref:.3e}, max|dLSE| {e_l:.3e}; K7 bit for bit")
            _rec_row(ctx, "K6 f16", [e, e_l])
            _rec_row(ctx, "K7 f16", [e, e_l])
            if d == 128 and qtype is None:
                bound = _bound(2 * (2 * b * hkv * DEC_LIVE * d + 2 * b * h * d)
                               + 4 * b * h, 4.0 * b * h * DEC_LIVE * d)
                flush = ctx.l2_flush.zero_
                ms6 = _call_ms(lambda: decode_attention(q, k, v, lens), "K6",
                               before=flush)
                ms7 = _call_ms(lambda: paged_decode_attention(
                    q, pool.k_pages, pool.v_pages, table, lens), "K7",
                    before=flush)
                ms_p = cuda_time_ms(lambda: decode_attention_plain(
                    q, k, v, lens), iters=3, warmup=1)
                mask = (torch.arange(DEC_CAP, device=ctx.dev) < DEC_LIVE)
                lib = cuda_time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q[:, :, None], k, v, attn_mask=mask[None],
                        enable_gqa=True), iters=10)
                line += (f"; K6 {ms6:.4f} ms, K7 {ms7:.4f} ms (cold L2; "
                         f"bound {bound['bound_ms']:.4f} ms, "
                         f"{bound['bound_by']}), plain {ms_p:.4f} ms, SDPA "
                         f"fp16 {lib:.4f} ms")
                _rec_row(ctx, "K6 f16", [], ms6, ms_p, lib, bound)
                _rec_row(ctx, "K7 f16", [], ms7, ms_p, None, bound)
            print(line + f" ({card})", flush=True)
            del pool, k, v

    # ---- the backward: K4, K2 + K3, the prologue
    for name, (b, h, hkv, n, _, d) in (("train", F16_TRAIN),
                                       ("wide", F16_WIDE)):
        q = _u16(ctx, (b, h, n, d), 2.0)
        k = _u16(ctx, (b, hkv, n, d), 2.0)
        v, do = _u16(ctx, (b, hkv, n, d)), _u16(ctx, (b, h, n, d))
        o, lse = ff.flash_attention_forward(q, k, v, causal=True)
        want = fb.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                 causal=True)
        rows = []
        for fused, kns in ((True, ("K4",)), (False, ("K2", "K3"))):
            got = fb.flash_attention_backward(q, k, v, o, lse, do,
                                              causal=True, fused=fused)
            torch.cuda.synchronize()
            errs = []
            for g, w, gname in zip(got, want, ("dQ", "dK", "dV")):
                e, top = ctx.diff(g, w), w.float().abs().max().item()
                errs.append(e)
                _check(g.dtype == h16 and top > 0 and e <= BWD_GATE * top,
                       f"{'/'.join(kns)} f16 {name} {gname}: {e:.3e} of "
                       f"{top:.3e}")
            for kn in kns:
                _rec_row(ctx, f"{kn} f16", errs)
            rows.append(f"{'+'.join(kns)} max|d| dQ {errs[0]:.3e} dK "
                        f"{errs[1]:.3e} dV {errs[2]:.3e}")
        delta = fb._launch_delta(o, do)
        e_d = ctx.diff(delta, fb.delta_plain(o, do))
        _check(e_d <= 1e-3 * max(1.0, delta.abs().max().item()),
               f"prologue f16 {name}: {e_d:.3e}")
        _rec_row(ctx, "prologue f16", [e_d])
        line = f"[f16] backward {name} [{b}, {h}, {n}, {d}] causal: " + \
            "; ".join(rows) + f"; prologue D {e_d:.3e}"
        if name == "train":
            flops = attention_flops(b, h, n, n, d, causal=True,
                                    backward=True)
            io = 2 * (4 * b * h * n * d + 4 * b * hkv * n * d) + 8 * b * h * n
            ms4 = _call_ms(lambda: fb.flash_attention_backward(
                q, k, v, o, lse, do, causal=True), "K4")
            ms2 = _call_ms(lambda: fb._dkdv_cuda(q, k, v, o, lse, do,
                                                 causal=True), "K2")
            ms3 = _call_ms(lambda: fb.flash_attention_backward(
                q, k, v, o, lse, do, causal=True, fused=False), "K3")
            acc = torch.empty(q.shape, dtype=torch.float32, device=ctx.dev)
            msd = _call_ms(lambda: fb._launch_delta(o, do, acc),
                           "K4 D prologue")
            ms_p = cuda_time_ms(lambda: fb.flash_attention_backward_plain(
                q, k, v, o, lse, do, causal=True), iters=3, warmup=1)
            msd_p = cuda_time_ms(lambda: fb.delta_plain(o, do), iters=10)
            lib = _library_ms(ctx, q, k, v, dict(causal=True), backward=True,
                              do=do)
            lib_d = cuda_time_ms(lambda: (do.float() * o.float()).sum(-1),
                                 iters=10)
            b4 = _bound(io, flops)
            b2 = _bound(io - 2 * b * h * n * d, flops * 4 / 5)
            b3 = _bound(2 * (3 * b * h * n * d + 2 * b * hkv * n * d)
                        + 8 * b * h * n, flops * 3 / 5)
            bd = _bound(2 * 2 * b * h * n * d + 4 * b * h * n
                        + 4 * b * h * n * d, 0.0)
            _rec_row(ctx, "K4 f16", [], ms4, ms_p, lib, b4)
            _rec_row(ctx, "K2 f16", [], ms2, ms_p, lib, b2)
            _rec_row(ctx, "K3 f16", [], ms3, ms_p, lib, b3)
            _rec_row(ctx, "prologue f16", [], msd, msd_p, lib_d, bd)
            line += (f"; K4 {ms4:.4f} ms ({100 * b4['bound_ms'] / ms4:.1f}% "
                     f"of its bound {b4['bound_ms']:.4f} ms), K2 {ms2:.4f}, "
                     f"K3 {ms3:.4f}, prologue {msd:.4f} ms, plain {ms_p:.4f}"
                     f" ms, SDPA fp16 backward {lib:.4f} ms")
        print(line + f" ({card})", flush=True)
        del q, k, v, do, o, lse, want

    # ---- K8
    b, h, n, d = F32_FA1
    q, k, v = (_u16(ctx, (b, h, n, d), 2.0) for _ in range(3))
    ctx.zero_counts()
    o = fa1_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ctx.launches["K8 f16"] += fa1_attention.launches
    o_p = fa1_attention_plain(q, k, v, causal=True)
    e, ref, ok = ctx.o_close(o, o_p)
    _check(ok and o.dtype == h16, f"K8 f16: {e:.3e} of {ref:.3e}")
    bound = _bound(2 * 4 * b * h * n * d, attention_flops(b, h, n, n, d,
                                                          causal=True))
    ms = _call_ms(lambda: fa1_attention(q, k, v, causal=True), "K8")
    ms_p = cuda_time_ms(lambda: fa1_attention_plain(q, k, v, causal=True),
                        iters=1, warmup=1)
    lib = _library_ms(ctx, q, k, v, dict(causal=True))
    _rec_row(ctx, "K8 f16", [e], ms, ms_p, lib, bound)
    share = 100 * bound["bound_ms"] / ms
    print(f"[f16] K8 [{b}, {h}, {n}, {d}] causal: max|dO| {e:.3e} of "
          f"{ref:.3e}; kernel {ms:.4f} ms ({share:.1f}% of its bound), "
          f"plain {ms_p:.4f} ms, SDPA fp16 {lib:.4f} ms ({card})",
          flush=True)

    # ---- K9
    n_r, rows, d = 4, 1024, 128
    mesh = _shared_card_mesh(ctx, n_r)
    x, w = _u16(ctx, (n_r * rows, d)), _u16(ctx, (d, d))
    ctx.zero_counts()
    o = device_ring_matmul(x, w, mesh)
    torch.cuda.synchronize()
    ctx.launches["K9 f16"] += device_ring_matmul.launches
    ref = (x.float().view(n_r, rows, d).sum(0) @ w.float()).repeat(n_r, 1)
    e = ctx.diff(o, ref)
    e_p = ctx.diff(o, ring_matmul_plain(x, w, mesh))
    top = max(1.0, ref.abs().max().item())
    _check(o.dtype == torch.float32 and max(e, e_p) <= 1e-3 * top,
           f"K9 f16: {e:.3e} / {e_p:.3e}")
    bound = _k9_bound([ctx.dev] * n_r, rows, d)
    bound = {k_: bound[k_] for k_ in ("bound_ms", "bound_by")}
    ms = _call_ms(lambda: device_ring_matmul(x, w, mesh), "K9")
    ms_p = cuda_time_ms(lambda: ring_matmul_plain(x, w, mesh), iters=3)
    lib = cuda_time_ms(lambda: torch.einsum(
        "nld,de->nle", x.view(n_r, rows, d), w).sum(0), iters=10)
    _rec_row(ctx, "K9 f16", [e, e_p], ms, ms_p, lib, bound)
    print(f"[f16] K9 n={n_r} L={rows} d={d}: vs fp32 reference {e:.3e}, vs "
          f"plain ring {e_p:.3e} (gate 1e-3 x {top:.3f}); kernel {ms:.4f} "
          f"ms, plain {ms_p:.4f} ms, einsum fp16 {lib:.4f} ms ({card})",
          flush=True)


def _phase_mixed_kernels(ctx):
    """Mixed float types against the plain versions (TF32 off), at the
    gate `_mixed_gate`: the forward (K1, K1b, K5 pinned) on a bf16 or fp16
    Q over fp32 K/V, an fp16 Q over bf16 K/V and a bf16 Q over fp16 K/V at
    [2, 8, 1024, 128] causal and d = 256; the rounding of P shown to act (a
    bf16 Q over fp32 K/V sits on the plain version that rounds P and, on
    average, > 5x further from the one that leaves it unrounded); decode
    and paged decode (K7 bit for bit K6) of a bf16 q over an fp32 cache and
    an fp16 q over a bf16 cache; the backward (K4 and K2 + K3) of a bf16 q
    over fp32 k, v, dO and of fp32 q, k, v with a bf16 dO; K8 on an fp32 Q
    over bf16 K/V; K9 on fp32 x over bf16 W. The rows' times: the bf16 Q
    over fp32 K/V at the chunked prefill's prefix (K1b: the bf16 model over
    an fp32 cache), the decode at B=8 H=16 Hkv=4 over 4224 live fp32 keys,
    `flash_attention` forward + backward on bf16 q, k over an fp32 v at
    [1, 16, 4096, 128] causal (K1 and K4 once each: the training entry),
    K8 at [1, 16, 4096, 128] causal, K9 at n=4 L=1024 d=128; bounds at
    the operands' storage widths and the TF32 rate (the products are fp32
    ones), library: fp32 SDPA on the upcast operands plus the upcast."""
    torch = ctx.torch
    from cuda_flashattention_torch.ops import flash_bwd as fb
    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.ops.attention import flash_attention
    from cuda_flashattention_torch.ops.decode import (
        decode_attention, decode_attention_plain)
    from cuda_flashattention_torch.ops.fa1 import (
        fa1_attention, fa1_attention_plain)
    from cuda_flashattention_torch.ops.paged import (
        init_paged_cache, paged_decode_attention)
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    from cuda_flashattention_torch.utils.timing import (
        attention_flops, cuda_time_ms)
    card = ctx.card
    bf, h16, f32 = torch.bfloat16, torch.float16, torch.float32

    def pinned(form, q, k, v, kw, out):
        softmax = "online" if form == "online" else "bound_unchecked"
        plan = ff._plan(q, k, v, None, kw.get("causal", False),
                        kw.get("window", 0), kw.get("kv_offset", 0), None,
                        None, None, None, None, softmax, False)
        if form != "online":
            plan = dataclasses.replace(plan, use_kmajor=form == "kmajor")
        return ff._fwd_cuda(q, k, v, plan, out, None, None, None, None)

    # ---- the forward
    worst = 0.0
    for d in (128, 256):
        for tq, tk in ((bf, f32), (h16, f32), (h16, bf), (bf, h16)):
            q = _u16(ctx, (2, 8, 1024, d), F16_BOUND_PEAK[0], tq)
            k = _u16(ctx, (2, 4, 1024, d), F16_BOUND_PEAK[1], tk)
            v = _u16(ctx, (2, 4, 1024, d), 1.0, tk)
            kw = dict(causal=True)
            for form in ("online", "bound", "kmajor"):
                o, lse = pinned(form, q, k, v, kw, tq)
                torch.cuda.synchronize()
                softmax = "online" if form == "online" else "bound_unchecked"
                o_p, lse_p = ff.flash_attention_forward_plain(
                    q, k, v, softmax=softmax, **kw)
                gate = _mixed_gate(o_p, tq, tq, v.float().abs().max().item())
                e, e_l = ctx.diff(o, o_p), ctx.diff(lse, lse_p)
                worst = max(worst, e, e_l)
                _check(o.dtype == tq and e <= gate and e_l <= F32_GATE * max(
                    1.0, lse_p.abs().max().item()),
                    f"forward mixed {form} {tq} over {tk} d={d}: O {e:.3e} "
                    f"(gate {gate:.3e}), LSE {e_l:.3e}")
    q = _u16(ctx, (1, 16, 1024, 128), Q_PEAK, bf)
    k, v = _u16(ctx, (1, 16, 1024, 128), K_PEAK, f32), _u16(
        ctx, (1, 16, 1024, 128), 1.0, f32)
    o, _ = ff.flash_attention_forward(q, k, v, causal=True,
                                      softmax="online", out_dtype=f32)
    rounded, _ = ff.flash_attention_forward_plain(
        q, k, v, causal=True, softmax="online", out_dtype=f32)
    unrounded, _ = ff.flash_attention_forward_plain(
        q.float(), k, v, causal=True, softmax="online", out_dtype=f32)
    near = (o - rounded).abs().mean().item()
    far = (o - unrounded).abs().mean().item()
    _check(far > 5 * near, f"rounding P to bf16 does not show: mean |d| "
           f"{near:.3e} to the rounded plain version, {far:.3e} to the "
           f"unrounded one")
    b, h, hkv, nq, nk, d = F32Q_PREFIX
    q = _u16(ctx, (b, h, nq, d), 1.0, bf)
    k, v = (_u16(ctx, (b, hkv, nk, d), 1.0, f32) for _ in range(2))
    pairs = b * h * nq * nk
    bound = _bound_f32(2 * b * h * nq * d * 2 + 4 * 2 * b * hkv * nk * d
                       + 4 * b * h * nq, 4.0 * d * pairs)
    ms = _call_ms(lambda: pinned("bound", q, k, v, {}, bf), "K1b")
    ms_p = cuda_time_ms(lambda: ff.flash_attention_forward_plain(
        q, k, v, softmax="bound_unchecked"), iters=3, warmup=1)
    up = cuda_time_ms(lambda: q.float(), iters=10)
    lib = _library_ms(ctx, q.float(), k, v, {}) + up
    _rec_row(ctx, "forward mixed", [worst], ms, ms_p, lib, bound)
    print(f"[mixed] forward: bf16 / fp16 Q over fp32 K/V, fp16 over bf16, "
          f"bf16 over fp16, K1 / K1b / K5 at [2, 8, 1024, 128 and 256] "
          f"causal: worst |d| {worst:.3e} (1e-4 + ulps); P to bf16 acts: "
          f"mean |d| {near:.3e} to the rounded plain, {far:.3e} to the "
          f"unrounded; K1b bf16 Q over fp32 K/V at the prefix {ms:.4f} ms "
          f"({100 * bound['bound_ms'] / ms:.1f}% of its fp32 bound "
          f"{bound['bound_ms']:.4f} ms), plain {ms_p:.4f} ms, fp32 SDPA + "
          f"upcast {lib:.4f} ms ({card})", flush=True)

    # ---- decode and paged decode
    b, h, hkv, d = 8, 16, 4, 128
    lens = torch.full((b,), DEC_LIVE, dtype=torch.int32, device=ctx.dev)
    n_pg = DEC_CAP // PAGE
    table = torch.arange(b * n_pg, device=ctx.dev,
                         dtype=torch.int32).view(b, n_pg)
    worst, timed = 0.0, None
    for tq, tc in ((bf, f32), (h16, bf)):
        q = _u16(ctx, (b, h, d), Q_PEAK, tq)
        k = _u16(ctx, (b, hkv, DEC_CAP, d), K_PEAK, tc)
        v = _u16(ctx, (b, hkv, DEC_CAP, d), 1.0, tc)
        o, lse = decode_attention(q, k, v, lens)
        o_p, lse_p = decode_attention_plain(q, k, v, lens)
        torch.cuda.synchronize()
        e, e_l = ctx.diff(o, o_p), ctx.diff(lse, lse_p)
        gate = _mixed_gate(o_p, tq, tq, 0.5)
        _check(o.dtype == tq and e <= gate and e_l <= F32_GATE * max(
            1.0, lse_p.abs().max().item()),
            f"decode mixed {tq} over {tc}: O {e:.3e} (gate {gate:.3e}), "
            f"LSE {e_l:.3e}")
        pool = init_paged_cache(b * n_pg, b, n_pg, hkv, PAGE, d, dtype=tc,
                                device=ctx.dev)

        def pages(x):
            return x.view(b, hkv, n_pg, PAGE, d).transpose(1, 2).reshape(
                b * n_pg, hkv, PAGE, d)
        pool.k_pages.copy_(pages(k))
        pool.v_pages.copy_(pages(v))
        o7, lse7 = paged_decode_attention(q, pool.k_pages, pool.v_pages,
                                          table, lens)
        torch.cuda.synchronize()
        _check(bool(torch.equal(o7, o) and torch.equal(lse7, lse)),
               f"decode mixed {tq} over {tc}: K7 not bit for bit K6's")
        worst = max(worst, e, e_l)
        if timed is None:
            timed = (q, k, v, pool)
    q, k, v, pool = timed
    flush = ctx.l2_flush.zero_
    bound = _bound_f32(4 * 2 * b * hkv * DEC_LIVE * d + 2 * 2 * b * h * d
                       + 4 * b * h, 4.0 * b * h * DEC_LIVE * d)
    ms = _call_ms(lambda: decode_attention(q, k, v, lens), "K6",
                  before=flush)
    ms7 = _call_ms(lambda: paged_decode_attention(
        q, pool.k_pages, pool.v_pages, table, lens), "K7", before=flush)
    ms_p = cuda_time_ms(lambda: decode_attention_plain(q, k, v, lens),
                        iters=3, warmup=1)
    mask = torch.arange(DEC_CAP, device=ctx.dev) < DEC_LIVE
    up = cuda_time_ms(lambda: q.float(), iters=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = cuda_time_ms(lambda: sdpa(
        q.float()[:, :, None], k, v, attn_mask=mask[None], enable_gqa=True),
        iters=10) + up
    _rec_row(ctx, "decode mixed", [worst], ms, ms_p, lib, bound)
    print(f"[mixed] decode: bf16 q over an fp32 cache and fp16 q over a bf16 "
          f"cache, B={b} H={h} Hkv={hkv} d={d}, {DEC_LIVE} live: worst |d| "
          f"{worst:.3e}; K7 bit for bit K6; K6 (bf16 q over fp32) {ms:.4f} "
          f"ms, K7 {ms7:.4f} ms (cold L2; bound {bound['bound_ms']:.4f} ms), "
          f"plain {ms_p:.4f} ms, fp32 SDPA + upcast {lib:.4f} ms ({card})",
          flush=True)
    del timed, q, k, v, pool

    # ---- the backward
    worst = 0.0
    for types in ((bf, f32, f32, f32), (f32, f32, f32, bf)):
        b, h, n, d = 1, 8, 1024, 128
        q = _u16(ctx, (b, h, n, d), 2.0, types[0])
        k = _u16(ctx, (b, h, n, d), 2.0, types[1])
        v, do = _u16(ctx, (b, h, n, d), 1.0, types[2]), _u16(
            ctx, (b, h, n, d), 1.0, types[3])
        o, lse = ff.flash_attention_forward_plain(q.float(), k, v,
                                                  causal=True)
        want = fb.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                 causal=True)
        narrow = max(ULP[str(t)] for t in types)
        for fused in (True, False):
            got = fb.flash_attention_backward(q, k, v, o, lse, do,
                                              causal=True, fused=fused)
            torch.cuda.synchronize()
            for g, w, t in zip(got, want, types):
                top = w.float().abs().max().item()
                e = ctx.diff(g, w)
                gate = 1e-4 * max(1.0, top) + (ULP[str(t)] + 2 * narrow) * top
                worst = max(worst, e)
                _check(g.dtype == t and top > 0 and e <= gate,
                       f"backward mixed {types} fused={fused}: {e:.3e} > "
                       f"{gate:.3e}")
    # the training entry on a bf16 q and k over an fp32 v (K4 rounds dS
    # once for dK and dQ, so q and k share a type on this path)
    b, h, hkv, n, _, d = F16_TRAIN
    q = _u16(ctx, (b, n, h, d), 1.0, bf).transpose(1, 2).requires_grad_()
    k = _u16(ctx, (b, n, hkv, d), 1.0, bf).transpose(1, 2).requires_grad_()
    v = _u16(ctx, (b, n, hkv, d), 1.0, f32).transpose(1, 2).requires_grad_()
    do = _u16(ctx, (b, h, n, d), 1.0, bf)

    def fwd_bwd():
        o = flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(o, (q, k, v), do)
    ctx.zero_counts()
    grads = fwd_bwd()
    torch.cuda.synchronize()
    counts = dict(ctx.bwd_launches)
    _check(counts["fused"] == 1 and all(g.dtype == t for g, t in zip(
        grads, (bf, bf, f32))), f"flash_attention mixed: {counts}")
    ctx.launches["backward mixed"] += counts["fused"]
    ctx.launches["forward mixed"] += ctx.fwd_forms["online"]
    flops = attention_flops(b, h, n, n, d, causal=True, backward=True)
    bound = _bound_f32(2 * 2 * b * h * n * d + 2 * 2 * b * hkv * n * d
                       + 4 * 2 * b * hkv * n * d + 2 * 2 * b * h * n * d
                       + 8 * b * h * n, flops)
    qd, kd, vd = (x.detach() for x in (q, k, v))
    o, lse = ff.flash_attention_forward(qd, kd, vd, causal=True)
    ms = _call_ms(lambda: fb.flash_attention_backward(
        qd, kd, vd, o, lse, do, causal=True), "K4")
    ms_p = cuda_time_ms(lambda: fb.flash_attention_backward_plain(
        qd, kd, vd, o, lse, do, causal=True), iters=3, warmup=1)
    up = cuda_time_ms(lambda: (qd.float(), kd.float(), do.float()),
                      iters=10)
    lib = _library_ms(ctx, qd.float(), kd.float(), vd, dict(causal=True),
                      backward=True, do=do.float()) + up
    _rec_row(ctx, "backward mixed", [worst], ms, ms_p, lib, bound)
    print(f"[mixed] backward: bf16 q over fp32 k, v, dO and fp32 q, k, v "
          f"with a bf16 dO, fused and split at [1, 8, 1024, 128] causal: "
          f"worst |d| {worst:.3e}; flash_attention on bf16 q, k over an "
          f"fp32 v at [{b}, {h}, {n}, {d}] causal: K1 "
          f"{ctx.fwd_forms['online']}, K4 {counts['fused']}, prologue "
          f"{counts['delta']}; K4 (fp32 build, P to bf16) {ms:.4f} ms "
          f"({100 * bound['bound_ms'] / ms:.1f}% of its fp32 bound), plain "
          f"{ms_p:.4f} ms, fp32 SDPA backward + upcast {lib:.4f} ms "
          f"({card})", flush=True)
    del q, k, v, do, grads, qd, kd, vd, o, lse

    # ---- K8
    b, h, n, d = F32_FA1
    q = _u16(ctx, (b, h, n, d), 2.0, f32)
    k, v = _u16(ctx, (b, h, n, d), 2.0, bf), _u16(ctx, (b, h, n, d), 1.0, bf)
    ctx.zero_counts()
    o = fa1_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ctx.launches["K8 mixed"] += fa1_attention.launches
    o_p = fa1_attention_plain(q, k, v, causal=True)
    e = ctx.diff(o, o_p)
    gate = _mixed_gate(o_p, bf, f32, 0.5)
    _check(o.dtype == f32 and e <= gate, f"K8 mixed: {e:.3e} > {gate:.3e}")
    bound = _bound_f32(4 * 2 * b * h * n * d + 2 * 2 * b * h * n * d,
                       attention_flops(b, h, n, n, d, causal=True))
    ms = _call_ms(lambda: fa1_attention(q, k, v, causal=True), "K8")
    ms_p = cuda_time_ms(lambda: fa1_attention_plain(q, k, v, causal=True),
                        iters=1, warmup=1)
    up = cuda_time_ms(lambda: (k.float(), v.float()), iters=10)
    lib = _library_ms(ctx, q, k.float(), v.float(), dict(causal=True)) + up
    _rec_row(ctx, "K8 mixed", [e], ms, ms_p, lib, bound)
    print(f"[mixed] K8 fp32 Q over bf16 K/V [{b}, {h}, {n}, {d}] causal: "
          f"max|dO| {e:.3e} (gate {gate:.3e}); kernel {ms:.4f} ms, plain "
          f"{ms_p:.4f} ms, fp32 SDPA + upcast {lib:.4f} ms ({card})",
          flush=True)
    del q, k, v, o, o_p

    # ---- K9
    n_r, rows, d = 4, 1024, 128
    mesh = _shared_card_mesh(ctx, n_r)
    x, w = _u16(ctx, (n_r * rows, d), 1.0, f32), _u16(ctx, (d, d), 1.0, bf)
    ctx.zero_counts()
    o = device_ring_matmul(x, w, mesh)
    torch.cuda.synchronize()
    ctx.launches["K9 mixed"] += device_ring_matmul.launches
    ref = (x.float().view(n_r, rows, d).sum(0) @ w.float()).repeat(n_r, 1)
    e = ctx.diff(o, ref)
    e_p = ctx.diff(o, ring_matmul_plain(x, w, mesh))
    top = max(1.0, ref.abs().max().item())
    _check(max(e, e_p) <= 1e-4 * top, f"K9 mixed: {e:.3e} / {e_p:.3e}")
    bound = _k9_bound([ctx.dev] * n_r, rows, d, f32=True)
    bound = {k_: bound[k_] for k_ in ("bound_ms", "bound_by")}
    ms = _call_ms(lambda: device_ring_matmul(x, w, mesh), "K9")
    ms_p = cuda_time_ms(lambda: ring_matmul_plain(x, w, mesh), iters=3)
    up = cuda_time_ms(lambda: w.float(), iters=10)
    lib = cuda_time_ms(lambda: torch.einsum(
        "nld,de->nle", x.view(n_r, rows, d), w.float()).sum(0),
        iters=10) + up
    _rec_row(ctx, "K9 mixed", [e, e_p], ms, ms_p, lib, bound)
    print(f"[mixed] K9 fp32 x over bf16 W, n={n_r} L={rows} d={d}: vs fp32 "
          f"reference {e:.3e}, vs plain {e_p:.3e} (gate 1e-4 x {top:.3f}); "
          f"kernel {ms:.4f} ms, plain {ms_p:.4f} ms, fp32 einsum + upcast "
          f"{lib:.4f} ms ({card})", flush=True)


def _serve_runs(ctx, tag, m, prompt, new, caches_fn, chunk=None):
    """One serving run through the kernels and the same on the plain
    attention functions: `prefill_chunked(chunk)` (or, without `chunk`,
    `generate()`'s whole-prompt prefill) over caches_fn(), then `new`
    greedy `decode_one` steps. Logits within LOGIT_GATE of the plain run's
    and greedy tokens equal, or departing only where the plain run's two
    best logits lie within that gate. Returns the kernel run's forward
    form counts and its decode launches."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops.decode import decode_attention
    t = prompt.shape[1]

    def run():
        c = caches_fn()
        if chunk:
            lg, c = tfm.prefill_chunked(m, prompt, c, chunk=chunk)
        else:
            lg, c = tfm.prefill(m, prompt, c)
        tok = torch.argmax(lg, dim=-1).to(prompt.dtype)
        toks, steps = [tok], [lg]
        for i in range(new):
            lg_dec, c = tfm.decode_one(m, tok, t + i, c)
            tok = torch.argmax(lg_dec, dim=-1).to(prompt.dtype)
            toks.append(tok)
            steps.append(lg_dec)
        torch.cuda.synchronize()
        return torch.stack(toks, 1), steps

    ctx.zero_counts()
    t0 = time.perf_counter()
    toks, steps = run()
    wall = time.perf_counter() - t0
    counts, n_dec = dict(ctx.fwd_forms), decode_attention.launches
    with _serving_on_plain_attention():
        toks_p, steps_p = run()
    e_lg = max(ctx.diff(a, b_) for a, b_ in zip(steps, steps_p))
    departure, tie_ok = "", True
    if not torch.equal(toks, toks_p):
        step = int((toks != toks_p).any(0).nonzero()[0])
        rows = toks[:, step] != toks_p[:, step]
        best = steps_p[step][rows].float().topk(2, dim=-1).values
        gap = (best[:, 0] - best[:, 1]).max().item()
        tie_ok = gap <= LOGIT_GATE
        departure = (f" (first departure at token {step}, where the plain "
                     f"run's two best logits lie {gap:.3e} apart)")
        e_lg = max(ctx.diff(a, b_) for a, b_ in zip(steps[:step + 1],
                                                     steps_p[:step + 1]))
    print(f"[{tag}] B={prompt.shape[0]} x {t} tokens"
          + (f" in chunks of {chunk}" if chunk else "") + f", {new} greedy "
          f"steps: launches {counts}, K6 {n_dec}; logits vs plain attention "
          f"max|d| {e_lg:.3e} (gate {LOGIT_GATE}); greedy tokens equal "
          f"{(toks == toks_p).float().mean().item():.4f}{departure}; "
          f"{wall:.3f} s ({ctx.card})", flush=True)
    _check(all(bool(torch.isfinite(x).all()) for x in steps)
           and e_lg <= LOGIT_GATE, f"{tag}: logits {e_lg:.3e}")
    _check(tie_ok, f"{tag}: tokens depart from the plain run{departure}")
    return counts, n_dec


def _phase_f16_serving(ctx):
    """Main path of fp16 serving: the 246M serving config with
    `dtype=torch.float16`: `generate()` on B=8 prompts of 512 tokens for
    128 new tokens over an fp16 and an int8 cache (K1 f16 per layer, K6
    f16 per layer and step); `prefill_chunked(chunk=512)` on B=8 x 4096
    tokens then F16_CHUNK_NEW greedy steps over fp16, int8 and fp8 caches
    and, with `cfg.window` = 1024, an int8 cache (each chunk K1 f16 on
    itself, its prefix read as "auto" routes an fp16 Q: K1b f16 or, under
    the window, K5 f16); each against the same run on the plain attention
    functions (`_serve_runs`). Then the paged loop over fp16 pools (N_PAGES
    pages of PAGE tokens): B=8 x 4096 tokens through `paged_bulk_append`,
    F16_PAGED_STEPS steps of `paged_decode_step` (K7 f16), each bit for bit
    K6 f16 on a contiguous fp16 shadow, the last within GATE of the plain
    version; a sequence retires and its pages serve a new one."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.models.generate import generate
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.kv_cache import (
        append as cache_append, init_cache)
    from cuda_flashattention_torch.ops.paged import (
        PageAllocator, init_paged_cache, paged_append, paged_bulk_append,
        paged_decode_attention, paged_decode_attention_plain,
        paged_decode_step)
    dev, card = ctx.dev, ctx.card
    cfg = tfm.TransformerConfig(dtype=torch.float16, **CFG_KW)
    gen = torch.Generator(device=dev).manual_seed(31)
    model = tfm.Transformer(cfg, generator=gen)
    n = cfg.n_layers
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    generate(model, prompt, 2)  # warm-up
    for qtype in (None, "int8"):
        ctx.zero_counts()
        t0 = time.perf_counter()
        out, _ = generate(model, prompt, NEW, qtype=qtype)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fwd, n_dec = ctx.fwd_forms["online"], decode_attention.launches
        print(f"[f16-generate] {qtype or 'fp16'} cache: launches K1 {n_fwd} "
              f"(expect {n}), K6 {n_dec} (expect {n * NEW}); "
              f"{BATCH * NEW / wall:.1f} tok/s ({card})", flush=True)
        _check(n_fwd == n and n_dec == n * NEW and sum(
            ctx.fwd_forms.values()) == n, f"fp16 generate {qtype}: "
            f"{ctx.fwd_forms}, K6 {n_dec}")
        _check(tuple(out.shape) == (BATCH, PROMPT + NEW),
               "fp16 generate: tokens")
        ctx.launches["K1 f16"] += n_fwd
        ctx.launches["K6 f16"] += n_dec
        _serve_runs(ctx, f"f16-generate {qtype or 'fp16'} cache", model,
                    prompt, NEW, lambda: tfm.init_caches(
                        cfg, BATCH, PROMPT + NEW, qtype=qtype, device=dev))
    del prompt

    prompt = torch.randint(0, cfg.vocab_size, (BATCH, LONG_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    n_own = LONG_PROMPT // LONG_CHUNK * n
    n_prefix = n_own - n
    for label, qtype, window in (("fp16", None, 0), ("int8", "int8", 0),
                                 ("fp8", "fp8", 0),
                                 ("int8 window 1024", "int8", LONG_WINDOW)):
        m = _windowed(model, window) if window else model
        counts, n_dec = _serve_runs(
            ctx, f"f16-chunked {label} cache", m, prompt, F16_CHUNK_NEW,
            lambda: tfm.init_caches(m.cfg, BATCH, LONG_PROMPT + F16_CHUNK_NEW,
                                    qtype=qtype, device=dev),
            chunk=LONG_CHUNK)
        reads = counts["online"] + counts["bound"] + counts["kmajor"]
        _check(reads == n_own + n_prefix and n_dec == n * F16_CHUNK_NEW,
               f"fp16 chunked {label}: {counts}, K6 {n_dec}")
        ctx.launches["K1 f16"] += counts["online"]
        ctx.launches["K1b f16"] += counts["bound"]
        ctx.launches["K5 f16"] += counts["kmajor"]
        ctx.launches["K6 f16"] += n_dec
    del model, prompt

    # the paged loop over fp16 pools
    b, hkv, h, d = BATCH, cfg.n_kv_heads, cfg.n_heads, cfg.d_head
    total = PAGED_PREFILL + F16_PAGED_STEPS
    k_all = _u16(ctx, (b, hkv, total, d))
    v_all = _u16(ctx, (b, hkv, total, d))
    cache = init_paged_cache(N_PAGES, b, MAX_PAGES, hkv, PAGE, d,
                             dtype=torch.float16, device=dev)
    alloc = PageAllocator(N_PAGES)
    shadow = init_cache(b, hkv, MAX_PAGES * PAGE, d, dtype=torch.float16,
                        device=dev)
    for i in range(b):
        alloc.reserve_for(cache, i, PAGED_PREFILL)
    paged_bulk_append(cache, k_all[:, :, :PAGED_PREFILL],
                      v_all[:, :, :PAGED_PREFILL])
    cache_append(shadow, k_all[:, :, :PAGED_PREFILL],
                 v_all[:, :, :PAGED_PREFILL])
    ctx.zero_counts()
    e_plain = None
    for t in range(F16_PAGED_STEPS):
        at = PAGED_PREFILL + t
        for i in range(b):
            alloc.reserve_for(cache, i, 1)
        paged_append(cache, k_all[:, :, at], v_all[:, :, at])
        cache_append(shadow, k_all[:, :, at:at + 1], v_all[:, :, at:at + 1])
        q = _u16(ctx, (b, h, d), Q_PEAK)
        o, lse = paged_decode_step(q, cache)
        lengths = torch.full((b,), at + 1, dtype=torch.int32, device=dev)
        o_c, lse_c = decode_attention(q, shadow.k, shadow.v, lengths)
        torch.cuda.synchronize()
        _check(bool(torch.equal(o, o_c) and torch.equal(lse, lse_c)),
               f"fp16 paged step {t}: not bit for bit K6's")
        if t == F16_PAGED_STEPS - 1:
            o_p, lse_p = paged_decode_attention_plain(
                q, cache.k_pages, cache.v_pages, cache.page_table,
                cache.lengths)
            e_plain, ref, ok = ctx.o_close(o, o_p)
            _check(ok and ctx.diff(lse, lse_p) <= GATE,
                   f"fp16 paged vs plain {e_plain:.3e} of {ref:.3e}")
    free_before = len(alloc.free)
    alloc.release_sequence(cache, 3)
    freed = len(alloc.free) - free_before
    alloc.reserve_for(cache, 3, PAGE)
    paged_append(cache, k_all[:, :, 0], v_all[:, :, 0])
    o, _ = paged_decode_step(q, cache)
    torch.cuda.synchronize()
    n_k7 = paged_decode_attention.launches
    print(f"[f16-paged] fp16 pools of {N_PAGES} pages x {PAGE} tokens, B={b} "
          f"x {PAGED_PREFILL} tokens, {F16_PAGED_STEPS} steps bit for bit "
          f"K6's on the shadow, last step vs plain {e_plain:.3e}; retired "
          f"sequence 3: {freed} pages back; K7 launches {n_k7} ({card})",
          flush=True)
    _check(n_k7 == F16_PAGED_STEPS + 1 and freed == -(-total // PAGE)
           and bool(torch.isfinite(o).all()),
           f"fp16 paged run: K7 {n_k7}, {freed} pages freed")
    ctx.launches["K7 f16"] += n_k7
    ctx.launches["K6 f16"] += decode_attention.launches
    del cache, shadow, alloc, k_all, v_all


def _phase_mixed_serving(ctx):
    """Main paths of serving over a cache of another type: the 246M serving
    config in bf16 over fp32 caches, and in fp16 over bf16 caches (one
    `init_cache(..., dtype=...)` per layer): `generate()` on B=8 prompts of
    512 tokens for 32 new tokens (its caches made in that type; the
    prefill never reads them, each decode step reads them through K6's
    fp32-q build on q upcast, P rounded to the model's type), and
    `prefill_chunked(chunk=512)` on B=8 x 4096 tokens then F16_CHUNK_NEW
    greedy steps (each chunk's own read K1 in the model's type, its
    prefix read through the fp32 builds on Q upcast, P rounded likewise:
    "forward mixed"); each against the same run on the plain attention
    functions (`_serve_runs`)."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import generate as gen_mod
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.kv_cache import init_cache
    dev = ctx.dev
    new = F32_GEN[2]
    for model_type, cache_type in ((torch.bfloat16, torch.float32),
                                   (torch.float16, torch.bfloat16)):
        cfg = tfm.TransformerConfig(dtype=model_type, **CFG_KW)
        gen = torch.Generator(device=dev).manual_seed(32)
        model = tfm.Transformer(cfg, generator=gen)
        n = cfg.n_layers
        tag = (f"{str(model_type)[6:]} model over {str(cache_type)[6:]} "
               f"caches")

        def caches(batch, length, m=model):
            return tuple(init_cache(batch, m.cfg.n_kv_heads, length,
                                    m.cfg.d_head, dtype=cache_type,
                                    device=dev)
                         for _ in range(m.cfg.n_layers))
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                               generator=gen, device=dev, dtype=torch.int32)
        with mock.patch.object(
                gen_mod, "init_caches",
                lambda c, b_, length, qtype=None, device=None: caches(
                    b_, length)):
            ctx.zero_counts()
            out, _ = gen_mod.generate(model, prompt, new)
            torch.cuda.synchronize()
        n_fwd, n_dec = ctx.fwd_forms["online"], decode_attention.launches
        _check(n_fwd == n and n_dec == n * new and tuple(out.shape) == (
            BATCH, PROMPT + new), f"{tag} generate: {ctx.fwd_forms}, K6 "
            f"{n_dec}")
        ctx.launches["K1" if model_type == torch.bfloat16 else "K1 f16"] += (
            n_fwd)
        ctx.launches["decode mixed"] += n_dec
        _serve_runs(ctx, f"mixed-generate {tag}", model, prompt, new,
                    lambda: caches(BATCH, PROMPT + new))
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, LONG_PROMPT),
                               generator=gen, device=dev, dtype=torch.int32)
        counts, n_dec = _serve_runs(
            ctx, f"mixed-chunked {tag}", model, prompt, F16_CHUNK_NEW,
            lambda: caches(BATCH, LONG_PROMPT + F16_CHUNK_NEW),
            chunk=LONG_CHUNK)
        n_own = LONG_PROMPT // LONG_CHUNK * n
        reads = counts["online"] + counts["bound"] + counts["kmajor"]
        _check(reads == 2 * n_own - n and n_dec == n * F16_CHUNK_NEW,
               f"{tag} chunked: {counts}, K6 {n_dec}")
        own = "K1" if model_type == torch.bfloat16 else "K1 f16"
        ctx.launches[own] += n_own
        ctx.launches["forward mixed"] += reads - n_own
        ctx.launches["decode mixed"] += n_dec
        del model, prompt


def _phase_f16_training(ctx):
    """Main path of fp16 training: the 271M training config (TRAIN_KW) with
    `dtype=torch.float16`, B=1 x T=4096 tokens, `make_train_step` with
    SGD(1e-4): 2 warm-up and TIMED_STEPS timed steps (K1 f16 = K4 f16 = the
    prologue = 4 a step); one step through the split backward (K2 f16 = K3
    f16 = 4); the windowed model (`cfg.window` = 1024) likewise. The loss
    and every gradient of a step against the same step on the plain
    attention functions (loss within LOSS_GATE, relative L2 within
    GRAD_GATE), fused, split and windowed; the bf16 model's worst gradient
    on the same batch beside fp16's. The comparison scales the loss by
    F16_LOSS_SCALE before its backward and the gradients back after it,
    on both paths alike, as an fp16 trainer does (torch.cuda.amp's
    GradScaler starts at 2^16): the activation gradients of a mean loss
    over 4096 tokens sit near 1e-6, in fp16's subnormals, where dO, dP
    and dS (rounded to fp16, as JAX rounds them) keep a few bits and the
    two paths' rounding flips differ by ~13% relative L2 (layers.2.wq,
    unscaled). The timed steps are `make_train_step`'s, unscaled."""
    torch = ctx.torch
    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.ops import attention
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward, flash_attention_backward_plain)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward_plain)
    from cuda_flashattention_torch.utils.timing import attention_flops
    dev, card = ctx.dev, ctx.card
    t = TRAIN_T
    tokens = torch.randint(0, TRAIN_KW["vocab_size"], (1, t), device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(33),
                           dtype=torch.int32)
    plain_bwd = (lambda q, k, v, o, lse, do, block_sizes=None, fused=None,
                 **kw:
                 flash_attention_backward_plain(q, k, v, o, lse, do, **kw))

    def fresh(dtype, window=0):
        cfg = tfm.TransformerConfig(dtype=dtype, window=window, **TRAIN_KW)
        return tfm.Transformer(
            cfg, generator=torch.Generator(device=dev).manual_seed(34))

    def loss_and_grads(m):
        m.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(m, tokens)
        (loss * F16_LOSS_SCALE).backward()
        grads = [p.grad / F16_LOSS_SCALE for p in m.parameters()]
        m.zero_grad(set_to_none=True)
        return loss.item(), grads

    def against_plain(m, tag, names):
        loss_k, grads_k = loss_and_grads(m)
        with mock.patch.object(attention, "flash_attention_forward",
                               flash_attention_forward_plain), \
                mock.patch.object(attention, "flash_attention_backward",
                                  plain_bwd):
            loss_p, grads_p = loss_and_grads(m)
        errs = [((a.float() - b_.float()).norm() / b_.float().norm()).item()
                for a, b_ in zip(grads_k, grads_p)]
        i = max(range(len(errs)), key=errs.__getitem__)
        print(f"[{tag}] kernels vs plain attention: loss {loss_k:.6f} vs "
              f"{loss_p:.6f} (|d| {abs(loss_k - loss_p):.3e}, gate "
              f"{LOSS_GATE}); worst gradient relative L2 {errs[i]:.3e} "
              f"({names[i]}; gate {GRAD_GATE}) ({card})", flush=True)
        _check(math.isfinite(loss_k) and abs(loss_k - loss_p) <= LOSS_GATE,
               f"{tag}: loss {loss_k} vs {loss_p}")
        _check(errs[i] <= GRAD_GATE, f"{tag}: gradient of {names[i]} "
               f"{errs[i]:.3e}")
        return errs[i]

    model = fresh(torch.float16)
    names = [nm for nm, _ in model.named_parameters()]
    n_params = sum(p.numel() for p in model.parameters())
    flops = (6.0 * n_params * t + 3 * attention_flops(
        1, model.cfg.n_heads, t, t, model.cfg.d_head, causal=True)
        * model.cfg.n_layers)
    rows = dict(fwd=["K1 f16"], fused=["K4 f16"], delta=["prologue f16"])
    _timed_train_steps(ctx, model, tokens, "f16-train", flops, rows)
    e16 = against_plain(model, "f16-train", names)
    ctx.zero_counts()
    with mock.patch.object(attention, "flash_attention_backward",
                           functools.partial(flash_attention_backward,
                                             fused=False)):
        e_split = against_plain(model, "f16-train split backward", names)
    counts = dict(ctx.bwd_launches)
    n = model.cfg.n_layers
    # the kernel pass of against_plain (the plain pass launches nothing)
    _check(counts["dkdv"] == n and counts["dq"] == n and counts["fused"] == 0,
           f"fp16 split backward launches {counts}")
    ctx.launches["K2 f16"] += counts["dkdv"]
    ctx.launches["K3 f16"] += counts["dq"]
    del model
    torch.cuda.empty_cache()
    wmodel = fresh(torch.float16, LONG_WINDOW)
    _timed_train_steps(ctx, wmodel, tokens, f"f16-wtrain window "
                       f"{LONG_WINDOW}", flops, rows)
    e_w = against_plain(wmodel, f"f16-wtrain window {LONG_WINDOW}", names)
    del wmodel
    torch.cuda.empty_cache()
    e_bf = against_plain(fresh(torch.bfloat16), "bf16-train (beside fp16)",
                         names)
    print(f"[f16-train] worst gradient relative L2 against the plain "
          f"attention functions: fp16 {e16:.3e} (split {e_split:.3e}, "
          f"window {e_w:.3e}), bf16 {e_bf:.3e} on the same batch ({card})",
          flush=True)


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
        decode_attention, decode_attention_plain, effective_windows)
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
    from cuda_flashattention_torch.ops.common import kmajor_q_walk
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
          f"(nvcc {'%.2f s' % built if built is not None else 'cached'}"
          + "".join(f"; {n} {t:.1f} s"
                    for n, t in sorted(_build.source_seconds.items(),
                                       key=lambda x: -x[1]))
          + ")", flush=True)

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
        for name in flash_attention_forward.key128_launches:
            flash_attention_forward.key128_launches[name] = 0
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
           ("K1", "K1b", "K5", "K2", "K3", "K4", "K6", "K7", "K8", "K9",
            "K1 fp32", "K1b fp32", "K5 fp32", "K4 fp32", "K2 fp32",
            "K6 fp32", "K7 fp32", "K1 fp32 d<64", "K4 fp32 d<64",
            "K1 fp32 Q over codes", "K1b fp32 Q over codes",
            "K5 fp32 Q over codes", "K3 fp32", "K8 fp32", "K9 fp32",
            "K1 bf16 128-key", "K1b bf16 128-key", "K4 D prologue",
            "K1 fp32 Q over bf16", "K1b fp32 Q over bf16",
            "K5 fp32 Q over bf16", "K6 fp32 q over bf16",
            "K7 fp32 q over bf16", "K1 d256", "K1b d256", "K5 d256",
            "K6 d256", "K7 d256", "K4 d256", "K2 d256", "K3 d256",
            "prologue d256", "K1 f32 d256", "K1b f32 d256", "K5 f32 d256",
            "K8 d256", "K8 f32 d256", "K4 f32 d256", "K2 f32 d256",
            "K3 f32 d256", "K9 d256", "K9 f32 d256", "K9 across processes",
            *F16_ROWS, *MIXED_ROWS)}
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
    def decode_bound(q, seen, k, v, scales=()):
        """bound_ms of one decode call: q, O, LSE and the lengths, and the
        `seen` (live, in-window) tokens of each sequence's K and V at their
        storage width (with their two fp32 scales when quantized)."""
        tokens = int(seen.sum()) * k.shape[1]
        nbytes = (2 * _nbytes(q) + q.shape[0] * (q.shape[1] + 1) * 4
                  + tokens * k.shape[3] * (k.element_size()
                                           + v.element_size())
                  + (tokens * 8 if scales else 0))
        return _bound(nbytes, 4.0 * q.shape[1] * k.shape[3]
                      * int(seen.sum()))

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
        # the library call: a one-row query under the length mask
        live = torch.arange(max_len, device=dev)[None, :] < lengths[:, None]
        lib_ms = sdpa_ms(q[:, :, None], k, v, before=l2_flush.zero_,
                         attn_mask=live[:, None, None, :])
        bound = decode_bound(q, lengths, k, v)
        print(f"[K6] {name}: B=8 H=16 Hkv=4 max_len={max_len} "
              f"lengths={lens} max|dO|={e_o:.3e} (max|O| {ref:.3e}) "
              f"max|dLSE|={e_l:.3e} kernel {ms:.4f} ms "
              f"({vs_bound(ms, bound)}; {ms_w:.4f} ms with the cache warm "
              f"in L2) library call {lib_ms:.4f} ms plain {ms_p:.4f} ms "
              f"({card})", flush=True)
        rec["K6"]["max_abs_err"] = max(rec["K6"]["max_abs_err"], e_o, e_l)
        # the last: the full cache, every key live
        rec["K6"].update(ms=ms, plain_ms=ms_p, library_ms=lib_ms, **bound)
        if not (ok and e_l <= GATE):
            failures.append(f"K6 {name}: dO {e_o:.3e} (max|O| {ref:.3e}) "
                            f"dLSE {e_l:.3e}")
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
        win = effective_windows(8, kw.get("window", 0), kw.get("windows"),
                                dev)
        seen = lengths if win is None else torch.minimum(
            lengths.long(), win.clamp_min(0))
        bound = decode_bound(q, seen, args[1], args[2], skw)
        print(f"[K6] {qtype or 'bf16'} cache, {label}: {live_n} live of "
              f"{cache_n} max|dO|={e_o:.3e} (max|O| {ref:.3e}) "
              f"max|dLSE|={e_l:.3e} wrapper "
              f"{ms:.4f} ms (kernel alone {ms_d:.4f} ms, "
              f"{vs_bound(ms_d, bound)}) plain {ms_p:.4f} ms "
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def kernel_of(form, q, k):
        """(profiler name pattern, launches per call) of a pinned form on
        a bf16 Q: K5 runs K1b's Q-major walk (one launch of K1b's kernel)
        where the rule on its shape sends it there, else its key split and
        the finalise."""
        if form == "kmajor":
            if kmajor_q_walk(d, False, b=q.shape[0], h=q.shape[1],
                             h_kv=k.shape[1], nq=q.shape[2], sms=sms,
                             codes=k.dtype.itemsize == 1):
                return "flash_fwd_bound_kernel", 1
            return "flash_fwd_kmajor", 2
        return {"bound": "flash_fwd_bound_kernel",
                "online": "flash_fwd_kernel"}[form], 1

    def k5_vs_k1b(name, k5, k1b, shared):
        """K5 against K1b: bit for bit where K5 ran K1b's instance
        (`shared`), within 1e-4 on its key split."""
        e = max(diff(k5[0], k1b[0]), diff(k5[1], k1b[1]))
        if shared:
            if not (torch.equal(k5[0], k1b[0]) and torch.equal(k5[1],
                                                                k1b[1])):
                failures.append(f"{name}: K5 on K1b's walk differs from "
                                f"K1b ({e:.3e})")
            return f"K5 on K1b's walk: bit for bit K1b's ({e:.1e})"
        if not e <= 1e-4:
            failures.append(f"{name}: K5 vs K1b {e:.3e} > 1e-4")
        return f"K5 key split vs K1b {e:.3e}"

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
            k5_line = k5_vs_k1b(name, outs["kmajor"], outs["bound"],
                                kernel_of("kmajor", q, k)[1] == 1)
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
            pattern, per_call = kernel_of(routed, q, k)
            ms_d = device_ms(lambda: run_form(routed, q, k, v, **kw),
                             pattern, per_call=per_call)
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
            print(f"[fwd] {name}: auto -> {kern}: {line}; {k5_line}; "
                  f"wrapper ms: online {ms['online']:.4f}, "
                  f"bound (K1b) {ms['bound']:.4f}, K-major (K5) "
                  f"{ms['kmajor']:.4f}; auto {ms_auto:.4f} (unchecked "
                  f"{ms_unchecked:.4f}: the guard costs "
                  f"{(ms_auto - ms_unchecked) * 1e3:.1f} us); {kern} kernel "
                  f"alone {ms_d:.4f} ({vs_bound(ms_d, bound)}); K1 (online) "
                  f"kernel alone {ms_on:.4f} ({vs_bound(ms_on, bound)}); "
                  f"plain {ms_p:.4f}; library call {lib_ms:.4f} ({card})",
                  flush=True)
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
                pattern, per_call = kernel_of(routed_q, q, k)
                ms_qd = device_ms(
                    lambda: flash_attention_forward(q, k, v, **qkw),
                    pattern, per_call=per_call)
                print(f"[fwd] {name}, quantize_q -> "
                      f"{routed_kernel[routed_q]}: {line}; wrapper "
                      f"{ms_q:.4f} ms, kernel alone {ms_qd:.4f} ms "
                      f"({vs_bound(ms_qd, bound)}); library call "
                      f"{lib_ms:.4f} ({card})", flush=True)
        del q, k_bf, v_bf, k, v, got, want, want_on, outs

    # the other side of K5's crossing: one 512-row chunk of one sequence
    # over a 16384-token cache of one-byte codes, where the Q-major grid is
    # 64 CTAs and K5 keeps its key split: over fp8 K/V ("auto" routes
    # there; timed), and over int8 and mixed K/V (K5 pinned), each also
    # under quantize_q, against the plain version and within 1e-4 of K1b
    q = mk(1, h, PAGED_CHUNK, d, peak=Q_PEAK)
    k_bf, v_bf = mk(1, hkv, 16384, d, peak=K_PEAK), mk(1, hkv, 16384, d)
    for qtype in ("fp8", "int8", "mixed"):
        k, v, scales = stored(k_bf, v_bf, qtype)
        name = f"one chunk 512x16384 (B=1), {qtype} K/V"
        pattern, per_call = kernel_of("kmajor", q, k)
        _check(per_call == 2, f"{name}: K5 takes its key split")
        for qq in (False, True):
            tag = name + (", quantize_q" if qq else "")
            qkw = dict(scales, quantize_q=qq)
            want = flash_attention_forward_plain(
                q, k, v, out_dtype=torch.float32, softmax="bound_unchecked",
                **qkw)
            got = run_form("kmajor", q, k, v, **qkw)
            torch.cuda.synchronize()
            line = check_fwd(tag + " pinned kmajor", "K5", got, want)
            k5_line = k5_vs_k1b(tag, got, run_form("bound", q, k, v, **qkw),
                                False)
            if qtype != "fp8" or qq:
                print(f"[fwd] {tag}: K5 pinned (key split): {line}; "
                      f"{k5_line} ({card})", flush=True)
                continue
            zero_counts()
            got = flash_attention_forward(q, k, v, out_dtype=torch.float32,
                                          **scales)
            torch.cuda.synchronize()
            _check(fwd_forms == dict(online=0, bound=0, kmajor=1,
                                     fallback=1),
                   f"{name}: launches {fwd_forms}")
            line = check_fwd(name, "K5", got, flash_attention_forward_plain(
                q, k, v, out_dtype=torch.float32, **scales))
            ms_d = device_ms(lambda: run_form("kmajor", q, k, v, **scales),
                             pattern, per_call=per_call)
            ms_b = device_ms(lambda: run_form("bound", q, k, v, **scales),
                             "flash_fwd_bound_kernel")
            bound = fwd_bound(q, k, v, scales, h * PAGED_CHUNK * 16384)
            k_d = (k.float() * scales["k_scale"][..., None]).to(
                torch.bfloat16)
            v_d = (v.float() * scales["v_scale"][..., None]).to(
                torch.bfloat16)
            lib_ms = sdpa_ms(q, k_d, v_d)
            print(f"[fwd] {name}: auto -> K5 (key split): {line}; "
                  f"{k5_line}; K5 kernel alone {ms_d:.4f} "
                  f"({vs_bound(ms_d, bound)}); K1b's walk there "
                  f"{ms_b:.4f}; library call {lib_ms:.4f} ({card})",
                  flush=True)
            del k_d, v_d
    del q, k_bf, v_bf, k, v, got, want
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
        m = _windowed(model, window) if window else model
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
        if label == "bf16 cache":
            # the last step again, 4 times, under torch.profiler (each
            # call first takes its token back off the caches): the decode
            # step's device time at context 4224, K6's part of it
            def last_step():
                for c in caches:
                    c.length -= 1
                tfm.decode_one(m, tok, long_len - 1, caches)

            prof = kernel_times(last_step, iters=4)
            k6_ms = sum(t for n, t in prof.ms.items()
                        if _kernel_of(n) == "K6")
            k6_n = sum(c for n, c in prof.count.items()
                       if _kernel_of(n) == "K6")
            print(f"[chunked] {label}: one decode step at context "
                  f"{long_len}, device busy {prof.busy_ms / 4:.3f} ms of a "
                  f"profiled wall {prof.wall_ms / 4:.3f} ms; K6 "
                  f"{k6_ms / max(k6_n, 1) * cfg.n_layers:.3f} ms per step "
                  f"({k6_n} launches recorded, {cfg.n_layers} per step) "
                  f"({card})", flush=True)
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
        lib = ""
        if not cache.quantized and not window and len(set(lens.tolist())) == 1:
            # the same keys held contiguously (k_all's prefix, as written
            # into the pools): one library call, its gather not counted
            n = int(lens[0])
            lib_ms = sdpa_ms(q1[:, :, None], k_all[:, :, :n],
                             v_all[:, :, :n], before=l2_flush.zero_)
            lib = (f"; library call on the same keys held contiguously "
                   f"(the gather not counted) {lib_ms:.4f} ms")
        print(f"[K7] {label}: lengths {lens.tolist()} window {window}: "
              f"wrapper {ms:.4f} ms ({vs_bound(ms, bound)}; kernel alone "
              f"{ms_d:.4f} ms; wrapper {ms_w:.4f} ms with the pools warm in "
              f"L2; {nbytes / 1e6:.2f} MB){lib} ({card})", flush=True)
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
          f"K4 {counts['fused']}, K2 {counts['dkdv']}, K3 {counts['dq']}, "
          f"the prologue (D) {counts['delta']} (expect {expect}, {expect}, "
          f"0, 0, {expect})", flush=True)
    _check(counts == dict(fwd=expect, fused=expect, dkdv=0, dq=0,
                          delta=expect),
           f"train-step launch counts {counts}")
    launches["K1"] += counts["fwd"]
    launches["K4"] += counts["fused"]
    launches["K4 D prologue"] += counts["delta"]
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
    _check(split_counts == dict(fwd=n, fused=0, dkdv=n, dq=n, delta=n),
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
                          dq=0, delta=expect),
           f"windowed train-step launch counts {counts}")
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
        l2_flush=l2_flush, step_ms={})
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
    _phase_model_parallel(ctx, mesh, "sp-train", seq_axis="sp")
    torch.cuda.empty_cache()
    _phase_model_parallel(
        ctx, _shared_card_mesh(ctx, TP_SP, TP_SP_AXES), "tp-sp-train",
        seq_axis="sp", head_axis="tp")
    torch.cuda.empty_cache()
    _phase_gpipe(ctx)
    torch.cuda.empty_cache()
    _phase_device_ring_path(ctx)
    _phase_device_ring(ctx, [dev], "sharing card 0", record=True)
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        from cuda_flashattention_torch.parallel.mesh import make_mesh
        over = f"over {n_cards} distinct cards"
        spread = make_mesh((RING_RANKS,), ("sp",),
                           [cards[i % n_cards] for i in range(RING_RANKS)])
        _phase_ring_attention(ctx, spread, over)
        torch.cuda.empty_cache()
        _phase_model_parallel(ctx, spread, "sp-train-cards", seq_axis="sp")
        _phase_device_ring(ctx, cards, over, record=False)
    else:
        print("[sp-train-cards] one card visible: the sp step over distinct "
              "cards is skipped", flush=True)
    torch.cuda.empty_cache()
    _phase_multiprocess(ctx)
    _phase_multiprocess_nccl(ctx)

    # ---- 15-16. fp32: the kernels' fp32 builds and the ladder ------------
    torch.cuda.empty_cache()
    _phase_fp32(ctx)
    torch.cuda.empty_cache()
    _phase_decode_f32(ctx)
    torch.cuda.empty_cache()
    _phase_narrow_heads(ctx)
    torch.cuda.empty_cache()
    _phase_f32_generate(ctx)
    torch.cuda.empty_cache()
    _phase_f32_chunked(ctx)
    torch.cuda.empty_cache()
    _phase_f32_bf16_forward(ctx)
    torch.cuda.empty_cache()
    _phase_f32_bf16_decode(ctx)
    torch.cuda.empty_cache()
    _phase_f32_bf16_serving(ctx)
    torch.cuda.empty_cache()
    _phase_wide_kernels(ctx)
    torch.cuda.empty_cache()
    _phase_gemma_serving(ctx)
    torch.cuda.empty_cache()
    _phase_wide_backward(ctx)
    torch.cuda.empty_cache()
    _phase_gemma_training(ctx)
    torch.cuda.empty_cache()
    _phase_wide_f32_kernels(ctx)
    torch.cuda.empty_cache()
    _phase_gemma_f32_serving(ctx)
    # ---- 29. fp32 training at d = 256, K9 at d <= 256 ---------------------
    torch.cuda.empty_cache()
    t29 = time.perf_counter()
    _phase_wide_backward(ctx, f32=True)
    torch.cuda.empty_cache()
    _phase_wide_ring(ctx)
    torch.cuda.empty_cache()
    _phase_f32_wide_ring_attention(ctx)
    torch.cuda.empty_cache()
    _phase_gemma_f32_training(ctx)
    print(f"[phase 29] {time.perf_counter() - t29:.1f} s", flush=True)
    torch.cuda.empty_cache()
    _phase_utils(ctx)
    torch.cuda.empty_cache()
    _phase_ladder_train(ctx)
    _phase_ladder(ctx)
    torch.cuda.empty_cache()
    _phase_tuning(ctx)
    # ---- 31. fp16 and mixed float types ---------------------------------
    torch.cuda.empty_cache()
    t31 = time.perf_counter()
    for phase in (_phase_f16_kernels, _phase_mixed_kernels,
                  _phase_f16_serving, _phase_mixed_serving,
                  _phase_f16_training):
        phase(ctx)
        torch.cuda.empty_cache()
    print(f"[phase 31] {time.perf_counter() - t31:.1f} s", flush=True)

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
         "(K5, score-bound FA2 forward: under a 2-byte or int8 Q on K1b's "
         "Q-major walk wherever its grid fills the card, the main path, "
         "one-byte K/V converted in the walk; else split "
         "over keys, flash_fwd_kmajor.cu; wgmma + TMA)",
         "flash_fwd_bound.cu",
         "flash_fwd.py:399"),
        ("K6", "decode_attention (K6, one-token decode: bf16, int8, fp8 "
         "and mixed caches, windows, quantize_q; key tiles through a ring "
         "of TMA stages, one producer warp)", "decode.cu",
         "decode.py:145"),
        ("K7", "paged_decode_attention (K7, one-token decode over paged "
         "pools; K6's key tiles, copied as runs inside pages)", "paged.cu",
         "paged.py:51"),
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
        ("K1 fp32", "flash_attention_forward softmax=online on fp32 Q/K/V "
         "(K1's fp32 build: tiles split into bf16 hi + lo, three wgmma "
         "products each; ladder stage 04's diagonal ring steps)",
         "flash_fwd.cu", "flash_fwd.py:123"),
        ("K1b fp32", "flash_attention_forward softmax=bound on fp32 Q/K/V "
         "(K1b's fp32 build; ladder stage 03 and stage 04's full ring "
         "steps)", "flash_fwd_bound.cu", "flash_fwd.py:123"),
        ("K5 fp32", "flash_attention_forward softmax=bound, causal, on fp32 "
         "Q/K/V (K5's fp32 build; flash_attention past 5120 causal rows)",
         "flash_fwd_kmajor.cu", "flash_fwd.py:399"),
        ("K4 fp32", "flash_attention_backward on fp32 Q/K/V/dO (K4's fp32 "
         "build, fp32 dK/dV; ladder stage 04's ring backward)",
         "flash_bwd_kv.cu", "flash_bwd.py:252"),
        ("K6 fp32", "decode_attention on an fp32 q (K6's fp32 builds: fp32, "
         "int8, fp8 and mixed caches, d 16, 32, 64, 128, P unrounded; the "
         "fp32 serving model's generate() over fp32 and int8 caches at d "
         "128, ladder stages 05 at d 16 and 06 at d 32)", "decode.cu",
         "decode.py:145"),
        ("K7 fp32", "paged_decode_attention on an fp32 q (K7's fp32 builds; "
         "ladder stage 06's fp32 pools at d 32, 16-token pages)",
         "paged.cu", "paged.py:51"),
        ("K1 fp32 d<64", "flash_attention_forward on fp32 Q/K/V at d 16 "
         "(K1's fp32 build on heads zero-padded to 64: ladder stage 05's "
         "prefill and teacher-forced forward, the ladder model's training "
         "steps)", "flash_fwd.cu", "flash_fwd.py:123"),
        ("K4 fp32 d<64", "flash_attention_backward on fp32 Q/K/V/dO at d 16 "
         "(K4's fp32 build on heads zero-padded to 64: the ladder model's "
         "training steps)", "flash_bwd_kv.cu", "flash_bwd.py:252"),
        ("K1b fp32 Q over codes", "flash_attention_forward softmax=bound "
         "on an fp32 Q over int8, fp8 or mixed K/V (K1b's fp32-Q build: Q "
         "split into bf16 hi + lo, the codes exact in bf16, two wgmma "
         "products each, P unrounded; the fp32 serving model's chunked "
         "prefill reading its int8, fp8 and mixed caches)",
         "flash_fwd_bound.cu", "flash_fwd.py:123"),
        ("K5 fp32 Q over codes", "flash_attention_forward softmax=bound, "
         "causal, on an fp32 Q over one-byte K/V (K5's fp32-Q build; the "
         "fp32 serving model's windowed prefix reads over an int8 cache)",
         "flash_fwd_kmajor.cu", "flash_fwd.py:399"),
        ("K1 fp32 Q over codes", "flash_attention_forward softmax=online "
         "on an fp32 Q over one-byte K/V (K1's fp32-Q build; on the main "
         "path the guarded launch behind each prefix read of the fp32 "
         "chunked serving runs, which exits at once when no row's bound "
         "was loose)", "flash_fwd.cu", "flash_fwd.py:123"),
        ("K2 fp32", "flash_attention_backward fused=False on fp32 (K2's fp32 "
         "build; flash_attention's split backward on fp32 [1, 16, 6144, "
         "128] causal)", "flash_bwd_kv.cu", "flash_bwd.py:117"),
        ("K3 fp32", "flash_attention_backward fused=False on fp32 (K3's fp32 "
         "build: 32-key tiles, split tiles, three wgmma products each; "
         "flash_attention's split backward on fp32 [1, 16, 6144, 128] "
         "causal)", "flash_bwd.cu", "flash_bwd.py:192"),
        ("K8 fp32", "fa1_attention on fp32 (K8's fp32 build, d 32 on heads "
         "padded to 64: [1, 16, 4096, 128] causal and not, and the "
         "reference rung's seeded 64 x 32 case)", "fa1.cu", "fa1.py:54"),
        ("K9 fp32", "device_ring_matmul on fp32 shards and W (K9's fp32 "
         "build: split images pushed, three wgmma products a step; n=4 "
         "L=1024 d=128)", "device_ring.cu",
         "examples/07_device_ring.py:46"),
        ("K1 bf16 128-key", "flash_attention_forward block_sizes.block_k="
         "128 (K1's 128-key build: one m64n128 wgmma a step for S; the "
         "serving model's prefill and chunked prefill at 128 keys; times "
         "at [1, 16, 4096, 128] causal)", "flash_fwd.cu", "flash_fwd.py:123"),
        ("K1b bf16 128-key", "flash_attention_forward softmax=bound, "
         "block_sizes.block_k=128 (K1b's 128-key build; the chunked "
         "prefill's prefix reads at 128 keys; times at the prefix, 512 x "
         "3584)", "flash_fwd_bound.cu", "flash_fwd.py:123"),
        ("K4 D prologue", "flash_attention_backward's prologue (D = "
         "rowsum(dO * O) and K4's dQ accumulator zeroed, one launch before "
         "K4 or K2 + K3; the train steps; times at [1, 16, 4096, 128])",
         "flash_bwd_kv.cu", "flash_bwd.py:252"),
        ("K1b fp32 Q over bf16", "flash_attention_forward softmax=bound on "
         "an fp32 Q over bf16 K/V (K1b's BF16KV build: Q split into bf16 hi "
         "+ lo, the bf16 K/V tiles as TMA brings them, two wgmma products "
         "each, P unrounded; the fp32 serving model's chunked prefill "
         "reading its bf16 caches; times at the prefix, 512 x 3584)",
         "flash_fwd_bound.cu", "flash_fwd.py:123"),
        ("K1 fp32 Q over bf16", "flash_attention_forward softmax=online on "
         "an fp32 Q over bf16 K/V (K1's BF16KV build; the fp32 model's "
         "windowed prefix reads over bf16 caches, and the guarded launch "
         "behind each K1b / K5 read, which exits at once; times at the "
         "prefix)", "flash_fwd.cu", "flash_fwd.py:123"),
        ("K5 fp32 Q over bf16", "flash_attention_forward softmax=auto, "
         "causal past 5120 rows, on an fp32 Q over bf16 K/V (K5's BF16KV "
         "build; [1, 16, 6144, 128])", "flash_fwd_kmajor.cu",
         "flash_fwd.py:399"),
        ("K6 fp32 q over bf16", "decode_attention on an fp32 q over a bf16 "
         "cache (K6's builds QT = float over bf16 storage, d 16-128, P "
         "unrounded; the fp32 serving model's decode over bf16 caches; "
         "times at B=8 H=16 Hkv=4, 4224 live of 4352)", "decode.cu",
         "decode.py:145"),
        ("K7 fp32 q over bf16", "paged_decode_attention on an fp32 q over "
         "bf16 pools (K7's builds QT = float over bf16 storage, bit for bit "
         "K6's; the paged run over bf16 pools at d 128, 128-token pages)",
         "paged.cu", "paged.py:51"),
        ("K1 d256", "flash_attention_forward at d = 256 (K1's d = 256 build, "
         "a bf16 Q over bf16 or one-byte K/V: S, softmax and P·V of a key "
         "tile in order; the Gemma-width model's prefill and chunks, also "
         "counted under K1; times at B=8 H=8 Hkv=4 512 causal)",
         "flash_fwd.cu", "flash_fwd.py:123"),
        ("K1b d256", "flash_attention_forward softmax=bound at d = 256 "
         "(K1b's d = 256 build, one-byte K/V converted into exact 2-byte "
         "copies by a pass of their own before the walk; the Gemma-width "
         "model's prefix reads over bf16 and int8 caches, also counted "
         "under K1b; times at the prefix, 512 x 3584)",
         "flash_fwd_bound.cu", "flash_fwd.py:123"),
        ("K5 d256", "flash_attention_forward softmax=bound, fp8 keys or "
         "causal, at d = 256 (K5's d = 256 build: K1b's Q-major walk, one-"
         "byte K/V converted before it, no partial sums; the Gemma-width "
         "model's prefix reads over an fp8 cache and under its window, "
         "also counted under K5; times over fp8 K/V at the prefix, "
         "512 x 3584)", "flash_fwd_bound.cu", "flash_fwd.py:399"),
        ("K6 d256", "decode_attention at d = 256 (K6's d = 256 builds, eight "
         "elements a lane; the Gemma-width model's decode, also counted "
         "under K6; times at B=8 H=8 Hkv=4, 4224 live of 4352, cold L2)",
         "decode.cu", "decode.py:145"),
        ("K7 d256", "paged_decode_attention at d = 256 (K7's d = 256 "
         "builds, bit for bit K6's; the Gemma-width paged loop, also "
         "counted under K7; times at 4224 live tokens in 128-token pages)",
         "paged.cu", "paged.py:51"),
        ("K4 d256", "flash_attention_backward at d = 256 (K4's d = 256 "
         "build: 64-key CTAs, the warpgroups splitting the query columns "
         "of S and dP and then d, dQ by atomics; the Gemma-width model's "
         "train steps, also counted under K4; times at [1, 8, 4096, 256] "
         "over 4 KV heads, causal)", "flash_bwd_kv.cu", "flash_bwd.py:252"),
        ("K2 d256", "flash_attention_backward fused=False at d = 256 (K2's "
         "d = 256 build; the Gemma-width model's split-backward step, also "
         "counted under K2; times at [1, 8, 4096, 256], causal)",
         "flash_bwd_kv.cu", "flash_bwd.py:117"),
        ("K3 d256", "flash_attention_backward fused=False at d = 256 (K3's "
         "d = 256 build: 32-key tiles beside resident Q and dO; the "
         "Gemma-width model's split-backward step, also counted under K3; "
         "times at [1, 8, 4096, 256], causal)", "flash_bwd.cu",
         "flash_bwd.py:192"),
        ("prologue d256", "flash_attention_backward's prologue at d = 256 "
         "(D = rowsum(dO * O) and K4's zeroed dQ accumulator, one warp a "
         "row; the Gemma-width model's train steps, also counted under "
         "K4 D prologue; times at [1, 8, 4096, 256])", "flash_bwd_kv.cu",
         "flash_bwd.py:252"),
        ("K1 f32 d256", "flash_attention_forward on an fp32 Q at d = 256 "
         "(K1's fp32-Q d = 256 builds: over fp32 K/V in 32-key split tiles, "
         "over bf16 or one-byte K/V in 64-key tiles, one stage beside the "
         "128 KB split Q tile; the fp32 Gemma-width model's prefill and "
         "chunks; times over fp32 K/V at B=8 H=8 Hkv=4 512 causal)",
         "flash_fwd.cu", "flash_fwd.py:123"),
        ("K1b f32 d256", "flash_attention_forward softmax=bound on an fp32 Q "
         "at d = 256 (K1b's fp32-Q d = 256 builds; the fp32 Gemma-width "
         "model's prefix reads over fp32, bf16, int8 and fp8 caches; times "
         "over fp32 K/V at the prefix, 512 x 3584)", "flash_fwd_bound.cu",
         "flash_fwd.py:123"),
        ("K5 f32 d256", "flash_attention_forward softmax=bound, causal, on "
         "an fp32 Q at d = 256 (K5's fp32-Q d = 256 builds: a span of one "
         "tile beside a ring of one split Q tile; the fp32 Gemma-width "
         "model's windowed prefix reads over an int8 cache; times over int8 "
         "K/V at the windowed prefix, 512 x 1024)", "flash_fwd_kmajor.cu",
         "flash_fwd.py:399"),
        ("K8 d256", "fa1_attention at d = 256 in bf16 (K8's d = 256 build, "
         "two stages; [1, 8, 4096, 256] causal and not)", "fa1.cu",
         "fa1.py:54"),
        ("K8 f32 d256", "fa1_attention at d = 256 in fp32 (K8's fp32 d = 256 "
         "build: 32-key split tiles, two to each 64-key tile of a block; "
         "[1, 8, 4096, 256] causal and not)", "fa1.cu", "fa1.py:54"),
        ("K4 f32 d256", "flash_attention_backward on fp32 at d = 256 (K4's "
         "fp32 d = 256 build: 64-key CTAs streaming 32-row split Q / dO "
         "tiles, one stage, dQ as dQᵀ = Kᵀ·dSᵀ by 4-byte atomics; the fp32 "
         "Gemma-width model's train steps and the fp32 ring attention at d "
         "= 256; times at [1, 8, 4096, 256] over 4 KV heads, causal)",
         "flash_bwd_kv.cu", "flash_bwd.py:252"),
        ("K2 f32 d256", "flash_attention_backward fused=False on fp32 at d "
         "= 256 (K2's fp32 d = 256 build, K4's walk without dQ; the fp32 "
         "Gemma-width model's split-backward step; times at [1, 8, 4096, "
         "256], causal)", "flash_bwd_kv.cu", "flash_bwd.py:117"),
        ("K3 f32 d256", "flash_attention_backward fused=False on fp32 at d "
         "= 256 (K3's fp32 d = 256 build: 64-row CTAs, one consumer "
         "warpgroup, 16-key split tiles in three stages; the fp32 "
         "Gemma-width model's split-backward step; times at [1, 8, 4096, "
         "256], causal)", "flash_bwd.cu", "flash_bwd.py:192"),
        ("K9 d256", "device_ring_matmul at d = 256 in bf16 (K9's d = 256 "
         "build: W whole, one tile a round; the example stage at --width "
         "256, n=4 L=1024)", "device_ring.cu",
         "examples/07_device_ring.py:46"),
        ("K9 f32 d256", "device_ring_matmul at d = 256 in fp32 (K9's fp32 "
         "d = 256 build: two CTAs a span, each holding one column half of "
         "W split, two rings that share nothing; n=4 L=1024)",
         "device_ring.cu", "examples/07_device_ring.py:46"),
        ("K9 across processes", "device_ring_matmul over a ring whose ranks "
         "run in 4 processes sharing the card (K9's .sys build over "
         "buffers and flags mapped by CUDA IPC handles; also counted under "
         "K9; n=4 L=1024 d=128 bf16; ms: the kernel's time while the card "
         "switches between the processes' contexts, time-sliced, per "
         "process; plain: the plain ring across the same processes)",
         "device_ring.cu", "examples/07_device_ring.py:46"),
        ("K1 f16", "flash_attention_forward on fp16 Q/K/V or an fp16 Q over "
         "int8, fp8 or mixed K/V (K1's fp16 build: bf16's kernel with fp16 "
         "operands, .f16 wgmma, P rounded to fp16; the fp16 serving model's "
         "prefill and chunks, the fp16 training steps; times at [1, 16, "
         "4096, 128] causal)", "flash_fwd_f16.cu", "flash_fwd.py:123"),
        ("K1b f16", "flash_attention_forward softmax=bound on an fp16 Q "
         "(K1b's fp16 build; the fp16 model's chunked prefix reads over "
         "fp16, int8 and fp8 caches; times at the prefix, 512 x 3584)",
         "flash_fwd_bound_f16.cu", "flash_fwd.py:123"),
        ("K5 f16", "flash_attention_forward softmax=bound, causal, on an "
         "fp16 Q (K5's fp16 build, on K1b's fp16 Q-major walk at these "
         "grids; the fp16 model's windowed prefix reads over an int8 "
         "cache; times at the prefix, 512 x 3584)",
         "flash_fwd_bound_f16.cu", "flash_fwd.py:399"),
        ("K6 f16", "decode_attention on an fp16 q over fp16, int8, fp8 or "
         "mixed caches (K6's fp16-q unit: P rounded to fp16, bf16 under "
         "quantize_q; the fp16 model's generate() and chunked serving; "
         "times at B=8 H=16 Hkv=4, 4224 live of 4352, cold L2)",
         "decode_f16.cu", "decode.py:145"),
        ("K7 f16", "paged_decode_attention on an fp16 q over fp16 pools "
         "(K7's fp16-q unit, bit for bit K6's; the paged loop over fp16 "
         "pools; times at 4224 live tokens in 128-token pages)",
         "paged_f16.cu", "paged.py:51"),
        ("K2 f16", "flash_attention_backward fused=False on fp16 (K2's fp16 "
         "build; the fp16 model's split-backward step; times at [1, 16, "
         "4096, 128] causal)", "flash_bwd_kv_f16.cu", "flash_bwd.py:117"),
        ("K3 f16", "flash_attention_backward fused=False on fp16 (K3's fp16 "
         "build; the fp16 model's split-backward step; times at [1, 16, "
         "4096, 128] causal)", "flash_bwd_f16.cu", "flash_bwd.py:192"),
        ("K4 f16", "flash_attention_backward on fp16 (K4's fp16 build: P "
         "rounded to dO's type, dS to q's and k's, all fp16; the fp16 "
         "model's train steps; times at [1, 16, 4096, 128] causal)",
         "flash_bwd_kv_f16.cu", "flash_bwd.py:252"),
        ("prologue f16", "flash_attention_backward's prologue on fp16 O "
         "and dO (D = rowsum(dO * O), K4's dQ accumulator zeroed; the fp16 "
         "model's train steps; times at [1, 16, 4096, 128])",
         "flash_bwd_kv.cu", "flash_bwd.py:252"),
        ("K8 f16", "fa1_attention on fp16 (K8's fp16 build, P in v's type; "
         "[1, 16, 4096, 128] causal)", "fa1_f16.cu", "fa1.py:54"),
        ("K9 f16", "device_ring_matmul on fp16 shards and W (K9's fp16 "
         "build, o fp32; n=4 L=1024 d=128)", "device_ring_f16.cu",
         "examples/07_device_ring.py:46"),
        ("forward mixed", "flash_attention_forward on Q, K, V of mixed float "
         "types (K1, K1b and K5's fp32 builds on Q and, unless both bf16, "
         "K/V upcast exactly, P rounded to Q's type before P·V; the bf16 "
         "model's chunked prefix reads over fp32 caches, the fp16 model's "
         "over bf16 caches, flash_attention on bf16 q, k over an fp32 v; "
         "times: K1b, a bf16 Q over fp32 K/V at the prefix, 512 x 3584)",
         "flash_fwd_bound.cu", "flash_fwd.py:123"),
        ("decode mixed", "decode_attention / paged_decode_attention on a q "
         "over a float cache of another type (K6 / K7's fp32-q unit on q "
         "upcast, P rounded to q's type; the bf16 model's decode over fp32 "
         "caches, the fp16 model's over bf16 caches; times: K6, a bf16 q "
         "over an fp32 cache, B=8 H=16 Hkv=4, 4224 live of 4352)",
         "decode_f32.cu", "decode.py:145"),
        ("backward mixed", "flash_attention_backward on q / k / v / dO of "
         "mixed float types (K4, or K2 + K3 where q's and k's types differ, "
         "fp32 builds on upcast operands, P rounded to dO's type, dS to q's "
         "and k's; flash_attention on bf16 q, k over an fp32 v at [1, 16, "
         "4096, 128] causal; times: K4 there)", "flash_bwd_kv.cu",
         "flash_bwd.py:252"),
        ("K8 mixed", "fa1_attention on mixed float types (K8's fp32 build "
         "on upcast operands, P rounded to v's type; an fp32 Q over bf16 "
         "K/V at [1, 16, 4096, 128] causal)", "fa1.cu", "fa1.py:54"),
        ("K9 mixed", "device_ring_matmul on x and W of two float types "
         "(K9's fp32 build on W upcast; fp32 x over bf16 W, n=4 L=1024 "
         "d=128)", "device_ring.cu", "examples/07_device_ring.py:46"),
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
        # every number of the row measured in this run
        numbers = [r[x] for x in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms")]
        if r["library_ms"] is not None:
            numbers.append(r["library_ms"])
        _check(all(math.isfinite(x) for x in numbers),
               f"{kn}: a number of its row is not finite ({numbers})")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
