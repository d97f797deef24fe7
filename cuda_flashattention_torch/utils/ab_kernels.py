"""Time the forward and fused-backward kernels of one checkout of this
package, to compare two commits on one card within one call.

    python3 cuda_flashattention_torch/utils/ab_kernels.py <checkout root>

imports `cuda_flashattention_torch` from <checkout root> (building its
kernels there), and prints, on bf16 inputs with d=128:
  - the online forward (K1) and the fused backward (K4), both causal, at
    the serving prefill shape (B=8, H=16, Hkv=4, N=512, fp32 out) and the
    training shape (B=1, H=16, N=4096, bf16 out); K1 there also under
    window 1024;
  - at the training shape: K4 under window 1024 and without a mask (a
    ring step's full 4096 x 4096 block), and the split backward's dK/dV
    kernel (K2, `fused=False`; its K3 launch is listed beside it);
  - K1's other forms: at the chunked-prefill prefix pinned online over
    bf16 and int8 K/V, and under segment ids (the serving chunk's shape,
    causal and not);
  - FA1 (K8) at B=1, H=16, N=4096, causal and not;
  - the score-bound forward (`softmax="bound_unchecked"`, no guarded
    fallback launch) at the chunked-prefill prefix (B=8, H=16, Hkv=4, 512
    query rows over 3584 keys, fp32 out): K1b over bf16 and int8 K/V, K5
    over fp8 K/V; and K5 at B=1, H=16, N=16384 causal (the one-rank call
    of the ring's shape, and Ulysses').
For each: the wrapper's median ms (CUDA events) and the device ms per
call of its kernels (torch.profiler), with each kernel's ms per launch.
The K4 rows run first, so that both checkouts reach them after the same
work.
Unpack the parent commit beside the change (`git archive <commit> | tar
-x -C <dir>`) and run parent, change, change, parent: two cards, or two
calls, differ by more than two commits do. Needs a CUDA device.
"""

import sys


def main(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from cuda_flashattention_torch.ops.fa1 import fa1_attention
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    from cuda_flashattention_torch.ops.quant import quantize_kv
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

    def report(label, fn, word, iters):
        """`label`: wrapper ms, the device ms per call of the kernels whose
        name holds `word` (each launches once a call) and each listed
        package kernel's ms per launch."""
        wrapper = cuda_time_ms(fn, iters=iters)
        prof = kernel_times(fn, iters=max(1, iters // 4))
        names = [n for n in prof.ms if word in n]
        per_call = sum(prof.ms[n] / prof.count[n] for n in names)
        each = ", ".join(f"{short(n)} "
                         f"{prof.ms[n] / prof.count[n]:.4f}" for n in prof.ms
                         if "flash_" in n or "fa1" in n)
        print(f"{root} {label}: wrapper {wrapper:.4f} ms, kernels "
              f"{per_call:.4f} ms per call [{each}] ({card})", flush=True)

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
    report("train K2 dK/dV (fused=False)",
           lambda: flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                            fused=False), "flash_bwd_kv", 20)
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


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
