"""Time each kernel family's bf16 and fp16 builds at the same shapes, in
one process on one card, to compare the two element types.

    python3 -m cuda_flashattention_torch.utils.dtype_times [--rounds N]

For each row below it runs the bf16 build, the fp16 build, the fp16 build
again and the bf16 build again (N rounds of that order) and prints the
median device ms per call of the row's kernel (torch.profiler: the
kernel's time over its launches), both medians and their ratio:
  - K1 (online, causal) at the training shape [1, 16, 4096, 128];
  - K1b and K5 (`softmax="bound_unchecked"`, pinned) at the chunked
    prefill's prefix, 512 query rows over 3584 keys, B=8, H=16 over 4 KV
    heads;
  - K6 and K7 (128-token pages) at B=8, H=16 over 4 KV heads, 4224 live
    keys of 4352, each on a cold L2 (a 256 MiB write before every call);
  - K4, and K2 + K3 (`fused=False`), at the training shape, causal;
  - K8 (FA1) at the training shape, causal;
  - K9 (`device_ring_matmul`) at n=4 ranks sharing the card, L=1024,
    d=128.
The inputs are uniform in [-0.5, 0.5), Q x4 for the bound forms (whose
fp16 P underflows past ~2^-24 under a loose bound). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import statistics

# profiler kernel names of each row's kernel
_NAMES = {"K1": r"flash_fwd_kernel", "K1b": r"flash_fwd_bound_kernel",
          "K5": r"flash_fwd_kmajor", "K6": r"::decode_kernel<",
          "K7": r"::paged_kernel<", "K4": r"flash_bwd_kv_kernel<\d+, true,",
          "K2": r"flash_bwd_kv_kernel<\d+, false,",
          "K3": r"flash_bwd_q_kernel", "K8": r"fa1_kernel",
          "K9": r"device_ring_kernel"}


def kernel_ms(fn, label: str, before=None, iters: int = 3) -> float:
    """Device ms per call of `label`'s kernel over `iters` calls of fn()
    (each after before(), when given); NaN when none was recorded."""
    from cuda_flashattention_torch.utils.profiling import kernel_times
    call = fn if before is None else (lambda: (before(), fn()))
    prof = kernel_times(call, iters=iters)
    names = [n for n in prof.ms if re.search(_NAMES[label], n)]
    calls = sum(prof.count[n] for n in names if "finalize" not in n)
    return sum(prof.ms[n] for n in names) / calls if calls else float("nan")


def rows(dev):
    """(label, make(dtype) -> (call, before or None)) of each row."""
    import torch

    from cuda_flashattention_torch.ops import flash_bwd as fb
    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.fa1 import fa1_attention
    from cuda_flashattention_torch.ops.paged import paged_decode_attention
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    from cuda_flashattention_torch.parallel.mesh import make_mesh

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev).zero_

    def u(shape, dtype, peak=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) - 0.5)
                * peak).to(dtype)

    def online(dt):
        q, k, v = (u((1, 16, 4096, 128), dt) for _ in range(3))
        return lambda: ff.flash_attention_forward(
            q, k, v, causal=True, softmax="online"), None

    def bound(form):
        def make(dt):
            q = u((8, 16, 512, 128), dt, 4.0)
            k, v = (u((8, 4, 3584, 128), dt) for _ in range(2))
            plan = ff._plan(q, k, v, None, False, 0, 0, None, None, None,
                            None, None, "bound_unchecked", False)
            plan = dataclasses.replace(plan, use_kmajor=form == "K5")
            return lambda: ff._fwd_cuda(q, k, v, plan, torch.float32, None,
                                        None, None, None), None
        return make

    def decode(paged):
        def make(dt):
            b, h, hkv, cap, live, d, page = 8, 16, 4, 4352, 4224, 128, 128
            q = u((b, h, d), dt)
            k, v = (u((b, hkv, cap, d), dt) for _ in range(2))
            lens = torch.full((b,), live, dtype=torch.int32, device=dev)
            if not paged:
                return lambda: decode_attention(q, k, v, lens), flush
            n = cap // page

            def pages(x):
                return x.view(b, hkv, n, page, d).transpose(1, 2).reshape(
                    b * n, hkv, page, d).contiguous()
            kp, vp = pages(k), pages(v)
            table = torch.arange(b * n, dtype=torch.int32,
                                 device=dev).view(b, n)
            return lambda: paged_decode_attention(q, kp, vp, table,
                                                  lens), flush
        return make

    def backward(label):
        def make(dt):
            q, k, v, do = (u((1, 16, 4096, 128), dt) for _ in range(4))
            o, lse = ff.flash_attention_forward(q, k, v, causal=True)
            if label == "K2":
                return lambda: fb._dkdv_cuda(q, k, v, o, lse, do,
                                             causal=True), None
            return lambda: fb.flash_attention_backward(
                q, k, v, o, lse, do, causal=True,
                fused=label == "K4"), None
        return make

    def fa1(dt):
        q, k, v = (u((1, 16, 4096, 128), dt) for _ in range(3))
        return lambda: fa1_attention(q, k, v, causal=True), None

    def ring(dt):
        mesh = make_mesh((4,), ("sp",), [dev] * 4)
        x, w = u((4 * 1024, 128), dt), u((128, 128), dt)
        return lambda: device_ring_matmul(x, w, mesh), None

    return [("K1", online), ("K1b", bound("K1b")), ("K5", bound("K5")),
            ("K6", decode(False)), ("K7", decode(True)),
            ("K4", backward("K4")), ("K2", backward("K2")),
            ("K3", backward("K3")), ("K8", fa1), ("K9", ring)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_flashattention_torch.utils.dtype_times",
        description="bf16 against fp16 builds, kernel ms at equal shapes")
    ap.add_argument("--rounds", type=int, default=3)
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("dtype_times times the card's kernels: it needs "
                           "a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    for label, make in rows(dev):
        calls = {dt: make(dt) for dt in (torch.bfloat16, torch.float16)}
        times = {dt: [] for dt in calls}
        order = (torch.bfloat16, torch.float16, torch.float16,
                 torch.bfloat16)
        for _ in range(opts.rounds):
            for dt in order:
                fn, before = calls[dt]
                times[dt].append(kernel_ms(fn, label, before))
        bf = statistics.median(times[torch.bfloat16])
        f16 = statistics.median(times[torch.float16])
        print(f"{label}: bf16 {bf:.4f} ms, fp16 {f16:.4f} ms (medians of "
              f"{2 * opts.rounds}), fp16 / bf16 {f16 / bf:.3f}; bf16 "
              + ", ".join(f"{t:.4f}" for t in times[torch.bfloat16])
              + "; fp16 " + ", ".join(f"{t:.4f}"
                                      for t in times[torch.float16]),
              flush=True)
        del calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
