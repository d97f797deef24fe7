"""Time K5 (the key-split forward) under each span it can keep resident,
beside K1b (the Q-major walk) on the same call.

    python3 cuda_flashattention_torch/utils/kmajor_spans.py

An fp32 Q over int8 K/V at the fp32 serving model's prefix reads (B=8,
H=16, Hkv=4, 512 query rows over 3584 keys, and over the 1024-key slice
under window 1024) and at B=1, H=16, Hkv=4, N=4096 causal, d=128; and a
bf16 Q over fp8 K/V (where "auto" routes to K5) at the Gemma-width
model's prefix reads (B=8, H=8, Hkv=4, d=256: 512 over 3584, and the
windowed slice); fp32 out. Each form pinned through
`ops.flash_fwd._plan` + `_fwd_cuda` (no guarded fallback), K5 with its
span forced to each span its build keeps (1 to 3 at d=128 under an fp32
Q; 1 alone at d=256), then the span the host rule picks
(`_kmajor_span`). Prints the device ms per call of every kernel of a call
(torch.profiler over 5 calls: the score bound's reductions, the kernel,
K5's finalise). Needs a CUDA device.
"""

import dataclasses
import sys
from pathlib import Path


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from cuda_flashattention_torch.ops import flash_fwd as ff
    from cuda_flashattention_torch.ops.quant import quantize_kv
    from cuda_flashattention_torch.utils.profiling import kernel_times

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    rule = ff._kmajor_span
    window = dict(causal=True, window=1024, kv_offset=1024)
    cases = [  # (name, shape, mask, Q dtype, K/V storage)
        ("windowed prefix", (8, 16, 4, 512, 1024, 128), window,
         torch.float32, "int8"),
        ("prefix", (8, 16, 4, 512, 3584, 128), dict(), torch.float32,
         "int8"),
        ("4096 causal GQA", (1, 16, 4, 4096, 4096, 128), dict(causal=True),
         torch.float32, "int8"),
        ("d=256 prefix", (8, 8, 4, 512, 3584, 256), dict(), torch.bfloat16,
         "fp8"),
        ("d=256 windowed prefix", (8, 8, 4, 512, 1024, 256), window,
         torch.bfloat16, "fp8"),
    ]
    for name, (b, h, hkv, nq, nk, d), kw, qdt, qtype in cases:
        def u(*shape):
            return torch.rand(shape, generator=gen, device=dev) - 0.5
        q = u(b, h, nq, d).to(qdt)
        kv = quantize_kv(u(b, hkv, nk, d), u(b, hkv, nk, d), qtype)
        plan = ff._plan(q, kv.k_q, kv.v_q, None, kw.get("causal", False),
                        kw.get("window", 0), kw.get("kv_offset", 0), None,
                        kv.k_scale, kv.v_scale, None, None,
                        "bound_unchecked", False)
        f32 = qdt == torch.float32
        picked = rule(b, hkv, nk, d, sms, f32, True)
        longest = (ff._KMAJOR_MAX_SPAN_F32Q if f32 else
                   ff._KMAJOR_MAX_SPAN)[d]
        runs = [("K1b", 0)] + [("K5", s) for s in range(
            1, longest + 1)] + [("K5 rule", picked)]
        for form, span in runs:
            p = dataclasses.replace(plan, use_kmajor=form != "K1b")
            ff._kmajor_span = lambda *a, s=span: s
            try:
                def call():
                    return ff._fwd_cuda(q, kv.k_q, kv.v_q, p, torch.float32,
                                        kv.k_scale, kv.v_scale, None, None)
                call()
                torch.cuda.synchronize()
                prof = kernel_times(call, iters=5)
            finally:
                ff._kmajor_span = rule
            ms = sum(prof.ms.values()) / 5
            what = form if form == "K1b" else f"{form} span {span}"
            print(f"{name} B={b} H={h} Hkv={hkv} Nq={nq} Nk={nk} d={d}: "
                  f"{what}: {ms:.4f} ms per call ({card})", flush=True)


if __name__ == "__main__":
    main()
