"""Time K5 (the key-split forward) on an fp32 Q over int8 K/V under each
span it can keep resident, beside K1b (the Q-major walk) on the same call.

    python3 cuda_flashattention_torch/utils/kmajor_spans.py

At the fp32 serving model's prefix reads (B=8, H=16, Hkv=4, 512 query rows
over 3584 keys, and over the 1024-key slice under window 1024) and at
B=1, H=16, Hkv=4, N=4096 causal, d=128, fp32 out: each form pinned through
`ops.flash_fwd._plan` + `_fwd_cuda` (no guarded fallback), K5 with its
span forced to 1, 2 and 3, then the span the host rule picks
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
    cases = [
        ("windowed prefix", (8, 16, 4, 512, 1024, 128),
         dict(causal=True, window=1024, kv_offset=1024)),
        ("prefix", (8, 16, 4, 512, 3584, 128), dict()),
        ("4096 causal GQA", (1, 16, 4, 4096, 4096, 128), dict(causal=True)),
    ]
    for name, (b, h, hkv, nq, nk, d), kw in cases:
        def u(*shape):
            return torch.rand(shape, generator=gen, device=dev) - 0.5
        q = u(b, h, nq, d)
        kv = quantize_kv(u(b, hkv, nk, d), u(b, hkv, nk, d), "int8")
        plan = ff._plan(q, kv.k_q, kv.v_q, None, kw.get("causal", False),
                        kw.get("window", 0), kw.get("kv_offset", 0), None,
                        kv.k_scale, kv.v_scale, None, None,
                        "bound_unchecked", False)
        picked = rule(b, hkv, nk, d, sms, True, True)
        runs = [("K1b", 0)] + [("K5", s) for s in range(
            1, ff._KMAJOR_MAX_SPAN_F32Q[d] + 1)] + [("K5 rule", picked)]
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
