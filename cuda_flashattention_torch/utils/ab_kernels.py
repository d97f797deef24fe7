"""Time the forward and fused-backward kernels of one checkout of this
package, to compare two commits on one card within one call.

    python3 cuda_flashattention_torch/utils/ab_kernels.py <checkout root>

imports `cuda_flashattention_torch` from <checkout root> (building its
kernels there), and prints, for the serving prefill shape (B=8, H=16,
Hkv=4, N=512, fp32 out) and the training shape (B=1, H=16, N=4096, bf16
out), both causal, bf16, d=128: the forward wrapper's median ms (CUDA
events), the forward kernel's own device ms per launch (torch.profiler),
and the same for the fused backward. Unpack the parent commit beside the
change (`git archive <commit> | tar -x -C <dir>`) and run parent, change,
change, parent: two cards, or two calls, differ by more than two commits
do. Needs a CUDA device.
"""

import sys


def main(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    from cuda_flashattention_torch.utils.profiling import kernel_times
    from cuda_flashattention_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def mk(*shape):
        return (torch.rand(shape, generator=gen, device=dev) - 0.5).to(
            torch.bfloat16)

    def per_launch(prof, word):
        return ", ".join(f"{prof.ms[n] / prof.count[n]:.4f}"
                         for n in prof.ms if word in n)

    for name, (b, h, hkv, n), out_dtype in (
            ("prefill", (8, 16, 4, 512), torch.float32),
            ("train", (1, 16, 16, 4096), torch.bfloat16)):
        q, do = mk(b, h, n, 128), mk(b, h, n, 128)
        k, v = mk(b, hkv, n, 128), mk(b, hkv, n, 128)

        def fwd():
            return flash_attention_forward(q, k, v, causal=True,
                                           out_dtype=out_dtype)

        o, lse = fwd()

        def bwd():
            return flash_attention_backward(q, k, v, o, lse, do, causal=True)

        print(f"{root} {name}: forward wrapper "
              f"{cuda_time_ms(fwd, iters=50):.4f} ms, kernel "
              f"{per_launch(kernel_times(fwd, iters=10), 'flash_fwd')} ms; "
              f"fused backward wrapper {cuda_time_ms(bwd, iters=20):.4f} ms, "
              f"kernel {per_launch(kernel_times(bwd, iters=5), 'flash_bwd')}"
              f" ms ({torch.cuda.get_device_name(0)})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
