"""Time the model's train step on a mesh for one checkout of this package,
to compare two commits on one card within one call.

    python3 cuda_flashattention_torch/utils/ab_model_parallel.py <checkout root>

imports `cuda_flashattention_torch` from <checkout root> (building its
kernels there) and runs the 271M training config (vocab 32000, d_model
2048, 4 layers, 16 heads, d_head 128, d_ff 5632, bf16, seeded random
weights) on one seeded batch of B=1 x T=16384, SGD(1e-4), with the ranks
of a mesh sharing card 0: over 4 sequence ranks (sp4) and over 2 tensor x
2 sequence ranks (tp2·sp2). A checkout with `shard_model` places the
model once and steps the placed model; an older one steps the plain model
with the mesh keywords. For each: one warm-up step, then the median of 3
steps' wall time (the card synchronized after each), tokens/s and the
peak of allocated memory. Unpack the parent commit beside the change
(`git archive <commit> | tar -x -C <dir>`) and run parent, change,
change, parent. Needs a CUDA device.
"""

import math
import statistics
import subprocess
import sys
import time

FORMS = (("sp4", (4,), ("sp",), dict(seq_axis="sp")),
         ("tp2·sp2", (2, 2), ("tp", "sp"),
          dict(seq_axis="sp", head_axis="tp")))
T, STEPS = 16384, 3


def main(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cfg = tfm.TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=4, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=5632, max_seq=T,
        dtype=torch.bfloat16)
    for label, shape, axes, kw in FORMS:
        gen = torch.Generator(device=dev).manual_seed(0)
        model = tfm.Transformer(cfg, generator=gen)
        tokens = torch.randint(0, cfg.vocab_size, (1, T), generator=gen,
                               device=dev, dtype=torch.int32)
        mesh = make_mesh(shape, axes, [dev] * math.prod(shape))
        if hasattr(tfm, "shard_model"):
            model = tfm.shard_model(model, mesh, **kw)
            step = tfm.make_train_step(
                model, torch.optim.SGD(model.parameters(), lr=1e-4))
        else:
            step = tfm.make_train_step(
                model, torch.optim.SGD(model.parameters(), lr=1e-4),
                mesh=mesh, **kw)
        step(tokens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            step(tokens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"{root} {label}: step {ms:.3f} ms (median of {STEPS}: "
              f"{', '.join(f'{x:.3f}' for x in times)}), "
              f"{T / ms * 1e3:.1f} tokens/s, peak {peak:.2f} GiB ({card})",
              flush=True)
        del model, step, mesh
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1])
