"""Run-to-run spread of a train step's gradients on the card.

    python -m cuda_flashattention_torch.utils.grad_spread [--runs 5]

Runs the same forward and backward of the 271M training config (bench.py
sec_train, as chip_smoke.py trains it) at B=4 x 2048 again and again on
card 0: `loss_fn` without a mesh, and the pipelined step
(`pipeline_forward` over 2 stages sharing the card, 4 microbatches,
`multiprocess_paths.pipe_loss`). For each run after the first it prints
the worst relative L2 difference of a parameter's gradient from the first
run's (with its parameter) and the median over the parameters; then the
pipelined step against `loss_fn`. K4 adds dQ by TMA reduces in any order,
so the bf16 gradients differ from run to run: this is the floor under any
gate that compares two runs of a step.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from cuda_flashattention_torch.models import transformer as tfm
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.utils import multiprocess_paths as mp

BATCH, SEQ, MICRO = 4, 2048, 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_spread: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    kw, dtype = mp.MODELS["271m"]
    cfg = tfm.TransformerConfig(dtype=mp.DTYPES[dtype], **kw)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tfm.Transformer(cfg, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    mesh = make_mesh((2,), ("pp",), [dev] * 2)

    def grads(loss):
        model.zero_grad(set_to_none=True)
        loss().backward()
        torch.cuda.synchronize()
        return {n: p.grad.float().clone()
                for n, p in model.named_parameters()}

    def worst(got, want):
        e = {n: ((got[n] - want[n]).norm() / want[n].norm()).item()
             for n in got}
        name = max(e, key=e.get)
        return (f"worst {e[name]:.3e} ({name}), median "
                f"{sorted(e.values())[len(e) // 2]:.3e}")

    steps = {"loss_fn": lambda: tfm.loss_fn(model, tokens),
             "pipelined": lambda: mp.pipe_loss(model, tokens, mesh, MICRO)}
    first = {}
    for name, loss in steps.items():
        first[name] = grads(loss)
        for i in range(1, args.runs):
            print(f"{name} run {i} against run 0: "
                  f"{worst(grads(loss), first[name])}", flush=True)
    print(f"pipelined against loss_fn: "
          f"{worst(first['pipelined'], first['loss_fn'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
