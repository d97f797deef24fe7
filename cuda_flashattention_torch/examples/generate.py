"""Ladder stage 05: end-to-end serving, a prefill and then one decode step
per token, over a cache in the model's dtype and over an int8 cache.

    python -m cuda_flashattention_torch.examples.generate [--cpu]

Counterpart of examples/05_generate.py: the ladder's fp32 model (vocab
128, d_model 64, 2 layers, 4 query heads over 2 KV heads, d_head 16, d_ff
128, max_seq 64) with weights from a seeded `torch.Generator`, a [2, 8]
prompt from the same generator, 8 new tokens, greedy. The reference is
the teacher-forced rollout: `forward` on the growing sequence, one token
at a time. `generate` over a cache in the model's dtype must reproduce it
token for token, and `generate(qtype="int8")` must give valid tokens that
agree with it on at least half the steps. The JAX stage labels the first
rollout "bf16"; its cache, like this one, holds the model's dtype, fp32.

On the card `forward` and the prefill run the forward kernel K1 on heads
zero-padded from 16 to 64 (`ops.common.pad_heads`), and each decode step
the decode kernel K6's fp32 build at d = 16, over the fp32 cache or the
int8 one. When the cached rollout departs from the reference, the stage
prints both paths' logits at the first step where they differ.
`--ranks` and `--one-card` are taken for the ladder's sake and unused:
the stage runs on card 0.
"""

from __future__ import annotations

import sys
from typing import Dict

import torch

from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.models.generate import generate
from cuda_flashattention_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    decode_one,
    forward,
    init_caches,
    prefill,
)

CFG = TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, max_seq=64, dtype=torch.float32)
BATCH, PROMPT, NEW, SEED = 2, 8, 8, 0


def model_and_prompt(device) -> tuple:
    """The stage's model and [BATCH, PROMPT] int32 prompt, both drawn
    from one generator seeded with SEED on `device`."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = Transformer(CFG, generator=gen)
    prompt = torch.randint(0, CFG.vocab_size, (BATCH, PROMPT),
                           generator=gen, device=device, dtype=torch.int32)
    return model, prompt


@torch.no_grad()
def rollouts(model: Transformer, prompt: torch.Tensor,
             n_new: int = NEW) -> Dict[str, torch.Tensor]:
    """The stage's three rollouts: "ref" [B, T+N] and "ref_logits" [N, B,
    V], the teacher-forced tokens and the logits that chose each; "out"
    and "logits", `generate`'s tokens over a cache in the model's dtype
    and its last step's logits; "out8" and "logits8", the same over an
    int8 cache."""
    ref, steps = prompt, []
    for _ in range(n_new):
        logits = forward(model, ref)[:, -1]
        steps.append(logits)
        nxt = torch.argmax(logits, dim=-1).to(ref.dtype)
        ref = torch.cat([ref, nxt[:, None]], dim=1)
    out, last = generate(model, prompt, n_new)
    out8, last8 = generate(model, prompt, n_new, qtype="int8")
    return dict(ref=ref, ref_logits=torch.stack(steps), out=out,
                logits=last, out8=out8, logits8=last8)


@torch.no_grad()
def cached_logits(model: Transformer, tokens: torch.Tensor,
                  step: int) -> torch.Tensor:
    """The logits [B, V] the cached path chooses new token `step` from,
    fed `tokens` (prefill of the prompt, then decode steps)."""
    caches = init_caches(model.cfg, tokens.shape[0], tokens.shape[1],
                         device=model.device)
    logits, caches = prefill(model, tokens[:, :PROMPT], caches)
    for i in range(step):
        logits, caches = decode_one(model, tokens[:, PROMPT + i],
                                    PROMPT + i, caches)
    return logits


def main(argv=None) -> int:
    args = _ladder.parse(__doc__, argv)
    dev = _ladder.devices(1, args.cpu)[0]
    model, prompt = model_and_prompt(dev)
    r = rollouts(model, prompt)
    ref = r["ref"]
    exact = bool(torch.equal(r["out"], ref))
    print(f"fp32 cached rollout exact-match: {exact}", flush=True)
    if not exact:
        step = int((r["out"][:, PROMPT:] != ref[:, PROMPT:]).any(0)
                   .nonzero()[0])
        got = cached_logits(model, r["out"], step)
        print(f"first departure at new token {step}: teacher-forced "
              f"logits {r['ref_logits'][step].tolist()}\ncached logits "
              f"{got.tolist()}", flush=True)
    out8 = r["out8"]
    agree = (out8[:, PROMPT:] == ref[:, PROMPT:]).float().mean().item()
    valid = bool(((out8 >= 0) & (out8 < CFG.vocab_size)).all())
    print(f"int8-cache rollout: valid={valid}, token agreement "
          f"{agree:.0%}", flush=True)
    return _ladder.report("05_generate", exact and valid and agree >= 0.5)


if __name__ == "__main__":
    sys.exit(main())
