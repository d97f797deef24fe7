"""Autoregressive generation: prefill, then one decode step per token.

Counterpart of cuda_flashattention_tpu/models/generate.py. The JAX
version scans the decode steps inside one compiled program; here they are
a Python loop of eager steps. Sampling is greedy at temperature 0, else
`torch.multinomial` drawing from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cuda_flashattention_torch.models.transformer import (
    Transformer,
    decode_one,
    init_caches,
    prefill,
)


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    model: Transformer,
    prompt: torch.Tensor,
    max_new_tokens: int,
    max_len: Optional[int] = None,
    qtype: Optional[str] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    quantize_q: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate continuations. prompt [B, T] int → (tokens [B, T+N] in the
    prompt's dtype, logits [B, V] fp32 of the last decode step, or of the
    prefill when N = 0).

    `qtype` None, "int8", "fp8" or "mixed" selects the cache storage (on
    the model's device); decode reads it through the decode kernel either
    way, and the whole-prompt prefill never reads it back. `quantize_q`
    additionally runs the decode's Q·Kᵀ as an integer dot for int8-K
    caches (per-head int8 Q).

    Each decode step consumes the previous step's sampled token, so the
    output is prompt ++ [first, ...] and the last sampled token is not
    returned, as in the JAX version. `generator` must live on the model's
    device when sampling at temperature > 0."""
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    if max_len < t + max_new_tokens:
        raise ValueError(f"max_len {max_len} < prompt {t} + new "
                         f"{max_new_tokens}")
    caches = init_caches(model.cfg, b, max_len, qtype=qtype,
                         device=model.device)
    logits, caches = prefill(model, prompt, caches)
    token = _sample(logits, temperature, generator).to(prompt.dtype)
    tokens = []
    for i in range(max_new_tokens):
        tokens.append(token)
        logits, caches = decode_one(model, token, t + i, caches,
                                    quantize_q=quantize_q)
        token = _sample(logits, temperature, generator).to(prompt.dtype)
    out = torch.cat([prompt, *[tk[:, None] for tk in tokens]], dim=1)
    return out, logits
