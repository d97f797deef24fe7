"""Load the JAX package's parameters into the port's module.

`params_from_jax` takes the nested dict that
cuda_flashattention_tpu.models.transformer.init_params returns, with its
leaves as numpy arrays (so this module needs no JAX), and fills a
`Transformer` with them. JAX keeps dense weights as [in, out] for
`x @ W`; `nn.Linear.weight` is [out, in], so each is transposed. The
embedding is tied and keeps its [vocab, d_model] layout.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from cuda_flashattention_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)

_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def params_from_jax(params: Mapping[str, Any],
                    cfg: TransformerConfig) -> Transformer:
    """A `Transformer` on the CPU holding `params` (numpy leaves); move it
    with `.to(device)`."""
    model = Transformer(cfg, generator=torch.Generator())

    def put(dst: torch.Tensor, src, transpose: bool = False) -> None:
        t = torch.tensor(np.asarray(src, dtype=np.float32))
        if transpose:
            t = t.T
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
        dst.copy_(t)

    with torch.no_grad():
        put(model.embed, params["embed"])
        put(model.final_norm, params["final_norm"])
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers, config has "
                             f"{cfg.n_layers}")
        for blk, layer in zip(model.layers, params["layers"]):
            put(blk.attn_norm, layer["attn_norm"])
            put(blk.mlp_norm, layer["mlp_norm"])
            for name in _LINEARS:
                put(getattr(blk, name).weight, layer[name], transpose=True)
    return model
