"""Carry parameters between the JAX package's layout and the port's
module.

`params_from_jax` takes the nested dict that
cuda_flashattention_tpu.models.transformer.init_params returns, with its
leaves as numpy arrays (so this module needs no JAX), and fills a
`Transformer` with them; `params_to_jax` is its inverse, for parameters
or their gradients. JAX keeps dense weights as [in, out] for `x @ W`;
`nn.Linear.weight` is [out, in], so each is transposed. The embedding is
tied and keeps its [vocab, d_model] layout.

`kv_cache_from_numpy` and `paged_cache_from_numpy` build the port's
caches from the numpy arrays of a JAX `KVCache` / `PagedKVCache`, so that
a test can start both sides from one state.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from cuda_flashattention_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from cuda_flashattention_torch.ops.kv_cache import KVCache
from cuda_flashattention_torch.ops.paged import PagedKVCache

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


def params_to_jax(model: Transformer, grads: bool = False) -> Dict[str, Any]:
    """The model's parameters, or with `grads=True` their `.grad`, as the
    JAX package's nested dict with fp32 numpy leaves (linear weights
    transposed back to [in, out])."""

    def get(p: torch.Tensor, transpose: bool = False) -> np.ndarray:
        t = p.grad if grads else p
        if t is None:
            raise ValueError("a parameter has no gradient")
        t = t.detach().float().cpu()
        return (t.T if transpose else t).contiguous().numpy()

    layers = []
    for blk in model.layers:
        layer = dict(attn_norm=get(blk.attn_norm),
                     mlp_norm=get(blk.mlp_norm))
        for name in _LINEARS:
            layer[name] = get(getattr(blk, name).weight, transpose=True)
        layers.append(layer)
    return dict(embed=get(model.embed), final_norm=get(model.final_norm),
                layers=layers)


def _values(x: np.ndarray, dtype: Optional[torch.dtype], device):
    """Cache values from numpy: uint8 arrays are the raw codes of fp8 e4m3
    (numpy has no such type), int8 arrays are int8 codes, and floating
    arrays are cast to `dtype` (kept as they are when it is None)."""
    t = torch.from_numpy(np.array(x))  # a copy: the cache is written to
    if t.dtype == torch.uint8:
        t = t.view(torch.float8_e4m3fn)
    elif t.dtype != torch.int8 and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _scales(x: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy()).to(device)


def kv_cache_from_numpy(k: np.ndarray, v: np.ndarray,
                        k_scale: Optional[np.ndarray] = None,
                        v_scale: Optional[np.ndarray] = None,
                        length: int = 0,
                        dtype: Optional[torch.dtype] = None,
                        device="cpu") -> KVCache:
    """A `KVCache` holding the arrays of a JAX one: k/v [B,Hkv,max_len,d]
    (see `_values` for the storage types), scales [B,Hkv,max_len] or None,
    and the live length."""
    return KVCache(_values(k, dtype, device), _values(v, dtype, device),
                   _scales(k_scale, device), _scales(v_scale, device),
                   int(length))


def paged_cache_from_numpy(k_pages: np.ndarray, v_pages: np.ndarray,
                           k_scale: Optional[np.ndarray],
                           v_scale: Optional[np.ndarray],
                           page_table: np.ndarray, lengths: np.ndarray,
                           dtype: Optional[torch.dtype] = None,
                           device="cpu") -> PagedKVCache:
    """A `PagedKVCache` holding the arrays of a JAX one: pools
    [n_pages,Hkv,page,d], scale pools [n_pages,Hkv,page] or None, the
    page table [B,max_pages] and the lengths [B]."""
    def ints(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int32).copy()).to(
            device)

    return PagedKVCache(_values(k_pages, dtype, device),
                        _values(v_pages, dtype, device),
                        _scales(k_scale, device), _scales(v_scale, device),
                        ints(page_table), ints(lengths))
