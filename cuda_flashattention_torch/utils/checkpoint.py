"""Checkpoint save and restore for parameters, optimizer state and KV
caches (counterpart of cuda_flashattention_tpu/utils/checkpoint.py).

A tree is nested dicts, lists and tuples whose leaves are tensors or
plain values (numbers, strings, None): a model's `state_dict()`, an
optimizer's `state_dict()`, tuples of `KVCache` fields. `save` writes its
leaves in flattened order with `torch.save`; `restore` reads them with
`torch.load(weights_only=True)` into the structure of `like`, each tensor
on `like`'s device with `like`'s dtype (the counterpart of Orbax
restoring onto the target arrays' shardings):

    from cuda_flashattention_torch.utils import checkpoint as ckpt
    path = ckpt.save("/tmp/run1/step100", {"model": model.state_dict(),
                                           "opt": opt.state_dict()})
    state = ckpt.restore(path, like={"model": model.state_dict(),
                                     "opt": opt.state_dict()})
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["opt"])

A `ShardedTransformer` restores leaf by leaf onto its ranks: its own
`state_dict()` as `like` puts every slice and copy on its rank's device. A
checkpoint of the whole model goes `gather_model` → `restore` →
`shard_model`.
"""

from __future__ import annotations

import os
from typing import Any, List

import torch


def _keys(d: dict) -> list:
    """A dict's keys in a fixed order, whatever order they were set in (as
    a JAX pytree flattens a dict)."""
    return sorted(d, key=lambda k: (type(k).__name__, k))


def _flatten(tree: Any, out: List[Any]) -> None:
    if isinstance(tree, dict):
        for k in _keys(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _flatten(x, out)
    else:
        out.append(tree)


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in _keys(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def save(path: str, tree: Any, force: bool = True) -> str:
    """Write the tree's leaves to `path` (tensors as detached CPU copies)
    and return its absolute path. With `force=False` an existing path is
    left as it is and FileExistsError raised."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    leaves: List[Any] = []
    _flatten(tree, leaves)
    leaves = [x.detach().cpu() if isinstance(x, torch.Tensor) else x
              for x in leaves]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"leaves": leaves}, path)
    return path


def restore(path: str, like: Any) -> Any:
    """The tree saved at `path` in the structure of `like`: each tensor
    leaf on the device and in the dtype of `like`'s leaf at its place, each
    plain leaf as saved. ValueError, naming the leaf, when `like` has
    another number of leaves, a tensor where the checkpoint holds none (or
    the reverse), or another shape."""
    path = os.path.abspath(path)
    saved = torch.load(path, map_location="cpu", weights_only=True)["leaves"]
    flat: List[Any] = []
    _flatten(like, flat)
    if len(flat) != len(saved):
        raise ValueError(
            f"checkpoint {path} holds {len(saved)} leaves but `like` has "
            f"{len(flat)} leaves: structure mismatch (leaves are keyed by "
            f"their flattened position)")
    out = []
    for i, (x, s) in enumerate(zip(flat, saved)):
        if isinstance(x, torch.Tensor) != isinstance(s, torch.Tensor):
            raise ValueError(
                f"checkpoint leaf {i}: saved {type(s).__name__}, target "
                f"{type(x).__name__}: `like` does not match the saved tree")
        if isinstance(x, torch.Tensor):
            if tuple(s.shape) != tuple(x.shape):
                raise ValueError(
                    f"checkpoint leaf {i}: saved shape {tuple(s.shape)} != "
                    f"target shape {tuple(x.shape)}: `like` does not match "
                    f"the saved tree")
            s = s.to(device=x.device, dtype=x.dtype)
        out.append(s)
    return _unflatten(like, iter(out))
