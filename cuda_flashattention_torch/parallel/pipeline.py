"""Pipeline parallelism: GPipe-style microbatched layer pipelining.

Counterpart of cuda_flashattention_tpu/parallel/pipeline.py:

  * stages live on a `pp` mesh axis; stage s holds layers
    [s·L/S, (s+1)·L/S) of a pytree of tensors stacked on a leading layer
    axis,
  * the GPipe schedule runs T = M + S − 1 ticks; at tick t stage s is
    live for s ≤ t ≤ M − 1 + s and applies its layers to microbatch
    t − s, whose result travels one hop down the axis (`Mesh.send`, on the
    receiver's copy stream, while the other stages compute),
  * bubbles launch nothing: the stage index is a host value here, so a
    stage that has no microbatch at a tick is simply not run,
  * the backward is plain autograd: slicing the stacked parameters, the
    copies between stages and `stage_fn` are all differentiable, and
    reverse mode runs the reverse schedule on the same streams.

`gpipe_spmd` pipelines ANY stage_fn(stage_params, x) -> x with the same
activation shape in and out (a transformer block stack qualifies).

On a mesh that spans processes each process places the layers and
microbatches of its own stages, walks every stage's ticks in the same
order as the others (a hop to or from another process is a `Mesh.send`
pair), and gathers the last stages' outputs (`Mesh.share`). There the
pipeline is a forward only: autograd does not cross a hop between
processes, so a call that would need a gradient raises.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from cuda_flashattention_torch.parallel.mesh import Mesh


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply fn to the tensor leaves of nested dicts, lists and tuples
    (the pytrees of this package)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, tree)
    return leaves


def stack_stage_params(layer_params: list) -> Any:
    """Stack a list of per-layer pytrees into one pytree with a leading
    layer axis. Stacking is differentiable: gradients reach the layers'
    own tensors."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), layer_params[0],
                    *layer_params[1:])


class StageParams(list):
    """The per-stage parameter pytrees `stage_param_sharding` returns (a
    list that `gpipe_spmd` can tell from a stacked pytree)."""


def stage_param_sharding(stacked: Any, mesh: Mesh,
                         axis: str = "pp") -> StageParams:
    """The stages' parameters: for each rank of `axis`, the pytree of its
    layer slice [s·L/S, (s+1)·L/S), placed on that rank's device (None
    for a rank of another process)."""
    ranks = mesh.axis_ranks(axis)
    n_layers = tree_leaves(stacked)[0].shape[0]
    if n_layers % len(ranks):
        raise ValueError(f"{n_layers} layers do not divide over "
                         f"{len(ranks)} stages")
    per = n_layers // len(ranks)
    return StageParams(
        tree_map(lambda w: w[s * per:(s + 1) * per].to(mesh.device(r)),
                 stacked) if mesh.is_local(r) else None
        for s, r in enumerate(ranks))


def gpipe_spmd(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    mesh: Mesh,
    n_micro: int,
    axis_name: str = "pp",
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """Run `stage_fn` as a GPipe pipeline over `axis_name`.

    stage_fn(local_layers, x) applies ONE STAGE's layer stack (leading
    axis = layers per stage) to activations x [mb, ...]. `stacked_params`
    is the whole stack (it is cut per stage here) or the list
    `stage_param_sharding` returns. `x` is the batch [B, ...]; with a
    `batch_axis` it is cut over that axis first and each shard runs its
    own pipeline, whose local batch must divide by `n_micro`. Returns the
    last stage's outputs [B, ...] on x's device. Differentiable in one
    process; across processes a forward only, where a stage's output has
    its input's shape and dtype."""
    n_stages = mesh.shape[axis_name]
    ticks = n_micro + n_stages - 1
    nb = mesh.shape[batch_axis] if batch_axis else 1
    if x.shape[0] % nb:
        raise ValueError(f"batch {x.shape[0]} does not divide over the "
                         f"{nb} ranks of {batch_axis!r}")
    local_b = x.shape[0] // nb
    if local_b % n_micro:
        raise ValueError(f"local batch {local_b} % microbatches "
                         f"{n_micro} != 0")
    pipes = [mesh.axis_ranks(axis_name, **({batch_axis: bi}
                                           if batch_axis else {}))
             for bi in range(nb)]
    presharded = isinstance(stacked_params, StageParams)
    if presharded and len(stacked_params) != n_stages:
        raise ValueError(f"{len(stacked_params)} stage parameter sets for "
                         f"{n_stages} stages")
    if mesh.spans_processes and torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *tree_leaves(stacked_params)]
            if t is not None):
        raise NotImplementedError(
            "gpipe_spmd across processes is a forward only (autograd does "
            "not cross a hop between processes): call it under "
            "torch.no_grad(), or on a mesh of one process")
    outs = [[None] * n_micro for _ in pipes]
    with mesh.region([r for p in pipes for r in p], x.device):
        if not presharded:
            n_layers = tree_leaves(stacked_params)[0].shape[0]
            if n_layers % n_stages:
                raise ValueError(f"{n_layers} layers do not divide over "
                                 f"{n_stages} stages")
            per = n_layers // n_stages
        params = []  # per pipe, per stage: the stage's layers on its device
        for ranks in pipes:
            stages = []
            for s, r in enumerate(ranks):
                if not mesh.is_local(r):
                    stages.append(None)
                    continue
                with mesh.on(r):
                    stages.append(tree_map(
                        lambda w: (w if presharded
                                   else w[s * per:(s + 1) * per]
                                   ).to(mesh.device(r)),
                        stacked_params[s] if presharded else stacked_params))
            params.append(stages)
        micro = [x[bi * local_b:(bi + 1) * local_b].chunk(n_micro, dim=0)
                 for bi in range(nb)]
        arriving = {}  # (pipe, stage, microbatch) → Transfer
        for t in range(ticks):
            for p, ranks in enumerate(pipes):
                for s, r in enumerate(ranks):
                    m = t - s
                    if not 0 <= m < n_micro:
                        continue  # a bubble: nothing to run
                    y = None
                    if mesh.is_local(r):
                        with mesh.on(r):
                            if s == 0:
                                # stage 0 injects microbatch m
                                x_in = micro[p][m].to(mesh.device(r))
                            else:
                                x_in = arriving.pop((p, s, m)).wait()
                            y = stage_fn(params[p][s], x_in)
                    if s < n_stages - 1:
                        arriving[(p, s + 1, m)] = mesh.send(
                            y, r, ranks[s + 1], like=micro[p][m])
                    else:
                        # microbatch m leaves the LAST stage at tick
                        # m + S − 1
                        outs[p][m] = y
    return torch.cat([mesh.share(None if y is None else y.to(x.device),
                                 ranks[-1], like=micro[p][m])
                      for p, ranks in enumerate(pipes)
                      for m, y in enumerate(outs[p])], dim=0)
