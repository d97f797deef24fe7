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
pipeline is one `torch.autograd.Function` per process (`_GPipeAcross`):
its forward keeps each local stage's graph (its input, detached, and its
output), and its backward walks the schedule in reverse, tick by tick in
the same order in every process, each local stage taking its output's
gradient (from the loss for the last stage, else from the next stage
through `Mesh.send`), running `torch.autograd.grad` on its graph and
posting its input's gradient to the previous stage. The explicit order
pairs every message: two microbatches' gradients have the same shape, so
an order that differed between processes would swap them. Gradients
follow JAX's replicated output: a tensor every process holds whole (x, a
whole stack that is cut here) gets its whole gradient in every process,
a `StageParams` entry the sum over the pipes that ran its stage, and the
output's gradient counts once (every process computes the same loss).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from cuda_flashattention_torch.parallel.mesh import Mesh, process_index


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
    """The stages' parameters: for each stage s of `axis`, the pytree of
    its layer slice [s·L/S, (s+1)·L/S), placed on the device of the first
    rank of stage s that this process runs (the rank at s with the other
    axes at 0, in one process), or None where this process runs no rank
    of stage s. A pipeline over another axis of the mesh (a data-parallel
    `batch_axis`) uses that copy for its own rank of stage s."""
    ranks = mesh.axis_ranks(axis)
    n_layers = tree_leaves(stacked)[0].shape[0]
    if n_layers % len(ranks):
        raise ValueError(f"{n_layers} layers do not divide over "
                         f"{len(ranks)} stages")
    per = n_layers // len(ranks)
    out = StageParams()
    for s in range(len(ranks)):
        mine = [r for r in range(mesh.size)
                if mesh.coords(r)[axis] == s and mesh.is_local(r)]
        out.append(tree_map(
            lambda w: w[s * per:(s + 1) * per].to(mesh.device(mine[0])),
            stacked) if mine else None)
    return out


def _replace_leaves(tree: Any, leaves) -> Any:
    """`tree` with its tensor leaves taken in order from `leaves` (a None
    leaf stays None)."""
    it = iter(leaves)
    return tree_map(lambda t: None if t is None else next(it), tree)


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
    last stage's outputs [B, ...] on x's device. Differentiable: in one
    process by plain autograd, across processes by `_GPipeAcross` (module
    docstring), where a stage's output has its input's shape and dtype."""
    plan = _Plan(mesh, axis_name, batch_axis, n_micro, x.shape[0])
    presharded = isinstance(stacked_params, StageParams)
    if presharded and len(stacked_params) != plan.n_stages:
        raise ValueError(f"{len(stacked_params)} stage parameter sets for "
                         f"{plan.n_stages} stages")
    if not presharded:
        n_layers = tree_leaves(stacked_params)[0].shape[0]
        if n_layers % plan.n_stages:
            raise ValueError(f"{n_layers} layers do not divide over "
                             f"{plan.n_stages} stages")
    if mesh.spans_processes:
        leaves = [t for t in tree_leaves(stacked_params) if t is not None]
        return _GPipeAcross.apply(plan, stage_fn, stacked_params, x,
                                  *leaves)
    with mesh.region(plan.all_ranks, x.device):
        params = _place(plan, stacked_params)
        outs = _forward(plan, stage_fn, params, plan.micro(x), None)
    return _gather(plan, outs, plan.micro(x), x.device)


class _Plan:
    """The pipes (one per `batch_axis` rank: its ranks along the stage
    axis) and the schedule's sizes."""

    def __init__(self, mesh: Mesh, axis_name: str,
                 batch_axis: Optional[str], n_micro: int, batch: int):
        self.mesh, self.axis, self.n_micro = mesh, axis_name, n_micro
        self.n_stages = mesh.shape[axis_name]
        self.ticks = n_micro + self.n_stages - 1
        self.nb = mesh.shape[batch_axis] if batch_axis else 1
        if batch % self.nb:
            raise ValueError(f"batch {batch} does not divide over the "
                             f"{self.nb} ranks of {batch_axis!r}")
        self.local_b = batch // self.nb
        if self.local_b % n_micro:
            raise ValueError(f"local batch {self.local_b} % microbatches "
                             f"{n_micro} != 0")
        self.pipes = [mesh.axis_ranks(axis_name, **({batch_axis: bi}
                                                    if batch_axis else {}))
                      for bi in range(self.nb)]
        self.all_ranks = [r for p in self.pipes for r in p]

    def micro(self, x: torch.Tensor) -> List[tuple]:
        """x cut per pipe into its microbatches."""
        b = self.local_b
        return [x[bi * b:(bi + 1) * b].chunk(self.n_micro, dim=0)
                for bi in range(self.nb)]

    def live(self, t: int):
        """(pipe, stage, rank, microbatch) of every stage that runs at
        tick t, in the order every process walks them."""
        for p, ranks in enumerate(self.pipes):
            for s, r in enumerate(ranks):
                if 0 <= t - s < self.n_micro:
                    yield p, s, r, t - s


def _place(plan: _Plan, stacked_params: Any, detach: bool = False):
    """Per pipe, per stage: the stage's layers on its rank's device (None
    for a rank of another process); `detach`: as new leaves that require
    grad where the given tensor does (one per pipe and stage, so that
    each has its own gradient)."""
    mesh = plan.mesh
    presharded = isinstance(stacked_params, StageParams)
    per = (None if presharded else
           tree_leaves(stacked_params)[0].shape[0] // plan.n_stages)

    def cut(w, s, r):
        part = (w if presharded else w[s * per:(s + 1) * per]).to(
            mesh.device(r))
        return part.detach().requires_grad_(w.requires_grad) if detach \
            else part

    params = []
    for ranks in plan.pipes:
        stages = []
        for s, r in enumerate(ranks):
            if not mesh.is_local(r):
                stages.append(None)
                continue
            src = stacked_params[s] if presharded else stacked_params
            if src is None:
                raise ValueError(f"stage {s}'s parameters are not in this "
                                 f"process, which runs rank {r} of it")
            with mesh.on(r):
                stages.append(tree_map(lambda w: cut(w, s, r), src))
        params.append(stages)
    return params


def _forward(plan: _Plan, stage_fn: Callable, params, micro, keep):
    """The GPipe schedule: T = M + S − 1 ticks; at tick t stage s runs
    microbatch t − s, whose result hops to stage s + 1. Returns the last
    stages' outputs per pipe and microbatch (None for another process's),
    and, where `keep` is a dict, fills it with each local stage's graph
    {(pipe, stage, microbatch): (its input, detached, and its output)}:
    every stage's input is then a leaf, and the outputs that hop are
    detached."""
    mesh = plan.mesh
    outs = [[None] * plan.n_micro for _ in plan.pipes]
    arriving = {}  # (pipe, stage, microbatch) → Transfer
    for t in range(plan.ticks):
        for p, s, r, m in plan.live(t):
            ranks = plan.pipes[p]
            y = None
            if mesh.is_local(r):
                with mesh.on(r):
                    if s == 0:
                        # stage 0 injects microbatch m
                        x_in = micro[p][m].to(mesh.device(r))
                    else:
                        x_in = arriving.pop((p, s, m)).wait()
                    if keep is None:
                        y = stage_fn(params[p][s], x_in)
                    else:
                        x_in = x_in.detach().requires_grad_()
                        with torch.enable_grad():
                            y = stage_fn(params[p][s], x_in)
                        keep[(p, s, m)] = (x_in, y)
                        y = y.detach()
            if s < plan.n_stages - 1:
                arriving[(p, s + 1, m)] = mesh.send(
                    y, r, ranks[s + 1], like=micro[p][m])
            else:
                # microbatch m leaves the LAST stage at tick m + S − 1
                outs[p][m] = y
    return outs


def _gather(plan: _Plan, outs, micro, device) -> torch.Tensor:
    """The last stages' outputs [B, ...] on `device` in every process."""
    return torch.cat([plan.mesh.share(None if y is None else y.to(device),
                                      ranks[-1], like=micro[p][m])
                      for p, ranks in enumerate(plan.pipes)
                      for m, y in enumerate(outs[p])], dim=0)


class _GPipeAcross(torch.autograd.Function):
    """forward(ctx, plan, stage_fn, stacked_params, x, *leaves): the GPipe
    pipeline on a mesh that spans processes, `leaves` being the tensor
    leaves of `stacked_params` this process holds (all of a whole stack;
    this process's entries of a `StageParams`). Its backward is the
    reverse schedule (module docstring)."""

    @staticmethod
    def forward(ctx, plan, stage_fn, stacked_params, x, *leaves):
        mesh = plan.mesh
        tree = _replace_leaves(stacked_params, leaves)
        keep = {} if any(ctx.needs_input_grad) else None
        micro = plan.micro(x)
        with mesh.region(plan.all_ranks, x.device):
            params = _place(plan, tree, detach=keep is not None)
            outs = _forward(plan, stage_fn, params, micro, keep)
        out = _gather(plan, outs, micro, x.device)
        if keep is not None:
            ctx.plan, ctx.tree, ctx.params, ctx.graphs = (plan, tree, params,
                                                          keep)
            ctx.likes = [[(c.shape, c.dtype) for c in per] for per in micro]
            ctx.x_meta = (x.shape, x.dtype, x.device)
        return out

    @staticmethod
    def backward(ctx, g):
        plan, mesh = ctx.plan, ctx.plan.mesh
        g_micro = plan.micro(g)
        # per (pipe, stage): the local stage's leaves' gradients, summed
        # over its microbatches in the order of the reverse schedule
        stage_grads = {}
        x_grads = {}  # (pipe, microbatch) → stage 0's input gradient
        arriving = {}
        with mesh.region(plan.all_ranks, g.device) as reg:
            for t in reversed(range(plan.ticks)):
                for p, s, r, m in plan.live(t):
                    ranks = plan.pipes[p]
                    gx = None
                    if mesh.is_local(r):
                        with mesh.on(r):
                            gy = (g_micro[p][m].to(mesh.device(r))
                                  if s == plan.n_stages - 1
                                  else arriving.pop((p, s, m)).wait())
                            x_in, y = ctx.graphs.pop((p, s, m))
                            leaves = [w for w in tree_leaves(ctx.params[p][s])
                                      if w.requires_grad]
                            got = torch.autograd.grad(
                                y, [x_in, *leaves], gy, allow_unused=True)
                            gx = got[0]
                            got = [torch.zeros_like(w) if gw is None else gw
                                   for w, gw in zip(leaves, got[1:])]
                            acc = stage_grads.get((p, s))
                            stage_grads[(p, s)] = got if acc is None else [
                                a + b for a, b in zip(acc, got)]
                            reg.keep(gy, gx)
                    if s > 0:
                        arriving[(p, s - 1, m)] = mesh.send(
                            gx, r, ranks[s - 1], like=ctx.likes[p][m])
                    else:
                        x_grads[(p, m)] = gx
        grads = _leaf_grads(ctx, stage_grads, g.device)
        gx = None
        if ctx.needs_input_grad[3]:
            shape, dtype, device = ctx.x_meta
            gx = torch.cat([mesh.share(
                None if x_grads[(p, m)] is None
                else x_grads[(p, m)].to(device), ranks[0],
                like=torch.empty(ctx.likes[p][m][0], dtype=dtype,
                                 device=device))
                for p, ranks in enumerate(plan.pipes)
                for m in range(plan.n_micro)], dim=0)
        return (None, None, None, gx, *grads)


def _leaf_grads(ctx, stage_grads, source) -> list:
    """The gradients of the Function's leaves, each the sum over the pipes
    of its stage's parts (in pipe order). A whole stack: every stage's
    slice, in every process (each part from the process that ran it,
    `Mesh.share`). A `StageParams` entry: in each process that holds it,
    the parts of the other processes coming by `Mesh.send` to its rank of
    the stage (`stage_param_sharding`'s rule), so that the processes that
    do not hold it take no part."""
    plan, mesh, tree = ctx.plan, ctx.plan.mesh, ctx.tree

    def part(p, s, k, like):
        got = stage_grads.get((p, s))
        return None if got is None else got[k].to(like.device, like.dtype)

    if not isinstance(tree, StageParams):
        leaves = [w for w in tree_leaves(tree) if w.requires_grad]
        per = tree_leaves(tree)[0].shape[0] // plan.n_stages
        out = []
        for k, w in enumerate(leaves):
            like = torch.empty((per, *w.shape[1:]), dtype=w.dtype,
                               device=w.device)
            stages = []
            for s in range(plan.n_stages):
                acc = None
                for p, ranks in enumerate(plan.pipes):
                    got = mesh.share(part(p, s, k, like), ranks[s], like)
                    acc = got if acc is None else acc + got
                stages.append(acc)
            out.append(torch.cat(stages, dim=0))
        return _with_nones(tree_leaves(tree), out)

    out = []
    me = process_index()
    with mesh.region(plan.all_ranks, source) as reg:
        for s, entry in enumerate(tree):
            if entry is None:
                continue  # this process runs no rank of stage s
            # each process's holder of the entry: its first rank at s
            holder = {}
            for r in range(mesh.size):
                if mesh.coords(r)[plan.axis] == s:
                    holder.setdefault(mesh.process(r), r)
            leaves = [w for w in tree_leaves(entry) if w.requires_grad]
            for k, like in enumerate(leaves):
                came = {}
                for p, ranks in enumerate(plan.pipes):
                    src = ranks[s]
                    for q, dst in holder.items():
                        if q == mesh.process(src):
                            continue
                        t = mesh.send(stage_grads[(p, s)][k]
                                      if mesh.is_local(src) else None,
                                      src, dst, like=like)
                        if t is not None:
                            came[p] = t
                acc = None
                with mesh.on(holder[me]):
                    for p in range(len(plan.pipes)):
                        got = (came[p].wait() if p in came
                               else part(p, s, k, like))
                        acc = got if acc is None else acc + got
                        reg.keep(got)
                out.append(acc)
    held = [w for e in tree if e is not None for w in tree_leaves(e)]
    return _with_nones(held, out)


def _with_nones(leaves, grads) -> list:
    """`grads` (one per leaf that requires grad, in order) spread over
    `leaves`, None for a leaf that does not."""
    it = iter(grads)
    return [next(it) if w.requires_grad else None for w in leaves]
