"""The parallel layer across processes, path by path: one process of a
group that scripts/launch_multihost.py starts.

    python -m cuda_flashattention_torch.scripts.launch_multihost -np 2 \
        --devices-per-proc 2 --cpu \
        -m cuda_flashattention_torch.utils.multiprocess_paths \
        --out DIR [--save] [--check] PATH [PATH ...]

Each process joins the group (`examples/_ladder.bootstrap`), makes the
same global inputs from the same seeds (numpy), runs each named path on a
mesh of the global device list, and writes DIR/p<process>.json: its
transport, the seconds it took to join the group (`join_s`), and per
path its host ms, the kernel launches it made, its peak
device memory and the bytes it moved to other processes and the host
seconds it waited on them (`parallel/mesh.transfer_stats`). With
`--save` process 0 writes each path's global outputs to DIR/<path>.npz
(fp32). With `--check` process 0 runs the path again without the other
processes and writes the differences into its json (`errors`: per
output the largest, the reference's largest |value| and the relative L2
norm): the ring, Ulysses, the collectives, GPipe, K9 and the pipelined
step against the same call on a mesh of as many ranks of its own device
(ring decode also against `decode_attention` on the whole cache:
"o@whole"; K9 against (Σ_i x_i) @ W in fp32: "o[...]@ref"), the train
step against the same weights, made anew, without a mesh. But for the
train steps it also times that one-process call (`alone_ms`), on the
mesh the check built and ran once, after every process has finished its
paths and while the others wait idle.

Paths (sizes from the options):
  ring_causal, ring_ragged   `ring_attention` forward and backward over
                             every rank ("sp"); ragged: N − 2 tokens,
                             non-causal (a padded last shard)
  decode                     `ring_decode`, per-sequence lengths
  ulysses                    `ulysses_attention` forward and backward
  collectives                all_reduce / all_gather / reduce_scatter
                             over "dp" of a ("dp", "sp") = (2, ranks / 2)
                             mesh (dp groups span the processes) and the
                             autograd pairs; every rank's result
  gpipe                      `gpipe_spmd` of tanh layers over "pp":
                             the output and the gradients of x and of
                             the whole layer stack
  train                      `make_train_step` of `--model` placed by
                             `shard_model` on `--axes` (e.g. sp=4,
                             dp=2,sp=2, tp=2,sp=2; once per --axes): the
                             first step's loss and gradients, then
                             `--steps` timed steps
  pipe_train                 `--model` trained through `pipeline_forward`
                             on `--pipe-axes` (pp=2, or pp=2,dp=2 with the
                             batch cut over dp; a mesh smaller than the
                             device list takes ranks spread over the
                             processes; ":placed" after the axes passes
                             `stage_param_sharding`'s list), `--micro`
                             microbatches: the first step's loss and the
                             gradients of every parameter (where the
                             stages are placed, each layer's from the
                             process that holds it), then `--steps` timed
                             SGD steps
  k9                         `device_ring_matmul` over every rank
                             ("sp"), at each of `--k9-rows` x `--k9-d` x
                             `--k9-dtypes`: o, the wrapper's ms per call
                             and the plain ring's, the kernel's (CUDA
                             events, on cards across processes), the host
                             seconds before its launch, and whether
                             `--k9-repeats` calls on one workspace equal
                             the first bit for bit
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from cuda_flashattention_torch import config
from cuda_flashattention_torch.examples import _ladder
from cuda_flashattention_torch.parallel import mesh as mesh_mod
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.utils.testing import seeded_random

PATHS = ("ring_causal", "ring_ragged", "decode", "ulysses", "collectives",
         "gpipe", "train", "pipe_train", "k9")
# the tests' small model, and the repo's 271M training config (bench.py
# sec_train), as chip_smoke.py trains it
MODELS = {
    "tiny": (dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_head=16, d_ff=128, max_seq=64), "fp32"),
    "271m": (dict(vocab_size=32000, d_model=2048, n_layers=4, n_heads=16,
                  n_kv_heads=16, d_head=128, d_ff=5632, max_seq=16384),
             "bf16"),
}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
PIPE_LAYERS, PIPE_D, PIPE_B = 8, 16, 8


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="+", choices=PATHS)
    ap.add_argument("--out", required=True, type=Path)
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--dtype", choices=DTYPES, default="fp32")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--decode-batch", type=int, default=None,
                    help="the decode path's batch (default --batch)")
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--model", choices=MODELS, default="tiny")
    ap.add_argument("--weights", type=Path, default=None,
                    help="the model's state dict (torch.save), else made "
                         "from seed 0")
    ap.add_argument("--train-seq", type=int, default=None,
                    help="the train path's tokens per sequence (default "
                         "--seq)")
    ap.add_argument("--axes", action="append", default=None,
                    help="the train path's mesh, e.g. sp=4 or tp=2,sp=2; "
                         "given more than once, the path runs once per "
                         "mesh, as train[<axes>] (default sp=4)")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--pipe-axes", action="append", default=None,
                    help="the pipe_train path's mesh, e.g. pp=2 or "
                         "pp=2,dp=2 (\":placed\" after it: the stages "
                         "placed by stage_param_sharding); given more than "
                         "once, the path runs once per mesh, as "
                         "pipe_train[<axes>] (default pp=2)")
    ap.add_argument("--micro", type=int, default=2,
                    help="the pipe_train path's microbatches")
    ap.add_argument("--pipe-batch", type=int, default=None,
                    help="the pipe_train path's batch (default --batch)")
    ap.add_argument("--pipe-seq", type=int, default=None,
                    help="the pipe_train path's tokens per sequence "
                         "(default --train-seq, else --seq)")
    ap.add_argument("--k9-rows", type=int, nargs="+", default=[64])
    ap.add_argument("--k9-d", type=int, nargs="+", default=[16])
    ap.add_argument("--k9-dtypes", nargs="+", choices=DTYPES,
                    default=["fp32"])
    ap.add_argument("--k9-repeats", type=int, default=2)
    ap.add_argument("--k9-iters", type=int, default=3)
    return ap.parse_args(argv)


def _inputs(shape, seed, dtype, device, grad=False):
    x = torch.from_numpy(seeded_random(shape, seed)).to(device, dtype)
    return x.requires_grad_(grad)


def _launches() -> dict:
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    return dict(fwd=flash_attention_forward.launches,
                forms=dict(flash_attention_forward.form_launches),
                bwd=dict(flash_attention_backward.launches),
                decode=decode_attention.launches,
                k9=device_ring_matmul.launches)


def _zero_launches() -> None:
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul)
    flash_attention_forward.launches = 0
    device_ring_matmul.launches = 0
    for d in (flash_attention_forward.form_launches,
              flash_attention_backward.launches):
        for k in d:
            d[k] = 0
    decode_attention.launches = 0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _errors(got: dict, want: dict) -> dict:
    """{name: (max |got − want|, max |want|, ‖got − want‖ / ‖want‖)}; a
    reference named "o@whole" is another reference for got["o"]."""
    out = {}
    for k, w in want.items():
        w = w.float()
        d = got[k.split("@")[0]].float() - w
        out[k] = (d.abs().max().item(), w.abs().max().item(),
                  (d.norm() / w.norm()).item() if w.norm() > 0 else 0.0)
    return out


# ---------------------------------------------------------------------------
# The paths: each returns (run(mesh) → global outputs, the mesh's shape
# and axis names, None or a callable of further references)
# ---------------------------------------------------------------------------

def _ring(args, devs, home, causal):
    from cuda_flashattention_torch.parallel.ring import ring_attention
    n = args.seq if causal else args.seq - 2
    dt = DTYPES[args.dtype]
    b, h, hkv, d = args.batch, args.heads, args.kv_heads, args.d
    q = _inputs((b, h, n, d), 10, dt, home, True)
    k = _inputs((b, hkv, n, d), 11, dt, home, True)
    v = _inputs((b, hkv, n, d), 12, dt, home, True)
    do = _inputs((b, h, n, d), 13, dt, home)

    def run(mesh):
        o = ring_attention(q, k, v, mesh, causal=causal)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        return dict(o=o, dq=dq, dk=dk, dv=dv)
    return run, (len(devs),), ("sp",), None


def _decode(args, devs, home):
    from cuda_flashattention_torch.ops.decode import decode_attention
    from cuda_flashattention_torch.parallel.ring import ring_decode
    dt = DTYPES[args.dtype]
    b, h, hkv, d, n = (args.decode_batch or args.batch, args.heads,
                       args.kv_heads, args.d, args.seq)
    q = _inputs((b, h, d), 20, dt, home)
    k = _inputs((b, hkv, n, d), 21, dt, home)
    v = _inputs((b, hkv, n, d), 22, dt, home)
    lengths = torch.from_numpy(np.random.default_rng(23).integers(
        1, n + 1, b).astype(np.int32)).to(home)

    def run(mesh):
        o, lse = ring_decode(q, k, v, lengths, mesh)
        return dict(o=o, lse=lse)

    def whole():
        """decode_attention (K6) on the whole cache."""
        o, lse = decode_attention(q, k, v, lengths)
        return {"o@whole": o, "lse@whole": lse}
    return run, (len(devs),), ("sp",), whole


def _ulysses(args, devs, home):
    from cuda_flashattention_torch.parallel.ulysses import ulysses_attention
    dt = DTYPES[args.dtype]
    b, h, hkv, d, n = args.batch, args.heads, args.kv_heads, args.d, args.seq
    q = _inputs((b, h, n, d), 30, dt, home, True)
    k = _inputs((b, hkv, n, d), 31, dt, home, True)
    v = _inputs((b, hkv, n, d), 32, dt, home, True)
    do = _inputs((b, h, n, d), 33, dt, home)

    def run(mesh):
        o = ulysses_attention(q, k, v, mesh, causal=True)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        return dict(o=o, dq=dq, dk=dk, dv=dv)
    return run, (len(devs),), ("sp",), None


def _collectives(args, devs, home):
    from cuda_flashattention_torch.parallel import collectives as coll
    shape = (2, len(devs) // 2)  # 2 x 2 over 2 processes: dp spans them
    rows = 12

    def run(mesh):
        mine = mesh.local(range(mesh.size))
        xs = {r: _inputs((rows, 3), 300 + r, torch.float32, mesh.device(r))
              for r in mine}
        got = {"all_reduce_dp": coll.all_reduce(mesh, "dp", xs),
               "all_reduce_all": coll.all_reduce(mesh, ("dp", "sp"), xs),
               "all_gather_dp": coll.all_gather(mesh, "dp", xs, 0),
               "reduce_scatter_dp": coll.reduce_scatter(mesh, "dp", xs, 0)}
        for name, pair in (("gather_from_axis", coll.gather_from_axis),
                           ("reduce_scatter_to_axis",
                            coll.reduce_scatter_to_axis)):
            leaves = {r: x.clone().requires_grad_() for r, x in xs.items()}
            y = pair(mesh, "dp", leaves, 0)
            loss = sum((y[r] * _inputs(y[r].shape, 400 + r, torch.float32,
                                       y[r].device)).sum() for r in mine)
            loss.backward()
            got[name] = {r: y[r].detach() for r in mine}
            got[name + "_grad"] = {r: leaves[r].grad for r in mine}
        # every rank's result, stacked in rank order, in every process
        return {name: torch.stack([mesh.share(
            per[r].to(home) if r in per else None, r,
            torch.empty(next(iter(per.values())).shape, device=home))
            for r in range(mesh.size)]) for name, per in got.items()}

    return run, shape, ("dp", "sp"), None


def pipe_stage(stage_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The pipeline path's stage: tanh(x @ W) for each of its layers."""
    for i in range(stage_w.shape[0]):
        x = torch.tanh(x @ stage_w[i])
    return x


def _gpipe(args, devs, home):
    from cuda_flashattention_torch.parallel.pipeline import gpipe_spmd
    ws = torch.stack([_inputs((PIPE_D, PIPE_D), 160 + i, torch.float32,
                              home) * 0.5 for i in range(PIPE_LAYERS)])
    x = _inputs((PIPE_B, PIPE_D), 170, torch.float32, home)
    dy = _inputs((PIPE_B, PIPE_D), 171, torch.float32, home)

    def run(mesh):
        w, a = ws.clone().requires_grad_(), x.clone().requires_grad_()
        y = gpipe_spmd(pipe_stage, w, a, mesh, n_micro=4)
        dw, dx = torch.autograd.grad(y, (w, a), dy)
        return dict(y=y.detach(), dw=dw, dx=dx)
    return run, (len(devs),), ("pp",), None


def _spread(devs: list, n: int) -> list:
    """n of the ranks' devices, spread evenly over the list (one rank of
    each process where n is the process count); every process must keep
    one."""
    if len(devs) % n:
        raise ValueError(f"{n} ranks do not spread over {len(devs)}")
    out = devs[::len(devs) // n]
    procs = {d.process for d in devs if isinstance(d, mesh_mod.Place)}
    if procs - {d.process for d in out if isinstance(d, mesh_mod.Place)}:
        raise ValueError(f"a mesh of {n} ranks leaves out some of the "
                         f"{len(procs)} processes")
    return out


def pipe_loss(model, tokens: torch.Tensor, mesh, n_micro: int,
              batch_axis: Optional[str] = None,
              placed: bool = False) -> torch.Tensor:
    """Next-token cross entropy over `pipeline_forward`'s logits (the mean
    over positions [:, :-1], as `loss_fn`), the layers stacked anew (and,
    `placed`, cut by `stage_param_sharding`) so that the gradients reach
    the model's parameters."""
    import torch.nn.functional as F

    from cuda_flashattention_torch.models import transformer as tfm
    from cuda_flashattention_torch.parallel.pipeline import (
        stack_stage_params, stage_param_sharding)
    stacked = stack_stage_params([tfm.layer_weights(b)
                                  for b in model.layers])
    if placed:
        stacked = stage_param_sharding(stacked, mesh)
    logits = tfm.pipeline_forward(model, tokens, mesh, n_micro,
                                  batch_axis=batch_axis, stacked=stacked)
    targets = torch.roll(tokens, -1, dims=1).long()
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           targets[:, :-1].reshape(-1))


def _pipe_train(args, spec, devs, home, info):
    """The pipe_train path on one `--pipe-axes` spec; like `_train`."""
    axes, _, mode = spec.partition(":")
    placed = mode == "placed"
    pairs = [a.split("=") for a in axes.split(",")]
    shape = tuple(int(v) for _, v in pairs)
    names = tuple(a for a, _ in pairs)
    batch_axis = "dp" if "dp" in names else None
    n = int(np.prod(shape))
    model = _model(args, home)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (args.pipe_batch or args.batch,
                                  args.pipe_seq or args.train_seq
                                  or args.seq)).astype(np.int32)).to(home)
    mesh = make_mesh(shape, names, _spread(devs, n))
    info["mesh"] = spec

    def grads(m, mesh):
        """Every parameter's gradient; where the stages are placed across
        processes, each layer's from the process that holds its stage."""
        out = {}
        per = len(m.layers) // mesh.shape["pp"]
        for name, p in m.named_parameters():
            g = p.grad
            if placed and mesh.spans_processes and name.startswith(
                    "layers."):
                stage = int(name.split(".")[1]) // per
                owner = mesh.rank_of(pp=stage)
                g = mesh.share(g if mesh.is_local(owner) else None, owner,
                               like=p)
            out[f"grad/{name}"] = g
        return out

    loss = pipe_loss(model, tokens, mesh, args.micro, batch_axis, placed)
    loss.backward()
    out = dict(loss=loss.detach(), **grads(model, mesh))
    opt = torch.optim.SGD(model.parameters(), lr=1e-4)
    step_ms, losses = [], []
    _zero_launches()
    for _ in range(args.steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = pipe_loss(model, tokens, mesh, args.micro, batch_axis,
                         placed)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        _sync(home)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    info.update(step_ms=step_ms, losses=losses, launches=_launches())
    del model, opt

    def whole_step():
        """The same pipelined step in this process alone, on as many ranks
        of its own device: loss and gradients."""
        one = make_mesh(shape, names, [home] * n)
        whole = _model(args, home)
        ref = pipe_loss(whole, tokens, one, args.micro, batch_axis, placed)
        ref.backward()
        return dict(loss=ref.detach(), **grads(whole, one))
    return out, whole_step


def _k9(args, devs, home):
    from cuda_flashattention_torch.parallel.device_ring import (
        device_ring_matmul, ring_matmul_plain)
    n = len(devs)
    cases = [(rows, d, dt) for rows in args.k9_rows for d in args.k9_d
             for dt in args.k9_dtypes]
    inputs = {c: (_inputs((n * c[0], c[1]), 900 + i, DTYPES[c[2]], home),
                  _inputs((c[1], c[1]), 950 + i, DTYPES[c[2]], home))
              for i, c in enumerate(cases)}
    timing = {}

    def run(mesh):
        return {f"o[{r},{d},{dt}]": device_ring_matmul(*inputs[(r, d, dt)],
                                                       mesh)
                for r, d, dt in cases}

    def reference():
        """tile((Σ_i x_i) @ W) in fp32, on this process's device."""
        out = {}
        for (r, d, dt), (x, w) in inputs.items():
            o = x.float().view(n, r, d).sum(0) @ w.float()
            out[f"o[{r},{d},{dt}]@ref"] = o.repeat(n, 1)
        return out

    def measure(mesh):
        """Per case: the wrapper's ms per call (host clock, synchronised)
        and the plain ring's, the last call's kernel ms (CUDA events around its launch, on a
        card across processes), the host seconds it waited before its
        launch, and how many of `--k9-repeats` calls equal the first bit
        for bit."""
        for r, d, dt in cases:
            x, w = inputs[(r, d, dt)]
            first = device_ring_matmul(x, w, mesh)
            same = sum(torch.equal(device_ring_matmul(x, w, mesh), first)
                       for _ in range(args.k9_repeats))
            _sync(home)
            t0 = time.perf_counter()
            for _ in range(args.k9_iters):
                device_ring_matmul(x, w, mesh)
            _sync(home)
            ms = (time.perf_counter() - t0) * 1e3 / args.k9_iters
            t0 = time.perf_counter()
            for _ in range(args.k9_iters):
                ring_matmul_plain(x, w, mesh)
            _sync(home)
            row = dict(ms=ms,
                       plain_ms=(time.perf_counter() - t0) * 1e3
                       / args.k9_iters,
                       start_ms=device_ring_matmul.last_start_s * 1e3,
                       same=same, repeats=args.k9_repeats,
                       grid=list(device_ring_matmul.last_grid),
                       scope=device_ring_matmul.last_scope)
            events = device_ring_matmul.last_events
            if events is not None:  # on a card, across processes
                row["kernel_ms"] = events[0].elapsed_time(events[1])
            timing[f"{r},{d},{dt}"] = row

    run.measure, run.timing = measure, timing
    return run, (n,), ("sp",), reference


def _axes(spec: str):
    """"tp=2,sp=2" → ((2, 2), ("tp", "sp"), forward keywords)."""
    pairs = [p.split("=") for p in spec.split(",")]
    names = tuple(a for a, _ in pairs)
    kw = {"sp": "seq_axis", "dp": "batch_axis", "tp": "head_axis"}
    return (tuple(int(n) for _, n in pairs), names,
            {kw[a]: a for a in names})


def _model(args, home):
    """The train path's model: seeded weights, or those of --weights."""
    from cuda_flashattention_torch.models import transformer as tfm
    kw, dtype = MODELS[args.model]
    cfg = tfm.TransformerConfig(dtype=DTYPES[dtype], **kw)
    model = tfm.Transformer(cfg, torch.Generator(device=home).manual_seed(0))
    if args.weights is not None:
        model.load_state_dict(torch.load(args.weights, map_location=home,
                                         weights_only=True))
    return model


def _train(args, axes, devs, home, info):
    from cuda_flashattention_torch.models import transformer as tfm
    model = _model(args, home)
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.train_seq or args.seq)).astype(
            np.int32)).to(home)
    shape, names, fwd_kw = _axes(axes)
    mesh = make_mesh(shape, names, devs)
    placed = tfm.shard_model(model, mesh, **fwd_kw)
    del model
    loss = tfm.loss_fn(placed, tokens)
    loss.backward()
    placed.sync_grads()
    out = dict(loss=loss.detach())
    out.update({f"grad/{n}": p.grad for n, p in
                tfm.gather_model(placed, home).named_parameters()})
    step = tfm.make_train_step(
        placed, torch.optim.SGD(placed.parameters(), lr=1e-4))
    step_ms, losses = [], []
    _zero_launches()
    for _ in range(args.steps):
        t0 = time.perf_counter()
        losses.append(step(tokens).item())
        _sync(home)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    info.update(step_ms=step_ms, losses=losses, launches=_launches())
    del placed, step

    def whole_step():
        """The same weights, made anew, without a mesh: loss and
        gradients."""
        whole = _model(args, home)
        ref = tfm.loss_fn(whole, tokens)
        ref.backward()
        return dict(loss=ref.detach(), **{
            f"grad/{n}": p.grad for n, p in whole.named_parameters()})
    return out, whole_step


def _time_alone(alone, paths: dict, home) -> None:
    """Process 0 times each path's one-process call (`alone_ms`) on its
    mesh, built and run once by the check, once every process has
    finished its paths; the others wait, idle, until it is done."""
    import torch.distributed as dist
    group = mesh_mod.process_count() > 1
    if group:
        dist.barrier()
    for name, run, one in alone:
        t0 = time.perf_counter()
        run(one)
        _sync(home)
        paths[name]["alone_ms"] = (time.perf_counter() - t0) * 1e3
        print(f"[multiprocess_paths] p0 {name}: alone_ms "
              f"{paths[name]['alone_ms']:.3f}", flush=True)
    if group:
        dist.barrier()


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    args = parse(argv)
    cpu = config.CPU.as_bool  # the launcher's --cpu
    t0 = time.perf_counter()
    devs = _ladder.devices(None, cpu)
    home = _ladder.home(devs)
    pid = mesh_mod.process_index()
    args.out.mkdir(parents=True, exist_ok=True)
    report = dict(process=pid, transport=mesh_mod.TRANSPORT,
                  device=str(home), ranks=len(devs),
                  processes=mesh_mod.process_count(),
                  join_s=time.perf_counter() - t0, paths={})
    makers = dict(ring_causal=lambda: _ring(args, devs, home, True),
                  ring_ragged=lambda: _ring(args, devs, home, False),
                  decode=lambda: _decode(args, devs, home),
                  ulysses=lambda: _ulysses(args, devs, home),
                  collectives=lambda: _collectives(args, devs, home),
                  gpipe=lambda: _gpipe(args, devs, home),
                  k9=lambda: _k9(args, devs, home))
    trainers = dict(train=_train, pipe_train=_pipe_train)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    jobs = [(p, None) for p in args.paths if p not in trainers]
    for path, specs in (("train", args.axes or ["sp=4"]),
                        ("pipe_train", args.pipe_axes or ["pp=2"])):
        if path in args.paths:
            jobs += [(path if len(specs) == 1 else f"{path}[{a}]",
                      (path, a)) for a in specs]
    alone = []  # (path, run, its one-process mesh) to time at the end
    try:
        for name, train in jobs:
            info = {}
            stats0 = dict(mesh_mod.transfer_stats)
            if home.type == "cuda":
                torch.cuda.reset_peak_memory_stats(home)
            if train:
                got, again = trainers[train[0]](args, train[1], devs, home,
                                                info)
            else:
                run, shape, names, whole = makers[name]()
                mesh = make_mesh(shape, names, devs)
                run(mesh)  # warm-up: the timed call below makes the counts
                _sync(home)
                _zero_launches()
                stats0 = dict(mesh_mod.transfer_stats)
                t0 = time.perf_counter()
                got = run(mesh)
                _sync(home)
                info["ms"] = (time.perf_counter() - t0) * 1e3
                info["launches"] = _launches()
                if hasattr(run, "measure"):
                    run.measure(mesh)
                    info["k9"] = run.timing
                one = make_mesh(shape, names, [home] * len(devs))

                def again(run=run, one=one, whole=whole):
                    return {**run(one), **(whole() if whole else {})}
            info["moved_bytes"] = (mesh_mod.transfer_stats["bytes"]
                                   - stats0["bytes"])
            info["wait_s"] = (mesh_mod.transfer_stats["wait_s"]
                              - stats0["wait_s"])
            if home.type == "cuda":
                info["peak_gib"] = torch.cuda.max_memory_allocated(home) / 2**30
            if pid == 0 and args.save:
                np.savez(args.out / f"{name}.npz", **{
                    k: v.detach().float().cpu().numpy()
                    for k, v in got.items()})
            if pid == 0 and args.check:
                # alone: the other processes go on to the next path, whose
                # first transfer waits for this one
                info["errors"] = _errors(got, again())
                if not train:
                    alone.append((name, run, one))
            report["paths"][name] = info
            print(f"[multiprocess_paths] p{pid} {name}: "
                  + json.dumps(info), flush=True)
        if args.check:
            _time_alone(alone, report["paths"], home)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    (args.out / f"p{pid}.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
