"""The collectives of parallel/collectives.py, forward and backward,
against a plain torch sum or concatenation, on meshes of repeated "cpu"
devices; and `ring_attention_local` (parallel/ring.py) against
`ring_attention` on the same shards."""

import numpy as np
import pytest
import torch

from cuda_flashattention_torch.parallel import collectives as coll
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.parallel.ring import (
    ring_attention,
    ring_attention_local,
)

MESH = ((2, 3), ("dp", "tp"))


def _mesh():
    shape, names = MESH
    return make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))


def _shards(mesh, shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return {r: torch.tensor(rng.standard_normal(shape), dtype=dtype)
            for r in range(mesh.size)}


def _groups(mesh, axis):
    return [mesh.axis_ranks(axis, dp=i) for i in range(2)] if axis == "tp" \
        else [mesh.axis_ranks(axis, tp=i) for i in range(3)]


@pytest.mark.parametrize("axis", ["tp", "dp"])
def test_all_reduce_sums_each_group(axis):
    mesh = _mesh()
    xs = _shards(mesh, (5, 7))
    coll.calls["all_reduce"] = 0
    out = coll.all_reduce(mesh, axis, xs)
    assert coll.calls["all_reduce"] == 1
    for group in _groups(mesh, axis):
        want = sum(xs[r] for r in group)
        for r in group:
            torch.testing.assert_close(out[r], want, rtol=0, atol=1e-6)
            assert torch.equal(out[r], out[group[0]])  # the same bits


def test_all_reduce_over_two_axes_sums_bf16_in_fp32():
    """bf16 partials are summed in fp32 and cast once: the result is the
    fp32 sum rounded, where a bf16 running sum would round at each add."""
    mesh = _mesh()
    xs = {r: torch.full((4,), 2.0 ** -8 if r else 1.0, dtype=torch.bfloat16)
          for r in range(mesh.size)}
    out = coll.all_reduce(mesh, ("dp", "tp"), xs)
    want = (1.0 + 5 * 2.0 ** -8)
    for r in range(mesh.size):
        assert out[r].dtype == torch.bfloat16
        assert torch.equal(out[r], torch.full((4,), want).to(torch.bfloat16))
    # a bf16 running sum would stay at 1.0: each 2^-8 is half an ulp
    assert want != 1.0 and torch.tensor(want, dtype=torch.bfloat16) != 1.0


@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather_and_reduce_scatter(dim):
    """all_gather concatenates each group's tensors on `dim`;
    reduce_scatter leaves rank i of a group the i-th `tensor_split` piece
    of the sum (uneven: 7 rows over 3 ranks)."""
    mesh = _mesh()
    xs = _shards(mesh, (7, 7), seed=1)
    gathered = coll.all_gather(mesh, "tp", xs, dim)
    scattered = coll.reduce_scatter(mesh, "tp", xs, dim)
    for group in _groups(mesh, "tp"):
        cat = torch.cat([xs[r] for r in group], dim)
        pieces = sum(xs[r] for r in group).tensor_split(3, dim)
        for i, r in enumerate(group):
            assert torch.equal(gathered[r], cat)
            torch.testing.assert_close(scattered[r], pieces[i], rtol=0,
                                       atol=1e-6)


def _grads(fn, xs, seed):
    """Forward of fn on leaf copies of xs, and the gradients of a seeded
    sum of its outputs."""
    leaves = {r: x.clone().requires_grad_() for r, x in xs.items()}
    out = fn(leaves)
    rng = np.random.default_rng(seed)
    dys = {r: torch.tensor(rng.standard_normal(tuple(y.shape)),
                           dtype=y.dtype) for r, y in out.items()}
    sum((out[r] * dys[r]).sum() for r in out).backward()
    return out, dys, {r: x.grad for r, x in leaves.items()}


def test_all_reduce_over_given_groups():
    """Explicit groups of ranks in place of an axis's: each group summed
    on its ranks, the ranks of no group left out of the result."""
    mesh = _mesh()
    xs = _shards(mesh, (3, 5), seed=8)
    groups = [[0, 4], [1, 2, 5]]
    subset = {r: xs[r] for g in groups for r in g}
    coll.calls["all_reduce"] = 0
    out = coll.all_reduce(mesh, None, subset, groups=groups)
    assert coll.calls["all_reduce"] == 1
    assert sorted(out) == [0, 1, 2, 4, 5]
    for group in groups:
        want = sum(xs[r] for r in group)
        for r in group:
            torch.testing.assert_close(out[r], want, rtol=0, atol=1e-6)
            assert torch.equal(out[r], out[group[0]])


def test_autograd_pairs():
    """Forward and backward of the gather / reduce-scatter pairs against
    their plain forms: each is the other's adjoint."""
    mesh = _mesh()
    xs = _shards(mesh, (6, 4), seed=2)
    groups = _groups(mesh, "tp")

    out, dys, gx = _grads(
        lambda l: coll.gather_from_axis(mesh, "tp", l, 0), xs, 5)
    for g in groups:
        total = sum(dys[s] for s in g)
        for i, r in enumerate(g):
            assert torch.equal(out[r], torch.cat([xs[s] for s in g]))
            torch.testing.assert_close(gx[r], total[6 * i:6 * (i + 1)],
                                       rtol=0, atol=1e-6)

    out, dys, gx = _grads(
        lambda l: coll.reduce_scatter_to_axis(mesh, "tp", l, 0), xs, 6)
    for g in groups:
        whole = sum(xs[s] for s in g)
        grad = torch.cat([dys[s] for s in g])
        for i, r in enumerate(g):
            torch.testing.assert_close(out[r], whole[2 * i:2 * (i + 1)],
                                       rtol=0, atol=1e-6)
            assert torch.equal(gx[r], grad)


def test_collectives_need_whole_groups():
    mesh = _mesh()
    xs = _shards(mesh, (2,))
    del xs[4]
    with pytest.raises(ValueError, match="entries"):
        coll.all_reduce(mesh, "tp", xs)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_ring_attention_local_matches_global(causal, window):
    """Per-rank shards in, per-rank O out: the same bits as
    `ring_attention` on the global tensors with `head_axis`, forward and
    gradients, two rings (one per head shard) over 2 ranks each, GQA."""
    mesh = make_mesh((2, 2), ("tp", "sp"), ["cpu"] * 4)
    rng = np.random.default_rng(7)

    def mk(*shape):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).requires_grad_()

    q, k, v = mk(1, 4, 16, 16), mk(1, 2, 16, 16), mk(1, 2, 16, 16)
    do = torch.tensor(rng.standard_normal((1, 4, 16, 16)),
                      dtype=torch.float32)
    o = ring_attention(q, k, v, mesh, "sp", causal=causal, window=window,
                       head_axis="tp")
    grads = torch.autograd.grad(o, (q, k, v), do)

    def cut(x, heads, r):
        c = mesh.coords(r)
        return x[:, c["tp"] * heads:(c["tp"] + 1) * heads,
                 c["sp"] * 8:(c["sp"] + 1) * 8]

    shards = [{r: cut(x, h, r) for r in range(4)}
              for x, h in ((q, 2), (k, 1), (v, 1))]
    o_local = ring_attention_local(*shards, mesh, "sp", causal=causal,
                                   window=window)
    assert sorted(o_local) == list(range(4))
    loss = 0
    for r in range(4):
        assert torch.equal(o_local[r], cut(o, 2, r))
        loss = loss + (o_local[r] * cut(do, 2, r)).sum()
    for g, g_local in zip(grads, torch.autograd.grad(loss, (q, k, v))):
        assert torch.equal(g, g_local)

    # the list form: one ring, in axis_ranks order
    ring = mesh.axis_ranks("sp")
    listed = ring_attention_local(*[[s[r] for r in ring] for s in shards],
                                  mesh, "sp", causal=causal, window=window)
    for r, o_r in zip(ring, listed):
        assert torch.equal(o_r, o_local[r])
