"""The device ring's protocol (csrc/device_ring.cu, K9) on the CPU.

`parallel/device_ring.py` states the kernel's plan in plain Python and its
wrapper uses it: the common grid, the span partition, the rounds and the
epoch flag words. These tests hold that plan, then run the kernel's
program for every CTA of every rank in a seeded random interleaving
(numpy's generator picks which CTA moves next), over several calls on one
workspace whose flags are never zeroed again. The simulation checks that
no slot is overwritten before its reader has taken it, that every read
finds the shard the step expects, that every wait is eventually met (no
state where nothing can move), and that every rank's o equals
(Σ_i x_i) @ W. One card: a call's CTAs start together once the previous
call's have all ended (one launch on one stream). Across cards: each card
runs its own ranks' CTAs and its calls in order, unordered with the other
cards'. Across processes the plan adds which pointer-table entries are a
process's own and which are mapped from another's allocation, where in an
allocation each rank's blocks sit, and the grid the processes agree on;
the protocol is then simulated with each process a launch of its own.
Gate: 1e-12 on float64 sums of the same products."""

import numpy as np
import pytest

from cuda_flashattention_torch.parallel.device_ring import (
    EPOCH_LIMIT,
    FLAG_WORDS,
    KERNEL_GROUP_TILES,
    XP_ALIGN,
    column_parts,
    common_grid,
    flag_value,
    rounds_of,
    span_partition,
    xp_grid,
    xp_layout,
    xp_sources,
)

RECV, CREDIT, START = "recv", "credit", "start"


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles", [1, 2, 3, 7, 16, 127, 128, 129])
def test_span_partition_takes_every_tile_once(tiles):
    for grid in range(1, tiles + 1):
        spans = span_partition(tiles, grid)
        assert len(spans) == grid
        covered = [t for first, count in spans
                   for t in range(first, first + count)]
        assert covered == list(range(tiles))
        counts = [count for _, count in spans]
        assert min(counts) >= 1 and max(counts) - min(counts) <= 1


def test_span_partition_refuses_an_empty_cta():
    for tiles, grid in ((4, 5), (4, 0)):
        with pytest.raises(ValueError):
            span_partition(tiles, grid)


def test_common_grid_is_the_least_card_share():
    """Two cards holding 3 and 1 ranks of one ring take one grid: the
    card with more ranks sets it, so every rank cuts its tiles alike."""
    resident = {"a": 396, "b": 396}
    assert common_grid(resident, {"a": 3, "b": 1}, 256) == 132
    assert common_grid(resident, {"a": 3, "b": 1}, 16) == 16
    assert common_grid({"a": 396}, {"a": 8}, 128) == 49
    assert common_grid({"a": 396, "b": 264}, {"a": 2, "b": 2}, 512) == 132
    with pytest.raises(RuntimeError, match="resident"):
        common_grid({"a": 4}, {"a": 8}, 16)


@pytest.mark.parametrize("d", sorted(KERNEL_GROUP_TILES))
def test_rounds_cover_a_span(d):
    group = KERNEL_GROUP_TILES[d]
    for count in range(1, 20):
        r = rounds_of(count, d)
        assert (r - 1) * group < count <= r * group


def test_flag_values_grow_across_epochs():
    """Every value of a later call exceeds every target of an earlier one,
    so flags are zeroed only when the workspace is made."""
    counts = [0, 1, 7, 1 << 20, (1 << 31) - 1]
    for e in (1, 2, 1000, EPOCH_LIMIT - 2):
        assert min(flag_value(e + 1, c) for c in counts) > max(
            flag_value(e, c) for c in counts)
        vals = [flag_value(e, c) for c in counts]
        assert vals == sorted(vals)
    assert flag_value(EPOCH_LIMIT - 1, 0) < 1 << 64
    for bad in ((0, 0), (EPOCH_LIMIT, 0), (1, 1 << 31), (1, -1)):
        with pytest.raises(ValueError):
            flag_value(*bad)


# ---------------------------------------------------------------------------
# The simulation
# ---------------------------------------------------------------------------

class Fault(AssertionError):
    pass


class Ring:
    """The ranks' shared state: per-rank flag words and double buffers of
    tiles (each slot entry: the tag it holds and whether its reader has
    taken it), the inputs and the outputs."""

    def __init__(self, n, tiles, d, grid, rng, credit=True, start=True):
        self.n, self.tiles, self.grid, self.d = n, tiles, grid, d
        self.group = KERNEL_GROUP_TILES[d]
        self.spans = span_partition(tiles, grid)
        self.credit, self.start = credit, start
        self.flags = {}
        self.buf = {}
        self.w = rng.standard_normal((3, 3))
        self.out = {}  # (epoch, rank, tile) -> o

    def word(self, rank, c, name):
        return self.flags.get((rank, c, name), 0)

    def program(self, epoch, rank, c, sys, x):
        """The kernel's program for CTA c of `rank` in call `epoch` (x: the
        call's shards): yields ("wait", (rank, c, word), target) or ("do",
        effect)."""
        n = self.n
        right, left = (rank + 1) % n, (rank - 1) % n
        first, count = self.spans[c]

        def put(key, value):
            def effect():
                self.flags[key] = value
            return effect

        if sys and n > 1 and self.start:
            yield "do", put((left, c, START), flag_value(epoch, 0))
        for r in range(rounds_of(count, self.d)):
            tiles = range(first + r * self.group,
                          min(first + (r + 1) * self.group, first + count))
            acc = {t: np.zeros(3) for t in tiles}
            for s in range(n):
                push = s < n - 1
                ctr = flag_value(epoch, r * n + s)
                if s > 0:
                    yield "wait", (rank, c, RECV), ctr
                stage = {}
                for t in tiles:
                    def load(t=t, s=s):
                        want = (epoch, (rank - s) % n, t)
                        if s == 0:
                            stage[t] = (want, x[rank][t])
                            return
                        key = (rank, s & 1, t)
                        if key not in self.buf:
                            raise Fault(f"rank {rank} read {key} before any "
                                        f"push")
                        tag, value, unread = self.buf[key]
                        if not unread or tag != want:
                            raise Fault(f"rank {rank} step {s} read {tag} "
                                        f"(unread {unread}), wanted {want}")
                        self.buf[key] = (tag, value, False)
                        stage[t] = (tag, value)
                    yield "do", load
                if push and s >= 2 and self.credit:
                    yield "wait", (rank, c, CREDIT), ctr - 1
                if push and sys and r == 0 and s == 0 and self.start:
                    yield "wait", (rank, c, START), flag_value(epoch, 0)
                for t in tiles:
                    if push:
                        def store(t=t, s=s):
                            key = (right, (s + 1) & 1, t)
                            if key in self.buf and self.buf[key][2]:
                                raise Fault(
                                    f"rank {rank} overwrote {key} holding "
                                    f"{self.buf[key][0]} before its reader "
                                    f"took it")
                            tag, value = stage[t]
                            self.buf[key] = (tag, value, True)
                        yield "do", store
                    acc[t] = acc[t] + stage[t][1] @ self.w
                if 1 <= s <= n - 3 and self.credit:
                    yield "do", put((left, c, CREDIT), ctr)
                if push:
                    yield "do", put((right, c, RECV), ctr + 1)

            def write(acc=acc):
                for t, v in acc.items():
                    self.out[epoch, rank, t] = v
            yield "do", write


def run(ring, epochs, cards, rng):
    """Runs `epochs` calls. `cards`: the card of each rank; each card runs
    its ranks' CTAs of a call together once its previous call's CTAs have
    all ended. Returns the number of actions taken; raises Fault."""
    n = ring.n
    sys = len(set(cards)) > 1
    by_card = {}
    for rank, card in enumerate(cards):
        by_card.setdefault(card, []).append(rank)
    inputs = {e: [{t: rng.standard_normal(3) for t in range(ring.tiles)}
                  for _ in range(n)] for e in range(1, epochs + 1)}
    next_epoch = {card: 1 for card in by_card}
    running = {}      # (card, epoch, rank, c) -> generator
    pending = {}      # same key -> the action it is at
    finished = {}
    actions = 0

    def launch(card):
        e = next_epoch[card]
        if e > epochs:
            return
        next_epoch[card] = e + 1
        for rank in by_card[card]:
            for c in range(ring.grid):
                key = (card, e, rank, c)
                gen = ring.program(e, rank, c, sys, inputs[e])
                running[key] = gen
                pending[key] = next(gen, None)
        finished[card, e] = 0

    for card in by_card:
        launch(card)
    while running:
        ready = []
        for key, act in pending.items():
            if act is None:
                ready.append(key)
            elif act[0] == "do":
                ready.append(key)
            elif ring.word(*act[1]) >= act[2]:
                ready.append(key)
        if not ready:
            raise Fault(f"no CTA can move: waits "
                        f"{sorted(set(a[1:] for a in pending.values()))}")
        key = ready[rng.integers(len(ready))]
        card, e, rank, c = key
        act = pending[key]
        if act is None:
            del running[key], pending[key]
            finished[card, e] += 1
            if finished[card, e] == len(by_card[card]) * ring.grid:
                launch(card)
            continue
        if act[0] == "do":
            act[1]()
        actions += 1
        pending[key] = next(running[key], None)
    for e in range(1, epochs + 1):
        for t in range(ring.tiles):
            want = sum(inputs[e][i][t] for i in range(n)) @ ring.w
            for rank in range(n):
                got = ring.out[e, rank, t]
                if not np.allclose(got, want, rtol=0, atol=1e-12):
                    raise Fault(f"epoch {e}: rank {rank} tile {t}: {got} "
                                f"against {want}")
    return actions


# (n, tiles, grid, d): tiles at the spans' edges (one tile per CTA, one
# more than the grid, a span one past a round, several rounds)
CASES = [(1, 1, 1, 128), (1, 5, 2, 128), (2, 1, 1, 128), (2, 3, 2, 128),
         (3, 4, 3, 128), (4, 5, 2, 128), (4, 9, 2, 64), (5, 7, 3, 128),
         (8, 3, 1, 128), (8, 16, 4, 128), (8, 9, 4, 64), (13, 6, 2, 128),
         (16, 5, 2, 128), (32, 3, 1, 128), (32, 5, 2, 128), (32, 9, 2, 64)]


@pytest.mark.parametrize("n,tiles,grid,d", CASES)
def test_one_card_ring_over_epochs(n, tiles, grid, d):
    for seed in range(3):
        rng = np.random.default_rng(seed * 1000 + n)
        ring = Ring(n, tiles, d, grid, rng)
        assert run(ring, 3, [0] * n, rng) > 0


@pytest.mark.parametrize("n,tiles,grid,cards", [
    (2, 3, 2, [0, 1]), (4, 5, 2, [0, 1, 2, 3]), (4, 3, 1, [0, 0, 1, 1]),
    (5, 4, 2, [0, 0, 0, 1, 1]), (8, 5, 2, [0, 1, 2, 3, 0, 1, 2, 3]),
    (8, 3, 3, [0, 0, 0, 1, 2, 2, 3, 3]), (16, 5, 2, [i % 4 for i in
                                                    range(16)])])
def test_ring_across_cards_over_epochs(n, tiles, grid, cards):
    """Each card's calls run in order, unordered with the other cards'
    (the .sys build): the START word keeps a rank from pushing into a
    neighbour still in its previous call."""
    for seed in range(4):
        rng = np.random.default_rng(seed * 7919 + n)
        ring = Ring(n, tiles, 128, grid, rng)
        assert run(ring, 4, cards, rng) > 0


def _faults(make, cards, epochs, seeds):
    found = 0
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        try:
            run(make(rng), epochs, cards, rng)
        except Fault:
            found += 1
    return found


def test_simulation_catches_a_missing_credit():
    """Without the credit a writer can overwrite a slot its reader has not
    taken yet: the simulation must see it."""
    n = 6
    found = _faults(lambda rng: Ring(n, 2, 128, 1, rng, credit=False),
                    [0] * n, 2, 40)
    assert found > 0


def test_simulation_catches_a_missing_start_word():
    """Across cards, without the START word a rank can push into a
    neighbour that is still in its previous call."""
    n = 4
    found = _faults(lambda rng: Ring(n, 2, 128, 1, rng, start=False),
                    [0, 1, 2, 3], 4, 60)
    assert found > 0


# ---------------------------------------------------------------------------
# Across processes: the workspace's plan
# ---------------------------------------------------------------------------

LAYOUTS = {"2x2": [0, 0, 1, 1], "4x1": [0, 1, 2, 3],
           "interleaved": [0, 1, 0, 1], "3 of 5": [0, 0, 1, 2, 2]}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_xp_table_entries_are_own_or_mapped(layout):
    """Seen from every process, each rank of the ring resolves to the same
    allocation (its owner's) and block (its index among the owner's
    ranks); the owner's entries are its own pointers, every other one is
    mapped from the owner's handle, so no process opens its own."""
    procs = LAYOUTS[layout]
    resolved = {}
    for me in sorted(set(procs)):
        table = xp_sources(procs, me)
        assert len(table) == len(procs)
        for i, (src, owner) in enumerate(zip(table, procs)):
            if owner == me:
                assert src[0] == "local"
            else:
                assert src[0] == "mapped" and src[1] == owner
            resolved.setdefault(i, set()).add((owner, src[-1]))
    for i, seen in resolved.items():
        assert len(seen) == 1, (i, seen)
    blocks = [next(iter(resolved[i])) for i in range(len(procs))]
    assert len(set(blocks)) == len(procs)  # no two ranks share a block
    for p in set(procs):  # an owner's blocks are 0 .. its ranks - 1
        assert sorted(j for q, j in blocks if q == p) == list(
            range(procs.count(p)))


@pytest.mark.parametrize("rows,d,f32,grid", [
    (64, 64, False, 1), (1024, 128, False, 16), (8192, 128, True, 64),
    (1024, 256, False, 16), (8192, 256, True, 33)])
def test_xp_layout_blocks(rows, d, f32, grid):
    """Each rank's double buffers (bf16 tile images, twice the bytes under
    fp32: hi and lo; one pair per column part) and flag words (FLAG_WORDS
    64-bit words per CTA) in aligned blocks that do not overlap and fit
    the allocation; a block's offset does not depend on how many ranks the
    allocation holds, so another process finds it."""
    parts = column_parts(d, f32)
    buf = parts * 2 * (2 if f32 else 1) * rows * d * 2
    flags = parts * grid * FLAG_WORDS * 8
    for n_local in (1, 2, 3):
        blocks, total = xp_layout(rows, d, f32, grid, n_local)
        spans = sorted([(b, b + buf) for b, _ in blocks]
                       + [(f, f + flags) for _, f in blocks])
        for (a0, a1), (b0, _) in zip(spans, spans[1:]):
            assert a1 <= b0
        assert spans[-1][1] <= total
        assert all(a % XP_ALIGN == 0 for a, _ in spans)
        assert blocks == xp_layout(rows, d, f32, grid, 3)[0][:n_local]


def test_xp_grid_counts_every_process_on_a_card():
    """The processes' agreed grid: the ranks on one card count together
    whatever process runs them, so four processes of one rank on one card
    take the grid of one process of four ranks; distinct cards take each
    card's share; never more than one span per tile."""
    one = dict(card="h/GPU-a", resident=264, ranks=1)
    assert xp_grid({p: one for p in range(4)}, 256) == 66
    assert xp_grid({p: dict(one, ranks=2) for p in range(2)}, 256) == 66
    assert xp_grid({p: dict(one, card=f"h/GPU-{p}") for p in range(4)},
                   256) == 256
    assert xp_grid({p: dict(one, card=f"h/GPU-{p}") for p in range(4)},
                   16) == 16
    mixed = {0: dict(one, ranks=2), 1: dict(one, card="h/GPU-b"),
             2: dict(one, card="h/GPU-b", ranks=3)}
    assert xp_grid(mixed, 512) == 66
    assert xp_grid({0: one, 1: one}, 256) == common_grid(
        {"h/GPU-a": 264}, {"h/GPU-a": 2}, 256)


@pytest.mark.parametrize("layout", ["2x2", "4x1", "interleaved"])
def test_ring_across_processes_over_epochs(layout):
    """Each process launches its own ranks and runs its calls in order,
    unordered with the other processes' (the .sys build, its kernels
    interleaved as a card that switches between processes runs them): the
    protocol holds over epochs with the grid the processes agree on."""
    procs = LAYOUTS[layout]
    infos = {p: dict(card="h/GPU-a", resident=12, ranks=procs.count(p))
             for p in set(procs)}
    tiles = 7
    grid = xp_grid(infos, tiles)
    assert grid == 3
    for seed in range(4):
        rng = np.random.default_rng(seed * 104729 + len(layout))
        ring = Ring(len(procs), tiles, 128, grid, rng)
        assert run(ring, 4, procs, rng) > 0
