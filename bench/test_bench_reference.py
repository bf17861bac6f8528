"""The plain reference against a brute-force peel, on graphs of a few
dozen vertices with integer weights (so every sum is exact)."""

import itertools
import random

import torch

from spade import reference as ref

EPS = 0.1


def brute_peel(n, edges, a, live, prior_g, max_rounds):
    """The threshold bulk peel, vertex by vertex and edge by edge."""
    active = set(live)
    alive = [(u, v, c) for u, v, c in edges if u in active and v in active]
    w = {x: a[x] for x in active}
    for u, v, c in alive:
        w[u] += c
        w[v] += c
    f = sum(a[x] for x in active) + sum(c for _, _, c in alive)
    level = [-1] * n
    best, best_level, r = prior_g, 0, 0
    while active and (max_rounds == 0 or r < max_rounds):
        g = f / len(active)
        if g > best:
            best, best_level = g, r
        peel = {x for x in active if w[x] <= 2 * (1 + EPS) * g}
        if not peel:
            least = min(w[x] for x in active)
            peel = {x for x in active if w[x] == least}
        left = []
        for u, v, c in alive:
            if u in peel or v in peel:
                f -= c
                if u not in peel:
                    w[u] -= c
                if v not in peel:
                    w[v] -= c
            else:
                left.append((u, v, c))
        alive = left
        for x in peel:
            level[x] = r
            f -= a[x]
        active -= peel
        r += 1
    return level, best, best_level


def graph(n, edges, a):
    return ref.Graph(src=torch.tensor([u for u, _, _ in edges]),
                     dst=torch.tensor([v for _, v, _ in edges]),
                     c=torch.tensor([float(c) for _, _, c in edges]),
                     mask=torch.ones(len(edges), dtype=torch.bool),
                     a=torch.tensor([float(x) for x in a]), vmask=torch.ones(n, dtype=torch.bool))


def random_graph(rng, n, m, block):
    edges = [(rng.randrange(n), rng.randrange(n), rng.randrange(1, 6)) for _ in range(m)]
    edges += [(u, v, rng.randrange(5, 9)) for u in block for v in block if u < v]
    edges = [(u, v, c) for u, v, c in edges if u != v]
    return edges, [rng.randrange(0, 3) for _ in range(n)]


def test_bench_reference_peel_matches_brute_force():
    rng = random.Random(11)
    for trial in range(20):
        n = rng.randrange(20, 40)
        edges, a = random_graph(rng, n, 3 * n, rng.sample(range(n), 6))
        live = set(rng.sample(range(n), n - 3)) if trial % 2 else set(range(n))
        rounds = 0 if trial % 3 == 0 else 2
        want = brute_peel(n, edges, a, live, -1.0, rounds)
        mask = torch.tensor([x in live for x in range(n)])
        got = ref.bulk_peel(graph(n, edges, a), mask, -1.0, EPS, rounds)
        assert got.level.tolist() == want[0]
        assert got.best_g == want[1] and got.best_level == want[2]


def test_bench_reference_peel_keeps_its_guarantee():
    """best density at least g* / (2 (1 + eps)), g* found by trying every
    vertex set of a 12-vertex graph."""
    rng = random.Random(5)
    for _ in range(5):
        n = 12
        edges, a = random_graph(rng, n, 30, rng.sample(range(n), 4))
        best = 0.0
        for k in range(1, n + 1):
            for s in itertools.combinations(range(n), k):
                s = set(s)
                mass = sum(a[x] for x in s) + sum(c for u, v, c in edges if u in s and v in s)
                best = max(best, mass / k)
        got = ref.bulk_peel(graph(n, edges, a), torch.ones(n, dtype=torch.bool), -1.0, EPS, 0)
        assert best / (2 * (1 + EPS)) <= got.best_g <= best


def test_bench_reference_step_is_a_warm_peel_of_the_slid_window():
    rng = random.Random(3)
    n = 30
    edges, a = random_graph(rng, n, 60, rng.sample(range(n), 5))
    e_cap = len(edges) + 8
    g = graph(n, edges, a)
    pad = torch.full((8,), n - 1)
    g = g._replace(src=torch.cat([g.src, pad]), dst=torch.cat([g.dst, pad]),
                   c=torch.cat([g.c, torch.zeros(8)]),
                   mask=torch.arange(e_cap) < len(edges))
    s = ref.start(g, EPS)
    bs, bd, bc = torch.tensor([1, 2, 3]), torch.tensor([4, 5, 6]), torch.tensor([2.0, 2.0, 2.0])
    drop_lo, drop_hi = 10, 14
    out = ref.step(s, drop_lo, drop_hi, bs, bd, bc, EPS, 20)
    kept = [e for i, e in enumerate(edges) if not drop_lo <= i < drop_hi]
    slid = kept + list(zip([1, 2, 3], [4, 5, 6], [2, 2, 2]))
    assert out.graph.src[:len(slid)].tolist() == [u for u, _, _ in slid]
    assert out.graph.mask.sum() == len(slid) and out.edge_count == len(slid)
    # the batch touches level-0 vertices here, so the whole graph is peeled again
    r0 = min(int(s.level[torch.tensor([1, 2, 3, 4, 5, 6])].min()),
             int(s.level[g.src[drop_lo:drop_hi]].min()), int(s.level[g.dst[drop_lo:drop_hi]].min()))
    assert r0 == 0
    comm = s.community
    loss = sum(c for u, v, c in edges[drop_lo:drop_hi] if comm[u] and comm[v])
    prior = s.best_g - loss / int(comm.sum())
    want = brute_peel(n, slid, a, set(range(n)), prior, 20)
    assert out.level.tolist() == [x if x >= 0 else 20 for x in want[0]]
    assert out.best_g == max(want[1], prior)
    w0 = [a[x] + sum(c for u, v, c in slid if x in (u, v)) for x in range(n)]
    assert out.w0.tolist() == [float(x) for x in w0]
