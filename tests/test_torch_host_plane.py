"""The port's host plane (``repro_torch.core.reference``, ``metrics``,
``spade`` and ``serve.service``) against the JAX package's, on the same
seeded numpy inputs.

Each case below is one check of ``tests/test_core_reference.py``,
``tests/test_spade_api.py`` or ``tests/test_deletion_enumeration.py``,
written once against a ``core`` namespace and run through both packages:
the case makes the original test's assertions in each package, and what
it returns (``static_peel``'s ``order()``/``delta()``, ``detect``, the
incremental states after ``insert_edges``/``delete_edge``,
``enumerate_communities``, ``Spade``'s ``InsertResult`` fields but
``reorder_seconds``) must be equal across the two: the port's copy is
line for line the reference's, so everything is bit for bit, FD included.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from importlib import import_module

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.graphstore.generators import make_transaction_stream  # noqa: E402
from repro.serve import SpadeService as JaxService  # noqa: E402
from repro_torch._warnings import SpadeDeprecationWarning  # noqa: E402
from repro_torch.graphstore import generators as tgen  # noqa: E402
from repro_torch.serve import EngineSpec, SpadeService, run_service  # noqa: E402

PACKAGES = {"repro": jcore, "repro_torch": tcore}


def assert_same(got, want, path="result"):
    """Equal structure and values; arrays and floats bit for bit."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# ---------------------------------------------------------------------------
# helpers shared by the cases (the originals' generators, on one rng)
# ---------------------------------------------------------------------------


def random_graph(core, rng, n, m, priors=True, a_hi=4):
    g = core.AdjGraph(n)
    if priors:
        g.a[:n] = rng.integers(0, a_hi, size=n).astype(np.float64)
    edges = []
    for _ in range(m):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        if u == v:
            continue
        c = float(rng.integers(1, 6))
        g.add_edge(u, v, c)
        edges.append((u, v, c))
    return g, edges


def naive_peel(g):
    """An independent O(V^2) peel (no heap, no shared code paths)."""
    n = g.n
    w = g.a[:n].astype(np.float64).copy()
    for u in range(n):
        w[u] += sum(g.adj[u].values())
    remaining = set(range(n))
    order, delta = [], []
    while remaining:
        u = min(remaining, key=lambda x: (w[x], x))
        order.append(u)
        delta.append(w[u])
        remaining.discard(u)
        for v, c in g.adj[u].items():
            if v in remaining:
                w[v] -= c
    return np.array(order), np.array(delta)


def brute_best_density(g):
    best = -1.0
    for r in range(1, g.n + 1):
        for S in itertools.combinations(range(g.n), r):
            Sset = set(S)
            f = sum(g.a[u] for u in S)
            for u in S:
                for v, c in g.adj[u].items():
                    if (v in Sset and v > u) or v == u:
                        f += c
            best = max(best, f / len(S))
    return best


def peel_view(state):
    return {"order": state.order().copy(), "delta": state.delta().copy()}


def scratch_equal(core, state):
    """The incremental state equals a from-scratch peel of its graph."""
    expect = core.recompute(state)
    np.testing.assert_array_equal(state.order(), expect.order())
    np.testing.assert_array_equal(state.delta(), expect.delta())
    return peel_view(state)


def result_view(res):
    """An InsertResult's fields but reorder_seconds."""
    out = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
           if f.name not in ("reorder_seconds", "stats")}
    out["stats"] = None if res.stats is None else dataclasses.asdict(res.stats)
    return out


def build_background(rng, n=40, m=100):
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    return n, src[keep], dst[keep], np.ones(keep.sum())


# ---------------------------------------------------------------------------
# tests/test_core_reference.py
# ---------------------------------------------------------------------------


def case_static_peel_matches_naive(core, seed):
    g, _ = random_graph(core, np.random.default_rng(seed), n=40, m=120)
    state = core.static_peel(g.copy())
    o2, d2 = naive_peel(g)
    np.testing.assert_array_equal(state.order(), o2)
    np.testing.assert_allclose(state.delta(), d2)
    assert np.isclose(state.delta().sum(), g.f_total())
    return {**peel_view(state), "detect": core.detect(state)}


def case_two_approximation(core, seed):
    g, _ = random_graph(core, np.random.default_rng(100 + seed), n=9, m=20)
    comm, g_best = core.detect(core.static_peel(g.copy()))
    g_star = brute_best_density(g)
    assert 0.5 * g_star - 1e-9 <= g_best <= g_star + 1e-9
    return {"community": comm, "g_best": g_best}


def case_detect_matches_density_sequence(core, seed):
    g, _ = random_graph(core, np.random.default_rng(7 + seed), n=30, m=90)
    state = core.static_peel(g)
    comm, gb = core.detect(state)
    gseq = core.density_sequence(state)
    assert np.isclose(gb, gseq.max())
    m = int(np.argmax(gseq))
    np.testing.assert_array_equal(np.sort(comm), np.sort(state.order()[m:]))
    return {"community": comm, "g_best": gb, "gseq": gseq}


def incremental_vs_scratch(core, n, all_edges, n_base, batch, priors):
    g = core.AdjGraph(n)
    g.a[:n] = priors
    for u, v, c in all_edges[:n_base]:
        g.add_edge(u, v, c)
    state = core.static_peel(g)
    inc = all_edges[n_base:]
    stats = [dataclasses.asdict(core.insert_edges(state, inc[i:i + batch]))
             for i in range(0, len(inc), batch)]
    full = core.AdjGraph(n)
    full.a[:n] = priors
    for u, v, c in all_edges:
        full.add_edge(u, v, c)
    expect = core.static_peel(full)
    np.testing.assert_array_equal(state.order(), expect.order())
    np.testing.assert_array_equal(state.delta(), expect.delta())
    assert core.detect(state)[1] == core.detect(expect)[1]
    return {**peel_view(state), "stats": stats, "detect": core.detect(state)}


def case_incremental_random(core, seed, batch):
    rng = np.random.default_rng(seed)
    _, edges = random_graph(core, rng, 35, 140)
    priors = rng.integers(0, 3, size=35).astype(np.float64)
    return incremental_vs_scratch(core, 35, edges, int(len(edges) * 0.6), batch, priors)


def case_property_incremental_equals_scratch(core, seed):
    """The hypothesis property on seeded draws: 12 vertices, integer
    weights 1-5, a random split and batch size."""
    rng = np.random.default_rng(1000 + seed)
    edges = []
    for _ in range(int(rng.integers(1, 41))):
        u, v = (int(x) for x in rng.integers(0, 12, 2))
        if u != v:
            edges.append((u, v, float(rng.integers(1, 6))))
    priors = rng.integers(0, 4, 12).astype(np.float64)
    return incremental_vs_scratch(core, 12, edges, int(len(edges) * rng.random()),
                                  int(rng.integers(1, 6)), priors)


def case_incremental_dense_community_emerges(core, seed):
    rng = np.random.default_rng(42 + seed)
    n = 60
    g = core.AdjGraph(n)
    for _ in range(80):
        u, v = rng.integers(0, n, 2)
        if u != v:
            g.add_edge(int(u), int(v), float(rng.integers(1, 3)))
    state = core.static_peel(g)
    block = list(range(10))
    for u in block:
        for v in block:
            if u < v:
                core.insert_edges(state, [(u, v, 10.0)])
    comm, gb = core.detect(state)
    assert set(block) <= set(comm.tolist())
    return {**scratch_equal(core, state), "community": comm, "g_best": gb}


def case_incremental_with_new_vertices(core, seed):
    g, _ = random_graph(core, np.random.default_rng(3 + seed), 20, 50)
    state = core.static_peel(g)
    s1 = core.insert_edges(state, [(20, 5, 4.0)], new_vertices=[(20, 1.0)])
    s2 = core.insert_edges(state, [(21, 20, 2.0), (3, 21, 7.0)], new_vertices=[(21, 0.0)])
    return {**scratch_equal(core, state),
            "stats": [dataclasses.asdict(s1), dataclasses.asdict(s2)]}


def case_insert_between_far_apart_positions(core, seed):
    g, _ = random_graph(core, np.random.default_rng(11 + seed), 30, 80)
    state = core.static_peel(g)
    first, last = int(state.order()[0]), int(state.order()[-1])
    core.insert_edges(state, [(first, last, 3.0)])
    return scratch_equal(core, state)


def case_parallel_edge_accumulation(core, seed):
    g = core.AdjGraph(3)
    g.add_edge(0, 1, 1.0)
    state = core.static_peel(g)
    core.insert_edges(state, [(0, 1, 2.0), (1, 0, 1.0)])
    assert state.graph.adj[0][1] == 4.0
    return scratch_equal(core, state)


# ---------------------------------------------------------------------------
# tests/test_deletion_enumeration.py
# ---------------------------------------------------------------------------


def case_delete_matches_scratch(core, seed):
    rng = np.random.default_rng(seed)
    g, _ = random_graph(core, rng, 30, 100, a_hi=3)
    state = core.static_peel(g)
    out = []
    for _ in range(10):
        u = int(rng.integers(0, 30))
        if not state.graph.adj[u]:
            continue
        v = list(state.graph.adj[u].keys())[0]
        if v == u:
            continue
        st = core.delete_edge(state, u, v)
        out.append({**scratch_equal(core, state), "stats": dataclasses.asdict(st)})
    return out


def case_property_delete_equals_scratch(core, seed):
    rng = np.random.default_rng(2000 + seed)
    edges = []
    while len(edges) < int(rng.integers(3, 31)):
        u, v = (int(x) for x in rng.integers(0, 10, 2))
        if u != v:
            edges.append((u, v, float(rng.integers(1, 6))))
    g = core.AdjGraph(10)
    for u, v, c in edges:
        g.add_edge(u, v, c)
    state = core.static_peel(g)
    u, v, _ = edges[int(rng.integers(0, 10**6)) % len(edges)]
    core.delete_edge(state, u, v)
    return scratch_equal(core, state)


def case_partial_weight_deletion(core, seed):
    g = core.AdjGraph(4)
    g.add_edge(0, 1, 5.0)
    g.add_edge(1, 2, 3.0)
    g.add_edge(2, 3, 1.0)
    state = core.static_peel(g)
    core.delete_edge(state, 0, 1, c=2.0)
    assert state.graph.adj[0][1] == 3.0
    return scratch_equal(core, state)


def case_insert_then_delete_roundtrip(core, seed):
    g, _ = random_graph(core, np.random.default_rng(3 + seed), 25, 80, a_hi=3)
    before = core.static_peel(g.copy())
    state = core.static_peel(g.copy())
    core.insert_edges(state, [(3, 17, 4.0)])
    core.delete_edge(state, 3, 17, c=4.0)
    np.testing.assert_array_equal(state.order(), before.order())
    np.testing.assert_array_equal(state.delta(), before.delta())
    return peel_view(state)


def case_enumerate_finds_planted_blocks(core, seed):
    g, _ = random_graph(core, np.random.default_rng(5 + seed), 80, 60, a_hi=3)
    b1, b2 = np.arange(10), np.arange(40, 48)
    for blk, w in [(b1, 20.0), (b2, 12.0)]:
        for i in blk:
            for j in blk:
                if i < j:
                    g.add_edge(int(i), int(j), w)
    comms = core.enumerate_communities(g, max_k=3)
    found = [set(c.tolist()) for c, _ in comms]
    assert any(set(b1.tolist()) <= f for f in found)
    assert any(set(b2.tolist()) <= f for f in found)
    dens = [d for _, d in comms]
    assert all(dens[i] >= dens[i + 1] - 1e-9 for i in range(len(dens) - 1))
    return comms


# ---------------------------------------------------------------------------
# tests/test_spade_api.py
# ---------------------------------------------------------------------------


def case_load_detect(core, metric):
    n, src, dst, w = build_background(np.random.default_rng(0))
    sp = core.Spade(metric=metric)
    sp.LoadGraph(src, dst, w, n_vertices=n)
    comm, gb = sp.Detect()
    assert gb > 0 and len(comm) > 0
    return {"community": comm, "g_best": gb, "w0": sp._w0.copy()}


def case_insert_edge_matches_scratch(core, metric):
    rng = np.random.default_rng(1)
    n, src, dst, w = build_background(rng)
    sp = core.Spade(metric=metric)
    sp.LoadGraph(src, dst, w, n_vertices=n)
    results = []
    for _ in range(25):
        u, v = rng.integers(0, n, 2)
        if u == v:
            continue
        results.append(result_view(sp.InsertEdge(int(u), int(v), float(rng.integers(1, 5)))))
        scratch_equal(core, sp.state)
    return {**peel_view(sp.state), "results": results, "w0": sp._w0.copy()}


def case_delete_edge_explicit_amount_is_grid_snapped(core, seed):
    sp = core.Spade(metric="DW")
    sp.LoadGraph([0, 1, 2], [1, 2, 0], [0.1, 0.7, 1.0], n_vertices=3)
    r1 = sp.DeleteEdge(0, 1, 0.1)
    assert 1 not in sp.graph.adj[0]
    r2 = sp.DeleteEdge(1, 2, 0.7)
    assert 2 not in sp.graph.adj[1]
    np.testing.assert_allclose(sp._w0[:3], [1.0, 0.0, 1.0], atol=1e-9)
    return {**scratch_equal(core, sp.state), "results": [result_view(r1), result_view(r2)],
            "w0": sp._w0.copy()}


def case_fraud_block_detected_and_reported(core, seed):
    n, src, dst, w = build_background(np.random.default_rng(2), n=60, m=80)
    sp = core.Spade(metric="DW")
    sp.LoadGraph(src, dst, w, n_vertices=n)
    block = list(range(8))
    results = [result_view(sp.InsertEdge(u, v, 20.0))
               for u in block for v in block if u < v]
    comm, gb = sp.Detect()
    assert set(block) <= set(comm.tolist())
    return {"results": results, "community": comm, "g_best": gb}


def case_edge_grouping_buffers_benign_and_flushes(core, seed):
    rng = np.random.default_rng(3)
    n, src, dst, w = build_background(rng, n=50, m=150)
    sp = core.Spade(metric="DG", edge_grouping=True)
    sp.LoadGraph(src, dst, w, n_vertices=n)
    g0 = sp.Detect()[1]
    results = []
    for _ in range(100):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        if u != v and sp._w0[u] + 1.0 < g0 and sp._w0[v] + 1.0 < g0:
            res = sp.InsertEdge(u, v, 1.0)
            assert not res.triggered and res.buffered >= 1
            results.append(result_view(res))
            break
    comm, _ = sp.Detect()
    res2 = sp.InsertEdge(int(comm[0]), int(comm[-1]), 100.0)
    assert res2.triggered and sp.buffered_edges == 0
    results.append(result_view(res2))
    results.append(result_view(sp.FlushBuffer()))
    return {**scratch_equal(core, sp.state), "results": results}


def case_edge_grouping_deferral_is_safe(core, seed):
    rng = np.random.default_rng(4)
    n, src, dst, w = build_background(rng, n=40, m=120)
    sp = core.Spade(metric="DG", edge_grouping=True)
    sp.LoadGraph(src, dst, w, n_vertices=n)
    results = []
    for _ in range(30):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        if u != v:
            results.append(result_view(sp.InsertEdge(u, v, 1.0)))
    results.append(result_view(sp.FlushBuffer()))
    _, g_expect = core.detect(core.static_peel(sp.graph.copy()))
    assert sp.Detect()[1] == g_expect
    return {**peel_view(sp.state), "results": results}


def case_new_vertices_via_api(core, seed):
    sp = core.Spade(metric="DW")
    sp.LoadGraph([0, 1], [1, 2], [1.0, 1.0], n_vertices=3)
    results = [result_view(sp.InsertEdge(3, 0, 5.0)), result_view(sp.InsertEdge(4, 3, 2.0))]
    assert sp.graph.n == 5
    return {**scratch_equal(core, sp.state), "results": results}


def case_custom_vsusp_esusp_hooks(core, seed):
    sp = core.Spade(metric="DG")
    sp.VSusp(lambda u, g: 2.0)
    sp.ESusp(lambda u, v, raw, g: raw * 3.0)
    sp.LoadGraph([0, 1], [1, 2], [1.0, 2.0], n_vertices=3)
    assert sp.graph.a[0] == 2.0 and sp.graph.adj[0][1] == 3.0 and sp.graph.adj[1][2] == 6.0
    return {**peel_view(sp.state), "detect": sp.Detect()}


def case_fd_metric_degree_weighting(core, seed):
    fd = core.make_fd()
    g = core.AdjGraph(3)
    g.add_edge(0, 2, 1.0)
    c1 = fd.edge_susp(0, 2, 1.0, g)
    g.add_edge(1, 2, 1.0)
    c2 = fd.edge_susp(1, 2, 1.0, g)
    assert c2 < c1
    prior = core.make_fd(vertex_prior=lambda u: 0.5 * u)
    return [c1, c2, prior.vertex_susp(3, g)]


def case_batch_admits_new_vertices(core, seed):
    sp = core.Spade(metric="DW")
    sp.LoadGraph([0, 1], [1, 2], [1.0, 1.0], n_vertices=3)
    res = sp.InsertBatchEdges([(0, 3, 2.0), (1, 4, 2.0)])
    assert sp.graph.n == 5 and res.triggered
    first = {**scratch_equal(core, sp.state), "result": result_view(res)}
    sp2 = core.Spade(metric="DW", edge_grouping=True)
    sp2.LoadGraph([0, 1, 2, 0], [1, 2, 0, 3], [100.0, 100.0, 100.0, 1.0], n_vertices=4)
    r1 = sp2.InsertBatchEdges([(3, 4, 0.1), (3, 5, 0.1)])
    assert not r1.triggered and r1.buffered == 2
    r2 = sp2.InsertBatchEdges([(4, 6, 0.1), (5, 7, 0.1)])
    assert not r2.triggered
    out = sp2.FlushBuffer()
    assert sp2.graph.n == 8 and out.triggered
    return [first, {**scratch_equal(core, sp2.state),
                    "results": [result_view(r) for r in (r1, r2, out)]}]


def case_quantize_susp_grid_is_exact(core, seed):
    quantize_susp = import_module(f"{core.__name__}.metrics").quantize_susp
    vals = [quantize_susp(1.0 / math.log(x + 5.0)) for x in range(200)]
    assert sum(vals) == sum(reversed(vals))
    assert all(quantize_susp(v) == v for v in vals)
    return vals


CASES = (
    [("static_peel_matches_naive", case_static_peel_matches_naive, s) for s in range(5)]
    + [("two_approximation", case_two_approximation, s) for s in range(4)]
    + [("detect_matches_density_sequence", case_detect_matches_density_sequence, 0)]
    + [("incremental_random", case_incremental_random, (s, b))
       for s in range(3) for b in (1, 3, 7)]
    + [("property_incremental_equals_scratch", case_property_incremental_equals_scratch, s)
       for s in range(6)]
    + [("incremental_dense_community_emerges", case_incremental_dense_community_emerges, 0),
       ("incremental_with_new_vertices", case_incremental_with_new_vertices, 0),
       ("insert_between_far_apart_positions", case_insert_between_far_apart_positions, 0),
       ("parallel_edge_accumulation", case_parallel_edge_accumulation, 0)]
    + [("delete_matches_scratch", case_delete_matches_scratch, s) for s in range(4)]
    + [("property_delete_equals_scratch", case_property_delete_equals_scratch, s)
       for s in range(6)]
    + [("partial_weight_deletion", case_partial_weight_deletion, 0),
       ("insert_then_delete_roundtrip", case_insert_then_delete_roundtrip, 0),
       ("enumerate_finds_planted_blocks", case_enumerate_finds_planted_blocks, 0)]
    + [("load_detect", case_load_detect, m) for m in ("DG", "DW", "FD")]
    + [("insert_edge_matches_scratch", case_insert_edge_matches_scratch, m)
       for m in ("DG", "DW", "FD")]
    + [("delete_edge_explicit_amount_is_grid_snapped",
        case_delete_edge_explicit_amount_is_grid_snapped, 0),
       ("fraud_block_detected_and_reported", case_fraud_block_detected_and_reported, 0),
       ("edge_grouping_buffers_benign_and_flushes",
        case_edge_grouping_buffers_benign_and_flushes, 0),
       ("edge_grouping_deferral_is_safe", case_edge_grouping_deferral_is_safe, 0),
       ("new_vertices_via_api", case_new_vertices_via_api, 0),
       ("custom_vsusp_esusp_hooks", case_custom_vsusp_esusp_hooks, 0),
       ("fd_metric_degree_weighting", case_fd_metric_degree_weighting, 0),
       ("batch_admits_new_vertices", case_batch_admits_new_vertices, 0),
       ("quantize_susp_grid_is_exact", case_quantize_susp_grid_is_exact, 0)]
)


@pytest.mark.parametrize("name,case,arg", CASES,
                         ids=[f"{n}-{a}" for n, _, a in CASES])
def test_host_plane_matches_reference(name, case, arg):
    args = arg if isinstance(arg, tuple) else (arg,)
    assert_same(case(tcore, *args), case(jcore, *args))


def test_fd_tie_break_regression_seed1():
    """After every single insert the order stays the scratch order under FD
    (the dyadic snap makes the sums exact), and both packages agree."""
    runs = {}
    for name, core in PACKAGES.items():
        rng = np.random.default_rng(1)
        n, src, dst, w = build_background(rng)
        sp = core.Spade(metric="FD")
        sp.LoadGraph(src, dst, w, n_vertices=n)
        orders = []
        for _ in range(16):
            u, v = rng.integers(0, n, 2)
            if u != v:
                sp.InsertEdge(int(u), int(v), float(rng.integers(1, 5)))
                orders.append(scratch_equal(core, sp.state))
        runs[name] = orders
    assert_same(runs["repro_torch"], runs["repro"])


# ---------------------------------------------------------------------------
# host_metric: the semantics' host projection
# ---------------------------------------------------------------------------


def _user_semantics(sem_mod):
    return sem_mod.SuspSemantics(
        name="XPARITY",
        esusp=lambda xp, src, dst, raw, deg, aux: raw * (1.0 + (src + dst) % 2)
        + 1.0 / xp.log(deg + 3.0),
        vsusp=lambda xp, ids, deg, aux: (ids % 3) * 0.5 + deg,
    )


@pytest.mark.parametrize("name", ["DG", "DW", "FD", "user"])
def test_host_metric_values_match_reference(name):
    """DensityMetric values of each semantics' host projection, per vertex
    and per edge as a graph grows (degrees change), equal bit for bit."""
    vals = {}
    for pkg, core in PACKAGES.items():
        sem_mod = import_module(f"{core.__name__}.semantics")
        sem = _user_semantics(sem_mod) if name == "user" else sem_mod.resolve(name)
        metric = sem.host_metric()
        assert isinstance(metric, core.DensityMetric) and metric.name == sem.name
        rng = np.random.default_rng(5)
        g = core.AdjGraph(20)
        out = []
        for _ in range(60):
            u, v = (int(x) for x in rng.integers(0, 20, 2))
            raw = float(rng.lognormal(2.0, 1.0))
            c = metric.edge_susp(u, v, raw, g)
            out.append((c, metric.vertex_susp(u, g), metric.esusp(u, v, raw, g)))
            g.add_edge(u, v, c)
        out.append(metric.vertex_susp(25, g))  # past the graph: degree 0
        vals[pkg] = out
    assert_same(vals["repro_torch"], vals["repro"])


# ---------------------------------------------------------------------------
# the host service, EngineSpec's host plane and the CLI
# ---------------------------------------------------------------------------

TIMING = {"total_reorder_seconds", "mean_us_per_edge", "wall_seconds"}


@pytest.fixture(scope="module")
def stream():
    return make_transaction_stream(n=3000, m=15000, seed=0)


@pytest.mark.parametrize("grouping", [True, False], ids=["grouping", "no-grouping"])
@pytest.mark.parametrize("semantics", ["DG", "DW", "FD"])
def test_host_service_reports_equal(stream, semantics, grouping):
    tstream = tgen.make_transaction_stream(n=3000, m=15000, seed=0)
    want = JaxService(semantics, plane="host", grouping=grouping).run(stream)
    got = SpadeService(semantics, plane="host", grouping=grouping).run(tstream)
    assert type(got).__name__ == "ServiceReport"
    for f in dataclasses.fields(want):
        if f.name not in TIMING:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.fraud_recall == 1.0


def test_host_service_takes_density_metric_and_batches():
    """A DensityMetric serves on the host plane (the reference's facade too),
    with 100-edge batches and a shorter flush period."""
    s = tgen.make_transaction_stream(n=800, m=4000, seed=2)
    js = make_transaction_stream(n=800, m=4000, seed=2)
    kw = dict(plane="host", batch_edges=100, flush_every=0.2)
    got = SpadeService(tcore.make_fd(lambda u: 0.25 * (u % 4)), **kw).run(s)
    want = JaxService(jcore.make_fd(lambda u: 0.25 * (u % 4)), **kw).run(js)
    for f in dataclasses.fields(want):
        if f.name not in TIMING:
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_run_service_shim_warns_and_matches_facade():
    s = tgen.make_transaction_stream(n=600, m=3000, seed=4)
    with pytest.warns(SpadeDeprecationWarning):
        old = run_service(s, "DG", edge_grouping=True)
    new = SpadeService("DG", plane="host").run(s)
    for f in dataclasses.fields(new):
        if f.name not in TIMING:
            assert getattr(old, f.name) == getattr(new, f.name), f.name


def test_engine_spec_host_plane_errors():
    spec = EngineSpec(plane="host")
    assert spec.effective_batch_edges == 1 and spec.grouping and spec.flush_every == 1.0
    assert EngineSpec().effective_batch_edges == 1024
    assert EngineSpec(plane="host", batch_edges=64).effective_batch_edges == 64
    for bad in ({"mesh": object()}, {"workset": True}, {"window_ticks": 4}):
        with pytest.raises(ValueError, match="device-plane settings"):
            EngineSpec(plane="host", **bad)
    for dev in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="host CPU"):
            EngineSpec(plane="host", device=dev)
    with pytest.raises(ValueError, match="plane must be"):
        EngineSpec(plane="tpu")
    with pytest.raises(ValueError, match="positive"):
        EngineSpec(plane="host", batch_edges=0)
    with pytest.raises(TypeError, match="host-plane-only"):
        SpadeService(tcore.DW, device="cpu")
    svc = SpadeService(tcore.DW, plane="host")  # needs no device, even without a GPU
    assert svc.device is None and svc.semantics is tcore.DW


def test_launch_cli_host_plane(capsys):
    from repro_torch.launch.serve import main

    main(["--plane", "host", "--semantics", "FD", "--vertices", "400",
          "--edges", "2000", "--batch", "50", "--grouping"])
    out = capsys.readouterr().out
    assert "plane=host" in out and "reorders=" in out
    for flags in (["--device", "cpu"], ["--window", "2"], ["--workset"]):
        with pytest.raises(SystemExit):
            main(["--plane", "host", *flags])
    with pytest.raises(SystemExit):
        main(["--grouping", "--device", "cpu"])
