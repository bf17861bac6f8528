"""The port's host oracle against the port's device plane, tick by tick, on
the CPU (the kernels' plain versions).

``test_custom_semantics_cross_plane_differential`` makes the checks of
``tests/test_window_differential.py::test_custom_semantics_cross_plane_differential``:
a user semantics with a vertex prior through the port's host ``Spade``
(expiry by ``DeleteEdge``) and the port's fused and workset engines, with
the JAX package's single-device fused engine taking the same ticks beside
them, and the port's edge-sharded engine (``state_sh``: two ``gloo``
ranks on the CPU, spawned, replaying the same ticks and a last insert
through the workset engine).  On integer weights the window's edge
multiset, ``w0`` and the host funnel's batch weights are bit-identical
across the planes, every engine's state is bit-identical, and ``best_g``
is at most its community's density and the brute-forced optimum.

The other tests run ``chip_smoke.py``'s phase-12 harness at small sizes on
the CPU: 12a (insert-only ticks, DG, the parity semantics, DW and FD), 12b
(a window of 2 ticks, host expiry by ``DeleteEdge``) and 12c
(``exact_peel`` against ``static_peel``, tied weights included).
"""

from __future__ import annotations

import itertools
import multiprocessing
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

if multiprocessing.parent_process() is None:  # not in a spawned rank: no jax there
    import jax.numpy as jnp

    from repro.core import incremental as ji
    from repro.core.semantics import SuspSemantics as JaxSemantics
    from repro.graphstore import structs as jst
from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.core import Spade, peeling_weights_full  # noqa: E402
from repro_torch.core import incremental as ti  # noqa: E402
from repro_torch.core.peel import bulk_peel  # noqa: E402
from repro_torch.core.semantics import SuspSemantics  # noqa: E402
from repro_torch.graphstore import structs as tst  # noqa: E402
from repro_torch.graphstore.generators import make_transaction_stream  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

N = 10  # vertex universe: small enough to brute-force the optimal density
V_CAP, E_CAP = 16, 96
EPS = 0.1
MAX_ROUNDS = 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parity(cls):
    return cls(name="XPARITY",
               esusp=lambda xp, src, dst, raw, deg, aux: raw * (1.0 + (src + dst) % 2),
               vsusp=lambda xp, ids, deg, aux: (ids % 3) * 1.0)


def _brute_best_density(edges, a) -> float:
    best = 0.0
    for r in range(1, N + 1):
        for S in itertools.combinations(range(N), r):
            Sset = set(S)
            f = sum(float(a[u]) for u in Sset)
            f += sum(c for u, v, c in edges if u in Sset and v in Sset)
            best = max(best, f / r)
    return best


def _live_edges(state):
    d = state_to_numpy(state)
    em = d["edge_mask"]
    return sorted(zip(d["src"][em].tolist(), d["dst"][em].tolist(), d["c"][em].tolist()))


def _same_state(a, b, tag):
    x, y = state_to_numpy(a), state_to_numpy(b)
    for k in x:
        np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=f"{tag}:{k}")


def _same_as_jax(tstate, jstate, tag):
    got = state_to_numpy(tstate)
    for f in ("level", "best_g", "community", "edge_count", "w0"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jstate, f)),
                                      err_msg=f"{tag}:{f}")
    for f in ("src", "dst", "c", "edge_mask"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jstate.graph, f)),
                                      err_msg=f"{tag}:graph.{f}")


def test_custom_semantics_cross_plane_differential():
    sem, jsem = _parity(SuspSemantics), _parity(JaxSemantics)
    rng = np.random.default_rng(1234)

    def rand_batch(k):
        out = []
        for _ in range(k):
            u, v = (int(x) for x in rng.integers(0, N, 2))
            if u != v:
                out.append((u, v, int(rng.integers(1, 6))))
        return out

    base = rand_batch(12) or [(0, 1, 2)]
    ticks = [rand_batch(int(rng.integers(1, 4))) for _ in range(6)]
    window, B = 2, 4
    src = np.array([e[0] for e in base], np.int64)
    dst = np.array([e[1] for e in base], np.int64)
    amt = np.array([e[2] for e in base], np.float64)

    base_w, in_deg = sem.seed_base(src, dst, amt, N)
    a0 = sem.seed_vertices(N, in_deg)
    mk = lambda: tst.device_graph_from_coo(N, src, dst, base_w, a=a0, n_capacity=V_CAP,
                                           e_capacity=E_CAP, device="cpu")
    state, state_ws = ti.init_state(mk(), eps=EPS), ti.init_state(mk(), eps=EPS)
    jstate = ji.init_state(jst.device_graph_from_coo(
        N, src, dst, base_w, a=a0, n_capacity=V_CAP, e_capacity=E_CAP), eps=EPS)

    sp = Spade(metric=sem)
    sp.LoadGraph(src, dst, amt, n_vertices=N)
    m = sp.metric
    deg = torch.zeros(V_CAP, dtype=torch.int32)
    deg[:N] = torch.from_numpy(in_deg.astype(np.int32))
    jdeg = jnp.zeros(V_CAP, jnp.int32).at[:N].set(jnp.asarray(in_deg, jnp.int32))
    m_base = len(base)
    ring: list[list[tuple[int, int, float]]] = []
    slots = torch.arange(E_CAP, dtype=torch.int32)
    jslots = jnp.arange(E_CAP, dtype=jnp.int32)

    replay, want_sh = [], []  # the ticks for the sharded engine, and the states it must reach
    for t, batch in enumerate(ticks):
        expired = ring.pop(0) if len(ring) >= window else []
        bs = np.zeros(B, np.int32)
        bd = np.zeros(B, np.int32)
        raw = np.zeros(B, np.float32)
        valid = np.zeros(B, bool)
        for k, (u, v, r) in enumerate(batch):
            bs[k], bd[k], raw[k], valid[k] = u, v, r, True
        tb = [torch.from_numpy(x) for x in (bs, bd, raw, valid)]
        w, deg = sem.batch_weights(deg, tb[0], tb[1], tb[2], tb[3])
        jw, jdeg = jsem.batch_weights(jdeg, *(jnp.asarray(x) for x in (bs, bd, raw, valid)))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))

        # host-funnel weights equal the device weights bit for bit
        host_w = [m.edge_susp(u, v, float(r), sp.graph) for u, v, r in batch]
        np.testing.assert_array_equal(w.numpy()[:len(batch)], np.asarray(host_w, np.float32))

        drop = (slots >= m_base) & (slots < m_base + len(expired))
        jdrop = (jslots >= m_base) & (jslots < m_base + len(expired))
        state = ti.slide_and_maintain(state, drop, tb[0], tb[1], w, tb[3], eps=EPS,
                                      max_rounds=MAX_ROUNDS)
        state_ws, _ = ti.slide_and_maintain_auto(state_ws, drop, tb[0], tb[1], w, tb[3],
                                                 eps=EPS, max_rounds=MAX_ROUNDS,
                                                 min_bucket=4)
        jstate = ji.slide_and_maintain(jstate, jdrop, jnp.asarray(bs), jnp.asarray(bd), jw,
                                       jnp.asarray(valid), eps=EPS, max_rounds=MAX_ROUNDS)
        _same_state(state, state_ws, f"ws-tick{t}")
        _same_as_jax(state, jstate, f"jax-tick{t}")
        replay.append((bs, bd, w.numpy(), valid, len(expired)))
        want_sh.append(state_to_numpy(state))

        sp.InsertBatchEdges([(u, v, float(r)) for u, v, r in batch])
        for u, v, c in expired:
            sp.DeleteEdge(u, v, c)
        ring.append([(u, v, float(c)) for (u, v, _), c in zip(batch, host_w)])

        mirror = [(u, v, float(c)) for u, v, c in zip(src.tolist(), dst.tolist(),
                                                       base_w.tolist())]
        mirror += [e for b in ring for e in b]
        # 1. window edge multiset equals the host mirror
        assert _live_edges(state) == sorted(mirror)
        # 2. w0, priors included, equals the host graph's peeling weights
        np.testing.assert_array_equal(state.w0.numpy()[:N],
                                      peeling_weights_full(sp.graph)[:N].astype(np.float32))
        # 3. best_g is at most its community's density and the optimum
        comm = set(np.nonzero(state.community.numpy())[0].tolist())
        assert comm
        g_comm = (sum(float(a0[u]) for u in comm)
                  + sum(c for u, v, c in mirror if u in comm and v in comm)) / len(comm)
        assert float(state.best_g) <= g_comm + 1e-4
        assert float(state.best_g) <= _brute_best_density(mirror, a0) + 1e-4

    # an insert-only tick through the workset engines, sharded included
    last = [torch.tensor([0, 1, 2, 3], dtype=torch.int32),
            torch.tensor([4, 5, 6, 7], dtype=torch.int32),
            torch.tensor([2.0, 3.0, 1.0, 4.0]), torch.ones(4, dtype=torch.bool)]
    w, deg = sem.batch_weights(deg, *last)
    last[2] = w
    state_ws, _ = ti.insert_and_maintain_auto(state_ws, *last, eps=EPS, max_rounds=MAX_ROUNDS,
                                              min_bucket=4)
    replay.append(tuple(x.numpy() for x in last))
    want_sh.append(state_to_numpy(state_ws))

    # the edge-sharded engine on two ranks: every tick's state, the ranks'
    # blocks joined, bit for bit
    ranks = spawn(_sharded_replay, 2, backend="gloo", device="cpu",
                  args=((src, dst, base_w, a0), m_base, replay), timeout=300)
    for t, want in enumerate(want_sh):
        for r in ranks:
            for f in ("level", "best_g", "community", "edge_count", "w0"):
                np.testing.assert_array_equal(r[t][f], want[f], err_msg=f"sh-tick{t}:{f}")
        for f in ("src", "dst", "c", "edge_mask"):
            got = np.concatenate([r[t][f] for r in ranks])
            np.testing.assert_array_equal(got, want[f], err_msg=f"sh-tick{t}:graph.{f}")

    # a full refresh agrees with a scratch bulk peel of the survivors
    refreshed = ti.full_refresh(state, eps=EPS)
    scratch = bulk_peel(state.graph, eps=EPS)
    np.testing.assert_array_equal(refreshed.level.numpy(), scratch.level.numpy())
    assert float(refreshed.best_g) == float(scratch.best_g)


def _sharded_replay(mesh, base, m_base: int, replay) -> list[dict]:
    """A rank of the sharded row: the window ticks through
    ``sharded_slide_and_maintain``, the last (insert-only) tick through
    ``sharded_insert_and_maintain_auto``; this rank's state after each."""
    from repro_torch.dist import graph as dg

    torch.set_num_threads(1)
    src, dst, base_w, a0 = base
    g = tst.device_graph_from_coo(N, src, dst, base_w, a=a0, n_capacity=V_CAP,
                                  e_capacity=E_CAP, device="cpu")
    state = dg.init_sharded_state(dg.shard_graph(g, mesh), mesh, eps=EPS)
    slots = torch.arange(E_CAP, dtype=torch.int32)
    out = []
    for tick in replay[:-1]:
        bs, bd, w, valid = (torch.from_numpy(x) for x in tick[:4])
        drop = (slots >= m_base) & (slots < m_base + tick[4])
        state = dg.sharded_slide_and_maintain(state, drop, bs, bd, w, valid, mesh, eps=EPS,
                                              max_rounds=MAX_ROUNDS)
        out.append(state_to_numpy(state))
    state, _ = dg.sharded_insert_and_maintain_auto(
        state, *(torch.from_numpy(x) for x in replay[-1]), mesh, eps=EPS,
        max_rounds=MAX_ROUNDS, min_bucket=4)
    out.append(state_to_numpy(state))
    return out


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 12 at small sizes on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_stream():
    return make_transaction_stream(n=600, m=3000, seed=3)


@pytest.mark.parametrize("semantics,integer,batch", [
    ("DG", True, 64), ("XPARITY", True, 64), ("DW", False, 64), ("FD", False, 16)])
def test_phase12a_insert_ticks_on_cpu(small_stream, semantics, integer, batch):
    from repro_torch.core.semantics import resolve

    sem = chip_smoke.parity_semantics() if semantics == "XPARITY" else resolve(semantics)
    stream = chip_smoke.integer_amounts(small_stream) if integer else small_stream
    rec = chip_smoke.cross_plane_ticks(sem, stream, 6, batch, "cpu", EPS, MAX_ROUNDS,
                                       integer=integer, tag=f"12a {semantics}")
    assert rec["ticks"] == 6 and rec["deletions"] == 0
    assert rec["live_edges"] == stream.base_src.shape[0] + 6 * batch
    errs = rec["max_rel_err"]
    if integer:
        assert errs == {"weights": 0.0, "edges": 0.0, "w0": 0.0}
    else:
        assert errs["weights"] <= chip_smoke.CROSS_RTOL_W
        assert errs["w0"] <= chip_smoke.CROSS_RTOL_ACC


@pytest.mark.parametrize("semantics", ["DG", "XPARITY"])
def test_phase12b_window_ticks_on_cpu(small_stream, semantics):
    from repro_torch.core.semantics import resolve

    sem = chip_smoke.parity_semantics() if semantics == "XPARITY" else resolve(semantics)
    stream = chip_smoke.integer_amounts(small_stream)
    rec = chip_smoke.cross_plane_ticks(sem, stream, 5, 6, "cpu", EPS, MAX_ROUNDS,
                                       window=2, tag=f"12b {semantics}")
    assert rec["deletions"] == 3 * 6
    assert rec["live_edges"] == stream.base_src.shape[0] + 2 * 6


def test_phase12_check_catches_a_wrong_weight(small_stream):
    """The harness fails on a device weight the host funnel does not give:
    a semantics whose torch hook adds 2^-20 on the lanes with src % 7 == 0,
    which its numpy hook does not."""
    def esusp(xp, src, dst, raw, deg, aux):
        if isinstance(raw, np.ndarray):
            return np.ones_like(raw)
        return xp.ones_like(raw) + (src % 7 == 0) * 2.0 ** -20

    sem = SuspSemantics(name="XBAD", esusp=esusp)
    with pytest.raises(SystemExit, match="batch weights: not bit-identical"):
        chip_smoke.cross_plane_ticks(sem, small_stream, 2, 64, "cpu", EPS, MAX_ROUNDS,
                                     tag="bad")


@pytest.mark.parametrize("tied", [False, True], ids=["int", "tied"])
def test_phase12c_exact_peel_on_cpu(tied):
    rec = chip_smoke.exact_peel_check(300, 1500, 6, "cpu", tied)
    assert rec["n_capacity"] == 512 and rec["tied_neighbours"] > 0


def test_phase12_runs_its_comparisons_at_once(monkeypatch):
    """``phase_cross_plane`` at small sizes on the CPU: its eight
    comparisons, each in a spawned process of its own, come back as the
    records the phase logs, in its order; the plain versions launch no
    kernel."""
    for name, value in (("DEVICE", "cpu"), ("EPS", EPS), ("MAX_ROUNDS", MAX_ROUNDS),
                        ("CROSS_INSERT", {"n": 600, "m": 3000, "batch": 64, "fd_batch": 16,
                                          "ticks": 3, "seed": 3}),
                        ("CROSS_WINDOW", {"n": 300, "m": 1500, "batch": 4, "ticks": 4,
                                          "window": 2, "seed": 5}),
                        ("CROSS_EXACT", {"n": 300, "m": 1500, "seed": 6})):
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_cross_plane("cpu")
    assert [r["semantics"] for r in out["insert"]] == ["DG", "XPARITY", "DW", "FD"]
    assert [(r["ticks"], r["batch"]) for r in out["insert"]] == [(3, 64)] * 3 + [(3, 16)]
    assert [r["semantics"] for r in out["window"]] == ["DG", "XPARITY"]
    assert all(r["window"] == 2 and r["deletions"] > 0 for r in out["window"])
    assert [r["n_capacity"] for r in out["exact"]] == [512, 512]
    assert out["launches"] == {"peel_round": 0, "frontier_spmv": 0, "suffix_init": 0}
