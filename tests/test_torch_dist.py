"""The port's edge-sharded engine (``repro_torch.dist``) under ``gloo`` on
the CPU, at world 2 and world 4.

Each world is one :func:`repro_torch.dist.spawn` whose ranks run every case
(``_cases`` over the sharded port); the same cases then run here through
the port's single-device engine, ``repro.dist.graph``'s sharded engine on
a ``jax.sharding.Mesh`` of as many host devices (conftest forces 8), and
``repro``'s single-device engine.  The cases mirror
``tests/test_dist.py``'s graph tests: ``shard_graph`` pads and places, bulk
peels over three seeds, the ``max_rounds`` cutoff, incremental inserts and
a refresh, deletions, workset ticks (auto and predictive, a slide among
them), the divisibility error, and the sharded service (windowed DG,
DW with refreshes detecting the planted fraud, windowed FD).

On integer weights every engine's ``level``, ``best_g``, ``best_level``,
``community``, ``w0`` and ``edge_count`` are bit-identical to the port's
sharded state on every rank, and so are the edge buffers, the ranks'
blocks joined slot for slot.  On lognormal (DW-like) weights and under DW
and FD the ranks add their float64 sums in another order before the one
rounding: ``w0`` and ``best_g`` within ``RTOL``, the edge layout exact.

Spawned ranks import this file for its rank functions only: the ``if``
below keeps ``jax`` and ``repro`` out of them.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.convert import state_to_numpy
from repro_torch.dist import spawn

if multiprocessing.parent_process() is None:  # not in a spawned rank
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.core import incremental as ji
    from repro.core import peel as jp
    from repro.dist import graph as jdg
    from repro.graphstore import structs as jst
    from repro.graphstore.generators import make_transaction_stream as jstream
    from repro.serve import SpadeService as JaxService

N = 200
EPS = 0.1
# lognormal weights and DW/FD: float64 sums of the ranks added in another
# order, rounded once to float32 (a float32 ulp or two)
RTOL = 1e-5
STATE = ("level", "best_g", "community", "edge_count", "w0")
EDGES = ("src", "dst", "c", "edge_mask")
PEEL = ("level", "best_g", "best_level", "n_rounds")
# the service cases (stream kwargs, semantics, service kwargs)
SERVICES = {
    "DG-window": ({"n": 800, "m": 4000, "seed": 13}, "DG",
                  {"batch_edges": 128, "max_rounds": 10, "window_ticks": 3}),
    "DW-refresh": ({"n": 1000, "m": 5000, "seed": 11}, "DW",
                   {"batch_edges": 256, "max_rounds": 10, "refresh_every": 2}),
    "FD-window-workset": ({"n": 800, "m": 4000, "seed": 13}, "FD",
                          {"batch_edges": 128, "max_rounds": 10, "window_ticks": 3,
                           "workset": True}),
}


def _graph(seed: int, integer: bool = True, e_slack: int = 512, e_mod: int | None = None):
    """COO arrays of a random graph (``tests/test_dist.py``'s): integer
    weights give order-independent float32 sums.  ``e_mod``: pad the
    capacity to 1 modulo it (not divisible by 2 or 4)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 900)
    dst = rng.integers(0, N, 900)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if integer:
        c = rng.integers(1, 6, src.shape[0]).astype(np.float32)
        a = rng.integers(0, 3, N).astype(np.float32)
    else:
        c = rng.lognormal(0.0, 1.0, src.shape[0]).astype(np.float32)
        a = rng.lognormal(-1.0, 1.0, N).astype(np.float32)
    e_cap = src.shape[0] + e_slack
    if e_mod:
        e_cap += (1 - e_cap) % e_mod
    return src, dst, c, a, e_cap


def _batch(rng, B: int, pool, integer: bool = True):
    bs = rng.choice(pool, B).astype(np.int32)
    bd = rng.choice(pool, B).astype(np.int32)
    bc = (rng.integers(1, 4, B) if integer else rng.lognormal(0.0, 1.0, B)).astype(np.float32)
    return bs, bd, bc, bs != bd


# ---------------------------------------------------------------------------
# the engines, behind one interface: numpy in, numpy out
# ---------------------------------------------------------------------------


class _Port:
    """The port's single-device engine on the CPU."""

    def __init__(self):
        from repro_torch.core import incremental, peel
        from repro_torch.graphstore import structs

        self.inc, self.peel, self.structs = incremental, peel, structs

    def graph(self, src, dst, c, a, e_cap):
        return self.structs.device_graph_from_coo(N, src, dst, c, a, e_capacity=e_cap,
                                                  device="cpu")

    def t(self, *xs):
        return [torch.from_numpy(np.asarray(x)) for x in xs]

    def e_capacity(self, g):
        return g.e_capacity

    def e_bucket_capacity(self, g):
        return g.e_capacity

    def peel_weights(self, g):
        return g.peel_weights().numpy()

    def bulk_peel(self, g, max_rounds=0):
        r = self.peel.bulk_peel(g, eps=EPS, max_rounds=max_rounds)
        return _peel_numpy(r.level, r.best_g, r.best_level, r.n_rounds)

    def init(self, g):
        return self.inc.init_state(g, eps=EPS)

    def insert(self, st, b):
        return self.inc.insert_and_maintain(st, *self.t(*b), eps=EPS)

    def delete(self, st, drop):
        return self.inc.delete_and_maintain(st, *self.t(drop), eps=EPS)

    def insert_auto(self, st, b):
        return self.inc.insert_and_maintain_auto(st, *self.t(*b), eps=EPS, min_bucket=8)

    def slide_auto(self, st, drop, b):
        return self.inc.slide_and_maintain_auto(st, *self.t(drop, *b), eps=EPS, min_bucket=8)

    def predictor(self, st):
        return self.inc.BucketPredictor(st.graph.n_capacity, self.e_bucket_capacity(st.graph),
                                        min_bucket=8)

    def insert_pred(self, st, b, pr):
        return self.inc.insert_and_maintain_predictive(st, *self.t(*b), pr, eps=EPS)

    def slide_pred(self, st, drop, b, pr):
        return self.inc.slide_and_maintain_predictive(st, *self.t(drop, *b), pr,
                                                      n_dropped=None, eps=EPS)

    def refresh(self, st):
        return self.inc.full_refresh(st, eps=EPS)

    def state(self, st):
        return state_to_numpy(st)

    def service(self, stream_kw, sem, kw):
        from repro_torch.graphstore.generators import make_transaction_stream
        from repro_torch.serve import SpadeService

        svc = SpadeService(sem, device="cpu", mesh=getattr(self, "mesh", None), **kw)
        rep = svc.run(make_transaction_stream(**stream_kw))
        return _report(rep), state_to_numpy(svc.final_state)


class _PortSharded(_Port):
    """The port's edge-sharded engine: this rank's part of the result."""

    def __init__(self, mesh):
        super().__init__()
        from repro_torch.dist import graph as dg

        self.dg, self.mesh = dg, mesh

    def graph(self, src, dst, c, a, e_cap):
        return self.dg.shard_graph(super().graph(src, dst, c, a, e_cap), self.mesh)

    def e_bucket_capacity(self, g):
        return g.e_local

    def peel_weights(self, g):
        return self.dg.sharded_peel_weights(g, self.mesh).numpy()

    def bulk_peel(self, g, max_rounds=0):
        r = self.dg.sharded_bulk_peel(g, self.mesh, eps=EPS, max_rounds=max_rounds)
        return _peel_numpy(r.level, r.best_g, r.best_level, r.n_rounds)

    def init(self, g):
        return self.dg.init_sharded_state(g, self.mesh, eps=EPS)

    def insert(self, st, b):
        return self.dg.sharded_insert_and_maintain(st, *self.t(*b), self.mesh, eps=EPS)

    def delete(self, st, drop):
        return self.dg.sharded_delete_and_maintain(st, *self.t(drop), self.mesh, eps=EPS)

    def insert_auto(self, st, b):
        return self.dg.sharded_insert_and_maintain_auto(st, *self.t(*b), self.mesh, eps=EPS,
                                                        min_bucket=8)

    def slide_auto(self, st, drop, b):
        return self.dg.sharded_slide_and_maintain_auto(st, *self.t(drop, *b), self.mesh,
                                                       eps=EPS, min_bucket=8)

    def insert_pred(self, st, b, pr):
        return self.dg.sharded_insert_and_maintain_predictive(st, *self.t(*b), pr, self.mesh,
                                                              eps=EPS)

    def slide_pred(self, st, drop, b, pr):
        return self.dg.sharded_slide_and_maintain_predictive(st, *self.t(drop, *b), pr,
                                                             self.mesh, eps=EPS)

    def refresh(self, st):
        return self.dg.sharded_full_refresh(st, self.mesh, eps=EPS)


class _Jax(_Port):
    """``repro``'s single-device engine (donating: no state is reused)."""

    def __init__(self):
        self.inc, self.peel = ji, jp

    def graph(self, src, dst, c, a, e_cap):
        return jst.device_graph_from_coo(N, src, dst, c, a, e_capacity=e_cap)

    def t(self, *xs):
        return [jnp.asarray(x) for x in xs]

    def peel_weights(self, g):
        return np.asarray(g.peel_weights())

    def state(self, st):
        out = {f: np.asarray(getattr(st, f)) for f in STATE}
        out.update({f: np.asarray(getattr(st.graph, f)) for f in EDGES})
        return out

    def service(self, stream_kw, sem, kw):
        svc = JaxService(sem, mesh=getattr(self, "mesh", None), **kw)
        return _report(svc.run(jstream(**stream_kw))), None


class _JaxSharded(_Jax):
    """``repro.dist.graph``'s sharded engine on a ``Mesh`` of host devices."""

    def __init__(self, world):
        super().__init__()
        self.mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
        self.world = world

    def graph(self, src, dst, c, a, e_cap):
        return jdg.shard_graph(super().graph(src, dst, c, a, e_cap), self.mesh)

    def e_bucket_capacity(self, g):
        return g.e_capacity // self.world

    def peel_weights(self, g):
        return np.asarray(jdg.sharded_peel_weights(g, self.mesh))

    def bulk_peel(self, g, max_rounds=0):
        r = jdg.sharded_bulk_peel(g, self.mesh, eps=EPS, max_rounds=max_rounds)
        return _peel_numpy(r.level, r.best_g, r.best_level, r.n_rounds)

    def init(self, g):
        return jdg.init_sharded_state(g, self.mesh, eps=EPS)

    def insert(self, st, b):
        return jdg.sharded_insert_and_maintain(st, *self.t(*b), mesh=self.mesh, eps=EPS)

    def delete(self, st, drop):
        return jdg.sharded_delete_and_maintain(st, *self.t(drop), mesh=self.mesh, eps=EPS)

    def insert_auto(self, st, b):
        return jdg.sharded_insert_and_maintain_auto(st, *self.t(*b), mesh=self.mesh, eps=EPS,
                                                    min_bucket=8)

    def slide_auto(self, st, drop, b):
        return jdg.sharded_slide_and_maintain_auto(st, *self.t(drop, *b), mesh=self.mesh,
                                                   eps=EPS, min_bucket=8)

    def insert_pred(self, st, b, pr):
        return jdg.sharded_insert_and_maintain_predictive(st, *self.t(*b), pr, mesh=self.mesh,
                                                          eps=EPS)

    def slide_pred(self, st, drop, b, pr):
        return jdg.sharded_slide_and_maintain_predictive(st, *self.t(drop, *b), pr,
                                                         mesh=self.mesh, eps=EPS)

    def refresh(self, st):
        return jdg.sharded_full_refresh(st, mesh=self.mesh, eps=EPS)


def _peel_numpy(level, best_g, best_level, n_rounds) -> dict:
    return {"level": np.asarray(level), "best_g": np.asarray(best_g),
            "best_level": np.asarray(best_level), "n_rounds": np.asarray(n_rounds)}


def _report(rep) -> dict:
    return {f: getattr(rep, f) for f in ("final_g", "fraud_recall", "live_edges",
                                         "n_expired_edges", "n_ticks", "n_refreshes")}


# ---------------------------------------------------------------------------
# the cases, run by every engine
# ---------------------------------------------------------------------------


def _cases(eng, services=SERVICES) -> dict:
    out = {}
    # shard_graph pads and places; the static peel's weights
    src, dst, c, a, e_cap = _graph(0, e_mod=4)
    g = eng.graph(src, dst, c, a, e_cap)
    out["shard"] = {"e_capacity": eng.e_capacity(g), "w0": eng.peel_weights(g),
                    **{f: np.asarray(getattr(g, f)) for f in EDGES}}
    for seed in range(3):
        out[f"peel{seed}"] = eng.bulk_peel(eng.graph(*_graph(seed)))
    out["cutoff"] = eng.bulk_peel(eng.graph(*_graph(3)), max_rounds=3)

    # incremental inserts, then a full refresh
    rng = np.random.default_rng(2)
    st = eng.init(eng.graph(*_graph(1)))
    states = []
    for _ in range(4):
        st = eng.insert(st, _batch(rng, 64, np.arange(N)))
        states.append(eng.state(st))
    states.append(eng.state(eng.refresh(st)))
    out["insert"] = states

    # interleaved inserts and slot-range deletions
    rng = np.random.default_rng(6)
    st = eng.init(eng.graph(*_graph(5)))
    states = []
    for _ in range(4):
        st = eng.insert(st, _batch(rng, 64, np.arange(N)))
        lo = int(rng.integers(0, 300))
        hi = lo + int(rng.integers(1, 80))
        ids = np.arange(eng.e_capacity(st.graph))
        st = eng.delete(st, (ids >= lo) & (ids < hi))
        states.append(eng.state(st))
    out["delete"] = states

    # workset ticks, hot (the suffix's top vertices) and cold, one slide;
    # the synced (auto) and the predictive dispatchers
    for name in ("auto", "predictive"):
        rng = np.random.default_rng(8)
        st = eng.init(eng.graph(*_graph(7)))
        level = np.asarray(st.level)
        hot = np.argsort(np.where(np.arange(level.shape[0]) < N, level, -1))[-24:]
        pr = eng.predictor(st)
        states, infos = [], []
        for step in range(5):
            b = _batch(rng, 16, hot if step % 2 == 0 else np.arange(N))
            if step >= 3:
                drop = np.arange(eng.e_capacity(st.graph)) < 3 + step
                st, info = (eng.slide_auto(st, drop, b) if name == "auto"
                            else eng.slide_pred(st, drop, b, pr))
            else:
                st, info = (eng.insert_auto(st, b) if name == "auto"
                            else eng.insert_pred(st, b, pr))
            states.append(eng.state(st))
            infos.append((info.n_suffix_vertices, info.fallback))
        out[f"workset-{name}"] = {"states": states, "infos": infos}

    # lognormal weights: inserts and a deletion
    rng = np.random.default_rng(10)
    st = eng.init(eng.graph(*_graph(9, integer=False)))
    states = []
    for step in range(4):
        if step == 3:
            ids = np.arange(eng.e_capacity(st.graph))
            st = eng.delete(st, (ids >= 40) & (ids < 90))
        else:
            st = eng.insert(st, _batch(rng, 64, np.arange(N), integer=False))
        states.append(eng.state(st))
    out["lognormal"] = states

    out["service"] = {k: eng.service(*v) for k, v in services.items()}
    return out


def _rank_cases(mesh) -> dict:
    """A rank's run of every case through the sharded port, and the
    divisibility error."""
    torch.set_num_threads(1)
    eng = _PortSharded(mesh)
    out = _cases(eng)
    src, dst, c, a, e_cap = _graph(4, e_mod=4)
    try:
        eng.dg.sharded_bulk_peel(_Port().graph(src, dst, c, a, e_cap), mesh)
        out["divisible"] = None
    except ValueError as e:
        out["divisible"] = str(e)
    try:
        eng.dg.sharded_bulk_peel(eng.graph(src, dst, c, a, e_cap), object())
        out["mesh_type"] = None
    except TypeError as e:
        out["mesh_type"] = str(e)
    out["rank"] = mesh.get_local_rank("data")
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def results():
    """Every engine's results, computed at once: the two spawns' ranks in
    their processes while this process runs ``repro``'s engines (whose
    compiles are the file's largest cost) and the port's single-device
    engine in threads.  ``repro``'s sharded services run DW and FD at world
    2 only, DG at both."""
    torch.set_num_threads(1)
    with ThreadPoolExecutor(6) as pool:
        futures = {
            **{("ranks", n): pool.submit(spawn, _rank_cases, n, backend="gloo", device="cpu",
                                         timeout=300) for n in (2, 4)},
            ("jax-sharded", 2): pool.submit(_cases, _JaxSharded(2)),
            ("jax-sharded", 4): pool.submit(_cases, _JaxSharded(4),
                                            {"DG-window": SERVICES["DG-window"]}),
            "port": pool.submit(_cases, _Port()),
            "jax": pool.submit(_cases, _Jax()),
        }
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(params=[2, 4], ids=["world2", "world4"])
def world(request, results):
    """(world, the ranks' results, the other engines' results)."""
    n = request.param
    return n, results[("ranks", n)], {"port": results["port"], "jax": results["jax"],
                                      "jax-sharded": results[("jax-sharded", n)]}


def _joined(ranks_states: list[dict], E: int) -> dict:
    out = dict(ranks_states[0])
    for f in EDGES:
        out[f] = np.concatenate([r[f] for r in ranks_states])[:E]
    return out


def _same(got: dict, want: dict, fields, tag: str) -> None:
    for f in fields:
        np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(want[f]),
                                      err_msg=f"{tag}: {f}")


def _close_states(got: dict, want: dict, tag: str) -> None:
    """Float weights: the layout exact, ``w0`` and ``best_g`` within RTOL."""
    _same(got, want, EDGES + ("edge_count",), tag)
    for f in ("w0", "best_g"):
        np.testing.assert_allclose(got[f], want[f], rtol=RTOL, atol=RTOL, err_msg=f"{tag}: {f}")


def _each_rank_and_engine(world, case):
    n, ranks, others = world
    for r in ranks[1:]:  # replicated results: the same on every rank
        got, want = r[case], ranks[0][case]
        yield "rank", got, want
    for name, res in others.items():
        yield name, ranks, res[case]


def test_ranks_report_their_rank(world):
    n, ranks, _ = world
    assert [r["rank"] for r in ranks] == list(range(n))


def test_shard_graph_pads_and_places(world):
    """Each rank holds e_capacity / world slots (padded up to a multiple);
    the blocks joined are the single-device buffers, then inert pads; the
    static peel's weights are everyone's."""
    n, ranks, others = world
    want = others["port"]["shard"]
    E = want["e_capacity"]
    assert E % n == 1  # e_mod: not divisible by the world
    got = [r["shard"] for r in ranks]
    e_pad = got[0]["e_capacity"]
    assert e_pad % n == 0 and E < e_pad < E + n
    assert all(g["src"].shape[0] == e_pad // n for g in got)
    joined = {f: np.concatenate([g[f] for g in got]) for f in EDGES}
    for f in EDGES:
        np.testing.assert_array_equal(joined[f][:E], want[f], err_msg=f)
    assert (joined["src"][E:] == N - 1).all() and not joined["edge_mask"][E:].any()
    assert (joined["c"][E:] == 0).all()
    for g in got:
        np.testing.assert_array_equal(g["w0"], want["w0"])
    np.testing.assert_array_equal(got[0]["w0"], others["jax-sharded"]["shard"]["w0"])
    np.testing.assert_array_equal(got[0]["w0"], others["jax"]["shard"]["w0"])


@pytest.mark.parametrize("case", ["peel0", "peel1", "peel2", "cutoff"])
def test_sharded_bulk_peel_matches(world, case):
    """Bulk peels to completion over three seeds, and a 3-round cutoff:
    level, best_g, best_level and rounds bit for bit."""
    n, ranks, others = world
    for r in ranks:
        for name, res in others.items():
            _same(r[case], res[case], PEEL, f"world {n} {case} vs {name}")


@pytest.mark.parametrize("case", ["insert", "delete"])
def test_sharded_maintenance_matches(world, case):
    """Streamed inserts (then a full refresh) and interleaved deletions:
    every tick's state, the ranks' blocks joined, bit for bit."""
    n, ranks, others = world
    for name, res in others.items():
        for t, want in enumerate(res[case]):
            E = want["src"].shape[0]
            got = _joined([r[case][t] for r in ranks], E)
            _same(got, want, STATE + EDGES, f"world {n} {case} tick {t} vs {name}")
            for r in ranks[1:]:
                _same(r[case][t], ranks[0][case][t], STATE, f"{case} tick {t} ranks")


@pytest.mark.parametrize("dispatch", ["auto", "predictive"])
def test_sharded_workset_matches(world, dispatch):
    """Workset ticks, hot and cold, a slide among them: the sharded
    engine's per-rank buckets may differ from the single-device engine's,
    the states may not; the suffix sizes are the same; the synced
    dispatcher took the workset path at least once."""
    n, ranks, others = world
    case = f"workset-{dispatch}"
    for name, res in others.items():
        for t, want in enumerate(res[case]["states"]):
            E = want["src"].shape[0]
            got = _joined([r[case]["states"][t] for r in ranks], E)
            _same(got, want, STATE + EDGES, f"world {n} {case} tick {t} vs {name}")
        assert ([i[0] for i in ranks[0][case]["infos"]]
                == [i[0] for i in res[case]["infos"]]), name
    for r in ranks:
        assert r[case]["infos"] == ranks[0][case]["infos"]  # the same buckets on every rank
    if dispatch == "auto":  # the predictor's history holds a cold tick: no hit
        assert not all(fb for _, fb in ranks[0][case]["infos"])


def test_sharded_lognormal_weights_within_rtol(world):
    """Lognormal weights: the layout bit for bit; w0 and best_g within RTOL
    of every engine."""
    n, ranks, others = world
    for name, res in others.items():
        for t, want in enumerate(res["lognormal"]):
            got = _joined([r["lognormal"][t] for r in ranks], want["src"].shape[0])
            _close_states(got, want, f"world {n} lognormal tick {t} vs {name}")


def test_sharded_peel_requires_divisible_capacity_and_a_device_mesh(world):
    _, ranks, _ = world
    for r in ranks:
        assert r["divisible"] is not None and "divisible" in r["divisible"]
        assert r["mesh_type"] is not None and "DeviceMesh" in r["mesh_type"]


def _never_run(mesh):
    raise AssertionError("no rank should start")


def test_spawn_runs_on_cuda_unless_asked(monkeypatch):
    """``spawn`` resolves its device as the port's entry points do: none
    given means ``cuda``, which raises without a GPU before a rank starts;
    ``nccl`` off the card is refused, naming ``gloo``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn(_never_run, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn(_never_run, 2, backend="gloo")
    with pytest.raises(ValueError, match="gloo"):
        spawn(_never_run, 2, backend="nccl", device="cpu")


@pytest.mark.parametrize("case", list(SERVICES))
def test_sharded_service_matches_single_device(world, case):
    """``SpadeService(..., mesh=...)``: every rank's report and state equal;
    DG bit for bit with the port's single-device service (state included)
    and ``repro``'s services; DW and FD within RTOL; the planted fraud
    found under DW with refreshes."""
    n, ranks, others = world
    reports = [r["service"][case][0] for r in ranks]
    assert all(rep == reports[0] for rep in reports)
    for r in ranks[1:]:
        _same(r["service"][case][1], ranks[0]["service"][case][1], STATE, f"{case} ranks")
    got = reports[0]
    for name, res in others.items():
        if case not in res["service"]:
            continue
        want = res["service"][case][0]
        for f in ("live_edges", "n_expired_edges", "n_ticks", "n_refreshes"):
            assert got[f] == want[f], (name, f)
        if case.startswith("DG"):
            assert got == want, name
        else:
            np.testing.assert_allclose(got["final_g"], want["final_g"], rtol=RTOL)
    if case.startswith("DG"):
        want = others["port"]["service"][case][1]
        state = _joined([r["service"][case][1] for r in ranks], want["src"].shape[0])
        _same(state, want, STATE + EDGES, f"{case} state")
    if case.startswith("DW"):
        assert got["fraud_recall"] >= 0.99 and got["n_refreshes"] >= 1
