"""The port's maintenance engines against the JAX reference, tick by tick.

Both packages start from one state (``convert.state_from_numpy`` of the
reference's ``init_state``), replay the same seeded insert / delete /
slide ticks through the fused, auto (synced workset) and predictive
engines, and must stay bit-identical after every tick on integer weights:
``level``, ``best_g``, ``community``, ``edge_count``, ``w0`` and the graph
buffers.  The port's device->host reads per tick are pinned: fused 0,
auto 1, predictive at most 1 (with a fixed round count).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import incremental as ji  # noqa: E402
from repro.graphstore import structs as jst  # noqa: E402
from repro_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import incremental as ti  # noqa: E402
from repro_torch.core import peel as tpeel  # noqa: E402

EPS = 0.1
FLOOR = 8
B = 4
N, V_CAP, E_CAP = 120, 128, 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(seed=77, integer=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 500)
    dst = rng.integers(0, N, 500)
    keep = src != dst
    c = (rng.integers(1, 6, keep.sum()) if integer
         else rng.lognormal(1.0, 1.0, keep.sum())).astype(np.float32)
    a = rng.integers(0, 2, N).astype(np.float32)
    g = jst.device_graph_from_coo(N, src[keep], dst[keep], c, a,
                                  n_capacity=V_CAP, e_capacity=E_CAP)
    return ji.init_state(g, eps=EPS)


def jax_to_numpy(state) -> dict:
    d = {f: np.asarray(getattr(state.graph, f))
         for f in ("src", "dst", "c", "edge_mask", "a", "vertex_mask")}
    d.update({f: np.asarray(getattr(state, f))
              for f in ("level", "best_g", "community", "edge_count", "w0")})
    d["n_capacity"] = state.graph.n_capacity
    d["e_capacity"] = state.graph.e_capacity
    return d


def assert_same(tstate, jstate, tag=""):
    got, want = state_to_numpy(tstate), jax_to_numpy(jstate)
    assert got.keys() == want.keys()
    for k in want:
        x, y = np.asarray(got[k]), np.asarray(want[k])
        assert x.dtype == y.dtype, f"{tag}:{k} {x.dtype} vs {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{tag}:{k}")


def _tick(rng, levels, kind):
    """A batch of B edges (some invalid); endpoints from the top-level
    vertices ("hot", a small suffix) or anywhere ("any")."""
    pool = np.argsort(levels, kind="stable")[-16:] if kind == "hot" else np.arange(N)
    bs = rng.choice(pool, B).astype(np.int32)
    bd = rng.choice(pool, B).astype(np.int32)
    bc = rng.integers(1, 6, B).astype(np.float32)
    valid = (rng.random(B) < 0.85) & (bs != bd)
    return bs, bd, bc, valid


def test_state_round_trips_through_numpy():
    j = _jax_state()
    t = state_from_numpy(jax_to_numpy(j), device="cpu")
    assert_same(t, j)
    # the port's own start-up peel reaches the same state
    t2 = ti.init_state(t.graph, eps=EPS)
    assert_same(t2, j, "init_state")


@pytest.mark.parametrize("max_rounds", [0, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_tick_replay_bit_identical(seed, max_rounds):
    """The window replay of run_window_differential (window of 2 ticks;
    even ticks one fused slide, odd ticks a delete then an insert) through
    the fused, auto and predictive engines of both packages."""
    rng = np.random.default_rng(200 + seed)
    window = 2
    j0 = jax_to_numpy(_jax_state())
    jf = _jax_state()
    ja = _jax_state()
    jp = _jax_state()
    tf, ta, tp = (state_from_numpy(j0, device="cpu") for _ in range(3))
    jpred = ji.BucketPredictor(V_CAP, E_CAP, min_bucket=FLOOR)
    tpred = ti.BucketPredictor(V_CAP, E_CAP, min_bucket=FLOOR)
    m_base = int(j0["edge_count"])
    ring: list[int] = []
    slots = np.arange(E_CAP)
    kw = dict(eps=EPS, max_rounds=max_rounds)
    zi, zf, zv = np.zeros(B, np.int32), np.zeros(B, np.float32), np.zeros(B, bool)
    saw = {"workset": False, "fallback": False}
    for t in range(10):
        n_exp = ring.pop(0) if len(ring) >= window else 0
        drop = (slots >= m_base) & (slots < m_base + n_exp)
        levels = np.asarray(jf.level)[:N]
        bs, bd, bc, valid = _tick(rng, levels, "hot" if t % 3 else "any")
        J = lambda *xs: [jnp.asarray(x) for x in xs]
        T = lambda *xs: [torch.from_numpy(x) for x in xs]
        reads = {}
        if t % 2 == 0:
            jf = ji.slide_and_maintain(jf, *J(drop, bs, bd, bc, valid), **kw)
            ja, _ = ji.slide_and_maintain_auto(ja, *J(drop, bs, bd, bc, valid),
                                               min_bucket=FLOOR, **kw)
            jp, _ = ji.slide_and_maintain_predictive(
                jp, *J(drop, bs, bd, bc, valid), jpred, n_dropped=n_exp, **kw)
            r0 = tpeel.HOST_READS[0]
            tf = ti.slide_and_maintain(tf, *T(drop, bs, bd, bc, valid), **kw)
            reads["fused"] = tpeel.HOST_READS[0] - r0
            r0 = tpeel.HOST_READS[0]
            ta, info = ti.slide_and_maintain_auto(ta, *T(drop, bs, bd, bc, valid),
                                                  min_bucket=FLOOR, **kw)
            reads["auto"] = tpeel.HOST_READS[0] - r0
            r0 = tpeel.HOST_READS[0]
            tp, _ = ti.slide_and_maintain_predictive(
                tp, *T(drop, bs, bd, bc, valid), tpred, n_dropped=n_exp, **kw)
            reads["predictive"] = tpeel.HOST_READS[0] - r0
        else:
            jf = ji.delete_and_maintain(jf, jnp.asarray(drop), **kw)
            jf = ji.insert_and_maintain(jf, *J(bs, bd, bc, valid), **kw)
            ja, _ = ji.slide_and_maintain_auto(ja, *J(drop, zi, zi, zf, zv),
                                               min_bucket=FLOOR, **kw)
            ja, _ = ji.insert_and_maintain_auto(ja, *J(bs, bd, bc, valid),
                                                min_bucket=FLOOR, **kw)
            r0 = tpeel.HOST_READS[0]
            tf = ti.delete_and_maintain(tf, torch.from_numpy(drop), **kw)
            tf = ti.insert_and_maintain(tf, *T(bs, bd, bc, valid), **kw)
            reads["fused"] = tpeel.HOST_READS[0] - r0
            r0 = tpeel.HOST_READS[0]
            ta, _ = ti.slide_and_maintain_auto(ta, *T(drop, zi, zi, zf, zv),
                                               min_bucket=FLOOR, **kw)
            ta, info = ti.insert_and_maintain_auto(ta, *T(bs, bd, bc, valid),
                                                   min_bucket=FLOOR, **kw)
            reads["auto"] = (tpeel.HOST_READS[0] - r0) / 2  # two ticks' calls
            # the predictive engine deletes through the fused path, then
            # inserts with predicted buckets
            jp = ji.delete_and_maintain(jp, jnp.asarray(drop), **kw)
            jp, _ = ji.insert_and_maintain_predictive(jp, *J(bs, bd, bc, valid),
                                                      jpred, **kw)
            tp = ti.delete_and_maintain(tp, torch.from_numpy(drop), **kw)
            r0 = tpeel.HOST_READS[0]
            tp, _ = ti.insert_and_maintain_predictive(tp, *T(bs, bd, bc, valid),
                                                      tpred, **kw)
            reads["predictive"] = tpeel.HOST_READS[0] - r0
        saw["workset" if not info.fallback else "fallback"] = True
        for tag, ts, js in (("fused", tf, jf), ("auto", ta, ja),
                            ("predictive", tp, jp)):
            assert_same(ts, js, f"tick{t}:{tag}")
            assert_same(ts, jf, f"tick{t}:{tag}-vs-fused")
        if max_rounds:
            assert reads["fused"] == 0, reads
            assert reads["auto"] == 1, reads
            assert reads["predictive"] <= 1, reads
        ring.append(int(valid.sum()))
    assert saw["workset"] and saw["fallback"]
    # periodic refresh and the benign test agree too
    assert_same(ti.full_refresh(tf, eps=EPS), ji.full_refresh(jf, eps=EPS),
                "refresh")
    np.testing.assert_array_equal(
        ti.benign_mask(tf, *[torch.from_numpy(x) for x in (bs, bd, bc)]).numpy(),
        np.asarray(ji.benign_mask(jf, *[jnp.asarray(x) for x in (bs, bd, bc)])))


def test_slide_w0_on_float_weights_within_tolerance():
    """On DW-like lognormal weights the port adds a tick's w0 deltas in
    float64 and rounds once, the reference in float32 scatter by scatter:
    w0 after each windowed slide (window of 2 ticks) agrees to rtol 1e-5,
    the final_g tolerance of the DW service tests."""
    rng = np.random.default_rng(300)
    j0 = jax_to_numpy(_jax_state(integer=False))
    js = _jax_state(integer=False)
    ts = state_from_numpy(j0, device="cpu")
    m_base = int(j0["edge_count"])
    ring: list[int] = []
    slots = np.arange(E_CAP)
    for t in range(8):
        n_exp = ring.pop(0) if len(ring) >= 2 else 0
        drop = (slots >= m_base) & (slots < m_base + n_exp)
        bs, bd, _, valid = _tick(rng, np.asarray(js.level)[:N], "any")
        bc = rng.lognormal(1.0, 1.0, B).astype(np.float32)
        js = ji.slide_and_maintain(js, *[jnp.asarray(x) for x in (drop, bs, bd, bc, valid)],
                                   eps=EPS, max_rounds=3)
        ts = ti.slide_and_maintain(ts, *[torch.from_numpy(x) for x in (drop, bs, bd, bc, valid)],
                                   eps=EPS, max_rounds=3)
        np.testing.assert_allclose(ts.w0.numpy(), np.asarray(js.w0), rtol=1e-5, atol=1e-5,
                                   err_msg=f"tick {t}")
        ring.append(int(valid.sum()))


@pytest.mark.parametrize("d_bucket", [0, 32])
def test_slide_w0_lane_with_one_end_out_of_range(d_bucket):
    """A batch lane with one end outside ``[0, V)`` still adds its ``cv``
    at the other end, as the reference's ``.at[end].add(mode="drop")``
    does (an end in ``[-V, 0)`` counts from the end): both packages' tick
    epilogues on the same re-peel of one windowed slide (full-width and
    compacted drops), then ``w0`` and the whole state bit for bit."""
    j0 = jax_to_numpy(_jax_state())
    js = _jax_state()
    ts = state_from_numpy(j0, device="cpu")
    drop = np.arange(E_CAP) < 24
    bs = np.array([3, 5, 7, 9], np.int32)
    bd = np.array([4, 6, 8, 10], np.int32)
    bc = np.array([2, 3, 4, 5], np.float32)
    valid = np.array([True, True, True, False])
    # the epilogue's lanes: dst past V, src past V, dst -1 (vertex V-1), dst < -V
    far_s = np.array([3, V_CAP + 5, 7, 9], np.int32)
    far_d = np.array([V_CAP, 6, -1, -V_CAP - 1], np.int32)
    far_valid = np.ones(B, bool)
    J = lambda *xs: [jnp.asarray(x) for x in xs]
    T = lambda *xs: [torch.from_numpy(x) for x in xs]

    out = []
    for mod, arr, st in ((ji, J, js), (ti, T, ts)):
        d, s, dd, c, v = arr(drop, bs, bd, bc, valid)
        bk = mod._slide_prologue(st, d, s, dd, v)
        g, n_removed = mod.remove_edges(st.graph, d)
        g = mod.append_edges(g, st.edge_count - n_removed, s, dd, c, valid=v)
        res = mod.bulk_peel_warm(g, bk.keep, prior_best_g=bk.prior_g, eps=EPS,
                                 max_rounds=3)
        out.append(mod._slide_epilogue(st, g, res, bk, n_removed,
                                       *arr(far_s, far_d, bc, far_valid),
                                       d_bucket=d_bucket))
    jn, tn = out
    assert_same(tn, jn, f"d_bucket={d_bucket}")
    w_before = j0["w0"]
    assert np.asarray(jn.w0)[V_CAP - 1] != w_before[V_CAP - 1]  # -1 wrapped and landed


def test_predictive_hit_miss_fallback_matches_reference():
    """The predictive engine through the synced first tick, predicted
    workset hits, a bucket miss (the suffix outgrows the prediction) and
    re-anchoring, against the reference's predictive engine."""
    j0 = jax_to_numpy(_jax_state())
    jp = _jax_state()
    tp = state_from_numpy(j0, device="cpu")
    jpred = ji.BucketPredictor(V_CAP, E_CAP, min_bucket=FLOOR)
    tpred = ti.BucketPredictor(V_CAP, E_CAP, min_bucket=FLOOR)
    lv = np.where(j0["vertex_mask"], j0["level"], -1)
    hot = np.argsort(lv, kind="stable")[-8:]
    cold = np.argsort(np.where(j0["vertex_mask"], j0["level"], 99), kind="stable")[:8]
    infos = []
    for t, ids in enumerate([hot, hot, cold, hot, hot]):
        bs, bd = ids[:4].astype(np.int32), ids[4:].astype(np.int32)
        bc = np.full(4, float(t + 1), np.float32)
        valid = bs != bd
        jp, jinfo = ji.insert_and_maintain_predictive(
            jp, *[jnp.asarray(x) for x in (bs, bd, bc, valid)], jpred, eps=EPS,
            max_rounds=20)
        r0 = tpeel.HOST_READS[0]
        tp, tinfo = ti.insert_and_maintain_predictive(
            tp, *[torch.from_numpy(x) for x in (bs, bd, bc, valid)], tpred,
            eps=EPS, max_rounds=20)
        assert tpeel.HOST_READS[0] - r0 == 1
        assert tuple(tinfo) == tuple(jinfo), (t, tinfo, jinfo)
        assert_same(tp, jp, f"pred-tick{t}")
        infos.append(tinfo)
    assert any(i.predicted and not i.fallback for i in infos)
    assert any(i.miss for i in infos)


def test_admit_vertices_and_level_arithmetic():
    """Admitted vertices take level INT32_MAX; the r0 clamp at 2^30 keeps
    the rebased levels inside int32; out-of-capacity ids are dropped."""
    j0 = jax_to_numpy(_jax_state())
    jst_ = _jax_state()
    tst_ = state_from_numpy(j0, device="cpu")
    ids = np.array([N, N + 3, V_CAP + 5], np.int32)  # last one out of range
    a = np.array([1.0, 2.0, 3.0], np.float32)
    jst_ = ji.admit_vertices(jst_, jnp.asarray(ids), jnp.asarray(a))
    tst_ = ti.admit_vertices(tst_, torch.from_numpy(ids), torch.from_numpy(a))
    assert_same(tst_, jst_, "admit")
    assert int(tst_.level[N]) == 2**31 - 1
    bs = np.array([N, N + 3, 0, 0], np.int32)
    bd = np.array([N + 3, N, 0, 0], np.int32)
    bc = np.array([5.0, 4.0, 0.0, 0.0], np.float32)
    valid = np.array([True, True, False, False])
    jst_ = ji.insert_and_maintain(jst_, *[jnp.asarray(x) for x in (bs, bd, bc, valid)],
                                  eps=EPS, max_rounds=20)
    tst_ = ti.insert_and_maintain(tst_, *[torch.from_numpy(x) for x in (bs, bd, bc, valid)],
                                  eps=EPS, max_rounds=20)
    assert_same(tst_, jst_, "admit-insert")
    assert tst_.level.dtype == torch.int32
    assert int(tst_.level.max()) <= 2**31 - 1
