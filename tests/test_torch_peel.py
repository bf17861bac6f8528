"""The port's bulk, warm and workset peels (CPU: the kernels' plain
versions) against the JAX reference, bit-identical on integer weights:
``level``, ``best_g``, ``best_level`` and ``n_rounds``, plus the host
reads each peel makes."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import peel as jpeel  # noqa: E402
from repro.graphstore import structs as jst  # noqa: E402
from repro_torch.core import peel as tpeel  # noqa: E402
from repro_torch.graphstore import structs as tst  # noqa: E402

EPS = 0.1
FLOOR = 8  # tiny bucket floor so the boundaries are cheap to cross


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graphs(seed=77, n=120, m=500, V=128, E=1024, with_a=False):
    """The integer-weight graph of test_window_differential's boundary
    cases, built in both packages."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    c = rng.integers(1, 6, keep.sum()).astype(np.float32)
    a = rng.integers(0, 3, n).astype(np.float32) if with_a else None
    args = (n, src[keep], dst[keep], c, a)
    return (jst.device_graph_from_coo(*args, n_capacity=V, e_capacity=E),
            tst.device_graph_from_coo(*args, n_capacity=V, e_capacity=E,
                                      device="cpu"))


def assert_peel_equal(t, j, tag=""):
    np.testing.assert_array_equal(t.level.numpy(), np.asarray(j.level),
                                  err_msg=f"{tag}:level")
    for f in ("best_g", "best_level", "n_rounds"):
        x, y = getattr(t, f), np.asarray(getattr(j, f))
        assert x.numpy().dtype == y.dtype, f"{tag}:{f}"
        assert x.item() == y.item(), f"{tag}:{f} {x.item()} != {y.item()}"


@pytest.mark.parametrize("max_rounds", [0, 3, 20])
@pytest.mark.parametrize("seed,with_a", [(77, False), (5, True)])
def test_bulk_peel_bit_identical(seed, with_a, max_rounds):
    jg, tg = _graphs(seed, with_a=with_a)
    j = jpeel.bulk_peel(jg, eps=EPS, max_rounds=max_rounds)
    reads = tpeel.HOST_READS[0]
    t = tpeel.bulk_peel(tg, eps=EPS, max_rounds=max_rounds)
    assert_peel_equal(t, j)
    np.testing.assert_array_equal(t.delta.numpy(), np.asarray(j.delta))
    # fixed-count mode reads nothing; run-to-completion reads n_act once
    # per round plus the final check
    expect = 0 if max_rounds else int(t.n_rounds) + 1
    assert tpeel.HOST_READS[0] - reads == expect


@pytest.mark.parametrize("max_rounds", [0, 3])
def test_peels_leave_the_graph_untouched(max_rounds):
    """The round's edge kernel clears liveness in place, so every peel
    works on a liveness tensor of its own, its prologue's fresh ``both``
    (for ``bulk_peel`` a copy of ``g.edge_mask``).  The graph's arrays are
    the same bits afterwards, and a second peel of the same graph gives
    the same result."""
    _, tg = _graphs(5, with_a=True)
    before = {f: getattr(tg, f).clone() for f in ("src", "dst", "c", "edge_mask", "a",
                                                   "vertex_mask")}
    first = tpeel.bulk_peel(tg, eps=EPS, max_rounds=max_rounds)
    keep = first.level >= 1
    tpeel.bulk_peel_warm(tg, keep, prior_best_g=first.best_g, eps=EPS,
                         max_rounds=max_rounds)
    again = tpeel.bulk_peel(tg, eps=EPS, max_rounds=max_rounds)
    for f, t in before.items():
        assert torch.equal(getattr(tg, f), t), f
    for f in ("level", "best_g", "best_level", "n_rounds", "delta"):
        assert torch.equal(getattr(first, f), getattr(again, f)), f


@pytest.mark.parametrize("max_rounds", [0, 3])
@pytest.mark.parametrize("cut", [1, 2, 4])
def test_bulk_peel_warm_bit_identical(cut, max_rounds):
    jg, tg = _graphs(5, with_a=True)
    res = jpeel.bulk_peel(jg, eps=EPS)
    keep = np.asarray(res.level) >= cut
    j = jpeel.bulk_peel_warm(jg, jnp.asarray(keep), prior_best_g=res.best_g,
                             eps=EPS, max_rounds=max_rounds)
    t = tpeel.bulk_peel_warm(tg, torch.from_numpy(keep),
                             prior_best_g=torch.tensor(float(res.best_g)),
                             eps=EPS, max_rounds=max_rounds)
    assert_peel_equal(t, j)


@pytest.mark.parametrize("max_rounds", [0, 3])
@pytest.mark.parametrize("kn", [0, 1, FLOOR - 1, FLOOR, FLOOR + 1, 40])
def test_workset_bucket_boundaries(kn, max_rounds):
    """Suffix sizes straddling a bucket boundary (the cases of
    test_window_differential.py): the port's workset warm peel equals the
    reference's workset peel and the full-buffer warm peel of both."""
    jg, tg = _graphs()
    res0 = jpeel.bulk_peel(jg, eps=EPS)
    lv = np.where(np.asarray(jg.vertex_mask), np.asarray(res0.level), -1)
    top = np.argsort(lv, kind="stable")[-kn:] if kn else np.empty(0, np.int64)
    keep = np.zeros(jg.n_capacity, bool)
    keep[top] = True
    jkeep, tkeep = jnp.asarray(keep), torch.from_numpy(keep)
    jnv, jne = jpeel.workset_sizes(jg, jkeep)
    tnv, tne = tpeel.workset_sizes(tg, tkeep)
    assert (int(tnv), int(tne)) == (int(jnv), int(jne))
    bv = tpeel.select_bucket(int(tnv), tg.n_capacity, floor=FLOOR)
    be = tpeel.select_bucket(int(tne), tg.e_capacity, floor=FLOOR)
    assert (bv, be) == (jpeel.select_bucket(int(jnv), jg.n_capacity, floor=FLOOR),
                        jpeel.select_bucket(int(jne), jg.e_capacity, floor=FLOOR))
    prior = torch.tensor(float(res0.best_g))
    kw = dict(eps=EPS, max_rounds=max_rounds)
    jws = jpeel.bulk_peel_warm_workset(jg, jkeep, prior_best_g=res0.best_g,
                                       v_bucket=bv, e_bucket=be, **kw)
    tws = tpeel.bulk_peel_warm_workset(tg, tkeep, prior_best_g=prior,
                                       v_bucket=bv, e_bucket=be, **kw)
    tfull = tpeel.bulk_peel_warm(tg, tkeep, prior_best_g=prior, **kw)
    assert_peel_equal(tws, jws, "workset")
    assert_peel_equal(tfull, jws, "full")
    np.testing.assert_array_equal(tws.delta.numpy(), np.asarray(jws.delta))


def test_workset_fallback_and_checked_dispatch():
    """A suffix beyond the largest bucket falls back (select_bucket ->
    None); the checked dispatcher takes the workset path on a fit and the
    full-buffer path on a miss, with the same result."""
    jg, tg = _graphs()
    everything = torch.ones(tg.n_capacity, dtype=torch.bool)
    nv, ne = (int(x) for x in tpeel.workset_sizes(tg, everything))
    assert tpeel.select_bucket(nv, tg.n_capacity, floor=FLOOR) is None
    res0 = tpeel.bulk_peel(tg, eps=EPS)
    keep = res0.level >= 2
    nv, ne = (int(x) for x in tpeel.workset_sizes(tg, keep))
    prior = res0.best_g
    outs = []
    for bv, be, fits in ((64, 1024, True), (8, 8, False)):
        res, got = tpeel.bulk_peel_warm_checked(tg, keep, prior, nv, ne, eps=EPS,
                                                max_rounds=3, v_bucket=bv,
                                                e_bucket=be)
        assert got is fits and nv <= 64 and ne <= 1024
        outs.append(res)
    for f in ("level", "best_g", "best_level", "n_rounds"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f


def test_select_bucket_matches_reference_ladder():
    for count in (0, 1, 7, 8, 9, 63, 64, 65, 511, 512, 513, 4096):
        for cap in (64, 1024, 10_000):
            for floor in (8, 64):
                assert (tpeel.select_bucket(count, cap, floor=floor)
                        == jpeel.select_bucket(count, cap, floor=floor))
    with pytest.raises(ValueError):
        tpeel.select_bucket(-1, 1024)
