"""The port's CUDA kernels and engine on the card, against the plain
PyTorch versions on the same inputs.  Marked ``gpu``: each test skips
without a CUDA device (decided inside the ``cuda`` fixture, never at
import).  Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Integer-valued inputs are compared bit for bit; lognormal inputs to rtol
1e-5 on the sums (float atomics and block partials add in another order).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import peel as tpeel  # noqa: E402
from repro_torch.graphstore.generators import make_transaction_stream  # noqa: E402
from repro_torch.kernels.frontier_spmv import frontier_spmv, frontier_spmv_ref  # noqa: E402
from repro_torch.kernels.frontier_spmv import ops as k2_ops  # noqa: E402
from repro_torch.kernels.peel_round import peel_round, peel_round_ref  # noqa: E402
from repro_torch.kernels.peel_round import ops as k1_ops  # noqa: E402
from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.serve import SpadeService  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _assert_close(got, want, exact):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if exact or not g.is_floating_point():
            assert torch.equal(g.cpu(), w.cpu())
        else:
            torch.testing.assert_close(g.cpu(), w.cpu(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("V", [1, 255, 257, 100_000])
def test_peel_round_kernel_matches_plain(cuda, V, integer):
    """K1 against its plain version on the float64 dw that K2 hands the
    round (some entries zero, as after a sparse round); both leave their
    dw all zero."""
    rng = np.random.default_rng(V)
    if integer:
        w, a, dw = (rng.integers(0, k, V).astype(np.float32) for k in (9, 3, 4))
    else:
        w, a, dw = (rng.lognormal(m, 1.0, V).astype(np.float32) for m in (2.0, 0.0, 0.0))
        dw[rng.random(V) < 0.5] = 0.0
    arrs = [torch.from_numpy(x).to(cuda) for x in
            (w, a, rng.random(V) < 0.7, rng.integers(-1, 9, V).astype(np.int32))]
    dw = [torch.from_numpy(dw).to(cuda, torch.float64) for _ in range(2)]
    th = torch.tensor(float(np.median(w)), device=cuda)
    r = torch.tensor(5, dtype=torch.int32, device=cuda)
    n0 = k1_ops.launches
    got = peel_round(*arrs, dw[0], th, r)
    assert k1_ops.launches == n0 + 1
    _assert_close(got, peel_round_ref(*arrs, dw[1], th, r), integer)
    assert not bool(dw[0].any()) and not bool(dw[1].any())


def _k2_edges(rng, V, E, m, pad, integer, alive_p=0.9, peel_p=0.2):
    """K2's inputs on the host: ``m`` real slots, the rest pads of kind
    ``pad`` (full: src = dst = V-1; workset: endpoint 0; c 0, dead)."""
    pad_id = V - 1 if pad == "full" else 0
    src = np.full(E, pad_id, np.int32)
    dst = np.full(E, pad_id, np.int32)
    src[:m], dst[:m] = rng.integers(0, V, m), rng.integers(0, V, m)
    c = np.zeros(E, np.float32)
    c[:m] = rng.integers(1, 6, m) if integer else rng.lognormal(1.0, 1.0, m)
    alive = np.zeros(E, bool)
    alive[:m] = rng.random(m) < alive_p
    peel = rng.random(V) < peel_p
    peel[pad_id] = True  # a peeled pad vertex must stay inert
    return src, dst, c, alive, peel


def _k2_check(arrs, integer):
    """K2 on ``arrs``, updating its ``alive`` in place, against
    the plain version on a copy of it: dw, drop mass and the updated
    liveness.  Returns the kernel's (dw, drop)."""
    src, dst, c, alive, peel = arrs
    plain = alive.clone()
    acc = [torch.zeros(peel.shape[0], dtype=torch.float64, device=peel.device)
           for _ in range(2)]
    got = frontier_spmv(src, dst, c, alive, peel, acc[0])
    want = frontier_spmv_ref(src, dst, c, plain, peel, acc[1])
    assert got[0] is acc[0]  # added into the accumulator it was given
    torch.cuda.synchronize()
    assert torch.equal(alive, plain)  # in place, exactly the plain update
    _assert_close(got, want, integer)
    return got


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("pad", ["full", "workset"])
def test_frontier_spmv_kernel_matches_plain(cuda, pad, integer):
    rng = np.random.default_rng(7)
    arrs = [torch.from_numpy(x).to(cuda)
            for x in _k2_edges(rng, 5000, 65_536, 60_000, pad, integer)]
    n0 = k2_ops.launches
    _k2_check(arrs, integer)
    assert k2_ops.launches == n0 + 1


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("E", [1, 15, 16, 17, 4099, 100_000])
def test_frontier_spmv_kernel_edge_counts(cuda, E, integer):
    """Counts below, at and past one 16-slot group and ragged tails: the
    vector groups and the scalar tail."""
    rng = np.random.default_rng(E)
    V = max(E // 4, 8)
    arrs = [torch.from_numpy(x).to(cuda) for x in _k2_edges(rng, V, E, E, "full", integer)]
    _k2_check(arrs, integer)


@pytest.mark.parametrize("offsets,split", [((3, 3), (13, 0)), ((3, 1), (0, 1)),
                                            ((16, 0), (0, 0))],
                         ids=["same-offset", "mixed-offset", "aligned-offset"])
def test_frontier_spmv_kernel_takes_unaligned_views(cuda, offsets, split):
    """Slices whose start is not on a 16-byte boundary: alive's first slots
    take the scalar path, then the groups are read as vectors (same
    offset) or, when src/dst cannot be read as vectors there, every slot
    takes the scalar path (mixed offsets).  The wrapper counts both
    (``head_slots``, ``unaligned_launches``)."""
    ka, ke = offsets
    rng = np.random.default_rng(11)
    E, V = 10_000, 2000
    src, dst, c, alive, peel = (torch.from_numpy(x).to(cuda)
                                for x in _k2_edges(rng, V, E + 16, E + 16, "full", True))
    views = (src[ke:ke + E], dst[ke:ke + E], c[ke:ke + E], alive[ka:ka + E], peel)
    assert views[3].data_ptr() % 16 == ka % 16
    before = alive.clone()
    k2_ops.head_slots = k2_ops.unaligned_launches = 0
    dw, drop = _k2_check(views, True)
    assert (k2_ops.head_slots, k2_ops.unaligned_launches) == split
    assert float(drop) > 0 and bool(dw.any())
    # bytes outside the view are left alone
    assert torch.equal(alive[:ka], before[:ka])
    assert torch.equal(alive[ka + E:], before[ka + E:])


@pytest.mark.parametrize("what", ["all-dead", "nothing-peeled"])
def test_frontier_spmv_kernel_no_op_rounds(cuda, what):
    """A round after convergence (no live slot) and a round that peels
    nothing: liveness unchanged, dw zero, drop mass 0."""
    rng = np.random.default_rng(13)
    src, dst, c, alive, peel = _k2_edges(rng, 3000, 70_000, 65_000, "full", False)
    if what == "all-dead":
        alive[:] = False
    else:
        peel[:] = False
    arrs = [torch.from_numpy(x).to(cuda) for x in (src, dst, c, alive, peel)]
    dw, drop = _k2_check(arrs, False)
    assert torch.equal(arrs[3].cpu(), torch.from_numpy(alive))
    assert not bool(dw.any()) and float(drop) == 0.0


def test_frontier_spmv_is_the_same_bits_every_run(cuda):
    """The drop partials are summed in block order by the last block, and
    dw is scattered into float64: three runs on lognormal weights, with hub
    vertices that take many contributions, give the same dw and drop mass
    bit for bit."""
    rng = np.random.default_rng(17)
    src, dst, c, alive, peel = _k2_edges(rng, 50_000, 1_000_000, 1_000_000, "full", False)
    dst[::7] = rng.integers(0, 16, dst[::7].shape[0])  # hubs
    arrs = [torch.from_numpy(x).to(cuda) for x in (src, dst, c, alive, peel)]
    runs = [_k2_check([*arrs[:3], arrs[3].clone(), arrs[4]], False) for _ in range(3)]
    for dw, drop in runs[1:]:
        assert torch.equal(dw, runs[0][0]) and torch.equal(drop, runs[0][1])


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("E,pad,offset", [(1, "full", 0), (17, "full", 0),
                                          (4099, "workset", 0), (100_000, "full", 0),
                                          (100_000, "workset", 0), (4099, "full", 5)],
                         ids=["E1", "E17", "E4099-ws", "E100k", "E100k-ws", "E4099-unaligned"])
def test_suffix_init_kernel_matches_plain(cuda, E, pad, offset, integer):
    """The warm peel's prologue on the card against its plain version: w0
    and f0 (exact on integers), and ``both`` bit for bit; an unaligned view
    runs every slot on the scalar path."""
    from repro_torch.kernels.frontier_spmv import suffix_init, suffix_init_ref

    rng = np.random.default_rng(E + offset)
    V = max(E // 4, 8)
    src, dst, c, emask, _ = _k2_edges(rng, V, E + offset, E, pad, integer)
    a = (rng.integers(0, 3, V) if integer else rng.lognormal(0.0, 1.0, V)).astype(np.float32)
    live = rng.random(V) < 0.7
    edges = [torch.from_numpy(x).to(cuda)[offset:] for x in (src, dst, c, emask)]
    verts = [torch.from_numpy(x).to(cuda) for x in (live, a)]
    n0 = k2_ops.suffix_init_launches
    got = suffix_init(*edges, *verts)
    again = suffix_init(*edges, *verts)
    torch.cuda.synchronize()
    assert k2_ops.suffix_init_launches == n0 + 2
    _assert_close(got, suffix_init_ref(*edges, *verts), integer)
    for x, y in zip(got, again):  # the same bits every run
        assert torch.equal(x, y)


def _assert_prologue(got, want, integer):
    """``suffix_init`` against its plain version: bit for bit on integer
    weights, else w0 and f0 within 1e-6 relative (float64 sums rounded once
    against float32 sums in another order) and ``both`` bit for bit."""
    if integer:
        _assert_close(got, want, True)
        return
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g.cpu(), w.cpu(), rtol=1e-6, atol=1e-6)
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("V", [5000, 1_000_003])
def test_suffix_init_kernel_in_vertex_range_passes(cuda, V, integer):
    """The prologue's bins are vertex ranges (20 of 256 at V 5,000, 123 of
    8,192 at V 1,000,003), the last one ragged; every bin's pairs land in
    its own CTA's float64 accumulator.  Three calls give the same bits."""
    from repro_torch.kernels.frontier_spmv import suffix_init, suffix_init_ref

    rng = np.random.default_rng(V)
    E = 14 * V + 5
    src, dst, c, emask, _ = _k2_edges(rng, V, E, 13 * V, "full", integer)
    a = (rng.integers(0, 3, V) if integer else rng.lognormal(0.0, 1.0, V)).astype(np.float32)
    live = rng.random(V) < 0.7
    args = [torch.from_numpy(x).to(cuda) for x in (src, dst, c, emask, live, a)]
    assert -(-V // (1 << k2_ops.bin_shift(V))) > 1 and V % (1 << k2_ops.bin_shift(V))
    got = suffix_init(*args)
    _assert_prologue(got, suffix_init_ref(*args), integer)
    for _ in range(2):
        for x, y in zip(suffix_init(*args), got):
            assert torch.equal(x, y)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("case", ["nothing-live", "E-below-a-group"])
def test_suffix_init_kernel_edge_cases(cuda, case, integer):
    """No live vertex (no pair at all: w0 and f0 0, ``both`` empty of
    true), and fewer slots than one 16-slot vector group (every slot on the
    count pass's scalar path; a scatter batch with a ragged end)."""
    from repro_torch.kernels.frontier_spmv import suffix_init, suffix_init_ref

    rng = np.random.default_rng(7 if integer else 8)
    V, E = (3000, 40_000) if case == "nothing-live" else (9, 11)
    src, dst, c, emask, _ = _k2_edges(rng, V, E, E - 2, "full", integer)
    a = (rng.integers(0, 3, V) if integer else rng.lognormal(0.0, 1.0, V)).astype(np.float32)
    live = np.zeros(V, bool) if case == "nothing-live" else rng.random(V) < 0.8
    args = [torch.from_numpy(x).to(cuda) for x in (src, dst, c, emask, live, a)]
    got = suffix_init(*args)
    _assert_prologue(got, suffix_init_ref(*args), integer)
    if case == "nothing-live":
        assert not bool(got[0].any()) and float(got[1]) == 0.0 and not bool(got[2].any())


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("V", [5000, 1_000_003])
def test_suffix_init_kernel_float64_mode(cuda, V, integer):
    """The float64 mode on the card against its plain version (the
    accumulators, vertex sum and ``both``: bit for bit on integer weights,
    else rtol 1e-6 and, for the float64 sums, 1e-12), and ``w0``/``f0``
    formed from it, as the edge-sharded prologue forms them, equal to the
    usual mode's bit for bit."""
    from repro_torch.kernels.frontier_spmv import suffix_init, suffix_init_ref

    rng = np.random.default_rng(V + 1)
    E = 14 * V + 5
    src, dst, c, emask, _ = _k2_edges(rng, V, E, 13 * V, "full", integer)
    a = (rng.integers(0, 3, V) if integer else rng.lognormal(0.0, 1.0, V)).astype(np.float32)
    live = rng.random(V) < 0.7
    args = [torch.from_numpy(x).to(cuda) for x in (src, dst, c, emask, live, a)]
    n0 = k2_ops.suffix_init_launches
    acc = torch.full((V + 1,), float("nan"), dtype=torch.float64, device=cuda)
    got = suffix_init(*args, acc=acc)
    want = suffix_init_ref(*args, acc=torch.empty_like(acc))
    torch.cuda.synchronize()
    assert k2_ops.suffix_init_launches == n0 + 1 and got[0] is acc
    assert torch.equal(got[2], want[2])
    if integer:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        torch.testing.assert_close(got[0][:V].cpu(), want[0][:V].cpu(), rtol=1e-12, atol=1e-9)
        torch.testing.assert_close(got[0][V:].cpu(), want[0][V:].cpu(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got[1].cpu(), want[1].cpu(), rtol=1e-6, atol=1e-6)
    w0, f0, both = suffix_init(*args)
    assert torch.equal(torch.where(args[4], (args[5].double() + acc[:V]).float(), 0.0), w0)
    assert torch.equal((got[1].double() + acc[V]).float(), f0)


def test_kernel_wrappers_check_arguments(cuda):
    from repro_torch.kernels.frontier_spmv import suffix_init

    x = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        peel_round(x, x, x, x.int(), x.double(), x[0], x[0].int())
    with pytest.raises(TypeError, match="dw"):  # the accumulator is float64
        peel_round(x, x, x.bool(), x.int(), x, x[0], x[0].int())
    with pytest.raises(ValueError, match="elements"):
        frontier_spmv(x.int(), x[:4].int(), x, x.bool(), x.bool(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        frontier_spmv(x.int(), x.int(), x, torch.zeros(16, device=cuda).bool()[::2],
                      x.bool(), x.double())
    with pytest.raises(TypeError, match="dw"):  # the accumulator is float64
        frontier_spmv(x.int(), x.int(), x, x.bool(), x.bool(), x)
    with pytest.raises(TypeError, match="dtype"):
        suffix_init(x.int(), x.int(), x, x.bool(), x.bool(), x.int())


def test_bulk_peel_cuda_equals_cpu(cuda):
    from repro_torch.graphstore.structs import device_graph_from_coo

    rng = np.random.default_rng(3)
    n, m = 2000, 12_000
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    c = rng.integers(1, 6, keep.sum()).astype(np.float32)
    res = [tpeel.bulk_peel(device_graph_from_coo(n, src[keep], dst[keep], c,
                                                 device=d), eps=0.1)
           for d in (cuda, "cpu")]
    for f in ("level", "best_g", "best_level", "n_rounds", "delta"):
        assert torch.equal(getattr(res[0], f).cpu(), getattr(res[1], f)), f


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("semantics,integer", [("DG", True), ("XPARITY", True),
                                               ("DW", False)])
def test_cross_plane_insert_ticks_cuda(cuda, semantics, integer):
    """chip_smoke.py's phase 12a at a small size on cuda: the port's host
    oracle and its device plane take the same 512-edge ticks; after every
    tick the batch weights, the live edge multiset and w0 equal the host's
    (bit for bit on integer weights), best_g is at most its community's
    density; a final full_refresh holds the bulk guarantee.  K1, K2 and
    suffix_init launch."""
    from repro_torch.core.semantics import resolve
    from repro_torch.kernels.frontier_spmv import ops as k2_ops
    from repro_torch.kernels.peel_round import ops as k1_ops

    cs = _chip_smoke()
    sem = cs.parity_semantics() if semantics == "XPARITY" else resolve(semantics)
    stream = make_transaction_stream(n=3000, m=15000, seed=3)
    n1, n2, n3 = k1_ops.launches, k2_ops.launches, k2_ops.suffix_init_launches
    rec = cs.cross_plane_ticks(sem, cs.integer_amounts(stream) if integer else stream,
                               4, 512, cuda, 0.1, 20, integer=integer, tag=semantics)
    assert rec["ticks"] == 4
    assert k1_ops.launches > n1 and k2_ops.launches > n2
    assert k2_ops.suffix_init_launches > n3


@pytest.mark.parametrize("tied", [False, True], ids=["int", "tied"])
def test_exact_peel_cuda_matches_static_peel(cuda, tied):
    """exact_peel on cuda: static_peel's order (ties to the lowest id, as
    torch.argmin's first minimum gives on the card) and delta bit for bit,
    and the same bits as on cpu."""
    from repro_torch.core.peel import exact_peel
    from repro_torch.graphstore.structs import device_graph_from_coo

    rec = _chip_smoke().exact_peel_check(600, 3000, 6, cuda, tied)
    assert rec["tied_neighbours"] > 0
    rng = np.random.default_rng(6)
    src, dst = rng.integers(0, 300, 1500), rng.integers(0, 300, 1500)
    keep = src != dst
    res = [exact_peel(device_graph_from_coo(300, src[keep], dst[keep], device=d))
           for d in (cuda, "cpu")]
    for f in ("order", "delta", "level", "best_g", "best_level"):
        assert torch.equal(getattr(res[0], f).cpu(), getattr(res[1], f)), f


@pytest.mark.parametrize("spec", [{}, {"window_ticks": 2, "workset": True}],
                         ids=["fused", "window2-workset"])
def test_service_cuda_equals_cpu(cuda, spec):
    stream = make_transaction_stream(n=3000, m=15000, seed=9)
    states, reps = [], []
    for d in ("cuda", "cpu"):
        svc = SpadeService("DG", batch_edges=512, device=d, **spec)
        reps.append(svc.run(stream))
        states.append(state_to_numpy(svc.final_state))
    assert reps[0].final_g == reps[1].final_g
    assert reps[0].live_edges == reps[1].live_edges
    for k, v in states[0].items():
        assert np.array_equal(np.asarray(v), np.asarray(states[1][k])), k


# DW and FD weights are not integers: K2, the prologue and the tick's w0
# bookkeeping sum in float64 and round once, the CPU's scatters in float32
# in their own order.  So the reports are
# held as tests/test_torch_service.py::test_service_dw_reports_agree holds
# the port against the reference: the counts equal, final_g to rtol 1e-5,
# benign_fraction to rtol 1e-3; two cuda runs against each other the same.
DW_EQUAL = ("fraud_recall", "n_ticks", "live_edges", "n_expired_edges",
            "n_workset_ticks", "n_fallback_ticks", "n_predicted_ticks",
            "n_bucket_miss_ticks")


def _reports_agree(got, want):
    for f in DW_EQUAL:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_allclose(got.final_g, want.final_g, rtol=1e-5)
    np.testing.assert_allclose(got.benign_fraction, want.benign_fraction, rtol=1e-3)


@pytest.mark.parametrize("spec", [{}, {"window_ticks": 2, "workset": True}],
                         ids=["fused", "window2-workset"])
@pytest.mark.parametrize("semantics", ["DW", "FD"])
def test_service_float_weights_cuda_matches_cpu(cuda, semantics, spec):
    stream = make_transaction_stream(n=3000, m=15000, seed=9)
    run = lambda d: SpadeService(semantics, batch_edges=512, device=d, **spec).run(stream)
    first, again, cpu = run(cuda), run(cuda), run("cpu")
    _reports_agree(first, cpu)
    _reports_agree(again, first)


@pytest.mark.parametrize("semantics", ["DW", "FD"])
def test_service_windowed_w0_same_bits_every_run(cuda, semantics):
    """The tick's w0 bookkeeping adds its deltas in float64 and rounds once
    (and the start-up w0 is the static peel's own prologue), so two cuda
    runs of the windowed service end with the same w0 bits and the same
    benign fraction."""
    stream = make_transaction_stream(n=3000, m=15000, seed=9)
    runs = []
    for _ in range(2):
        svc = SpadeService(semantics, batch_edges=512, device=cuda, window_ticks=2)
        rep = svc.run(stream)
        runs.append((rep, svc.final_state.w0.cpu()))
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][0].benign_fraction == runs[1][0].benign_fraction


@pytest.mark.parametrize("with_drops,d_bucket", [(False, 0), (True, 0), (True, 32)],
                         ids=["insert", "drops-full", "drops-compacted"])
def test_tick_w0_cuda_equals_cpu(cuda, with_drops, d_bucket):
    """The tick's w0 bookkeeping on the card (one ``suffix_init`` over the
    dropped and inserted lanes and a spare vertex) equals the plain version
    on the cpu bit for bit on integer weights, lanes with one end outside
    ``[0, V)`` among them."""
    from repro_torch.core import incremental as ti
    from repro_torch.graphstore.structs import device_graph_from_coo

    rng = np.random.default_rng(12)
    n, m = 300, 2000
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    c = rng.integers(1, 6, keep.sum()).astype(np.float32)
    V = 320
    far_s = np.array([3, V + 5, 7, 9, 11, 12], np.int32)
    far_d = np.array([V, 6, -1, -V - 1, 13, 14], np.int32)
    far_c = np.array([2, 3, 4, 5, 6, 7], np.float32)
    far_valid = np.array([True, True, True, True, True, False])
    drop = np.arange(2048) < 40
    out = []
    for d in (cuda, torch.device("cpu")):
        g = device_graph_from_coo(n, src[keep], dst[keep], c, n_capacity=V,
                                  e_capacity=2048, device=d)
        state = ti.init_state(g, eps=0.1)
        T = lambda *xs: [torch.from_numpy(x).to(d) for x in xs]
        s_in, d_in = T(far_s % n, far_d % n)
        bk = ti._slide_prologue(state, T(drop)[0] if with_drops else None, s_in, d_in,
                                T(far_valid)[0])
        out.append(ti._tick_w0(state, bk, *T(far_s, far_d, far_c, far_valid),
                               with_drops, d_bucket).cpu())
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("arch", ["qwen3-14b", "internlm2-20b", "deepseek-coder-33b",
                                  "mixtral-8x7b", "olmoe-1b-7b"])
def test_lm_smoke_config_cuda_matches_cpu(cuda, arch):
    """The LMs' smoke configs (float32, d_head 16) run on cuda through
    K3's SIMT body, one launch a layer per prefill, and match the same
    weights on cpu: prefill and 3 decode steps, logits within
    chip_smoke.py's LM_TOL (3e-2) of each row's largest |logit|.  The MoE
    configs' routing is held to chip_smoke.py's rule (``routing_check``:
    the same experts but on near-ties, which leave their sequence out)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.models import TransformerLM, decode_step, prefill

    cs = _chip_smoke()
    cfg = get_smoke_config(arch)
    cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    gpu = TransformerLM(cfg, device=cuda, init=False)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    B, S = 2, 24
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    rec_g, rec_c, rows = [], [], set()
    k0, s0 = k3_ops.launches, k3_ops.simt_launches
    with cs.routing_recorded(rec_g):
        lg, cache_g = prefill(gpu, tokens.to(cuda))
    assert k3_ops.launches == k0 and k3_ops.simt_launches == s0 + cfg.n_layers
    with cs.routing_recorded(rec_c):
        lc, cache_c = prefill(cpu, tokens)
    for step in range(4):
        if cfg.moe is not None:
            rows |= cs.routing_check(f"{arch} step {step}", rec_g, rec_c, B)["rows"]
        assert cs.rows_rel_err(lg, lc, rows) <= 3e-2, f"step {step}"
        if step == 3:
            break
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, B))
        pos = torch.full((B,), S + step, dtype=torch.int64)
        with cs.routing_recorded(rec_g):
            lg, cache_g = decode_step(gpu, cache_g, tok.to(cuda), pos.to(cuda))
        with cs.routing_recorded(rec_c):
            lc, cache_c = decode_step(cpu, cache_c, tok, pos)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "olmoe-1b-7b"])
def test_moe_ffn_cuda_same_bits_every_run(cuda, arch):
    """One layer's ``moe_ffn`` at the config's full width in bf16, 512
    tokens (drops included): two runs on the card give the same bits (no
    atomic in dispatch or combine)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe_ffn
    from repro_torch.models.layers import normal_init
    from repro_torch.models.moe import moe_route

    cfg = get_config(arch)
    spec, D = cfg.moe, cfg.d_model
    E, F = spec.n_experts, spec.d_ff_expert
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = [normal_init((D, E), D, torch.float32, cuda, gen)] + [
        normal_init(shape, fan_in, torch.bfloat16, cuda, gen)
        for shape, fan_in in (((E, D, F), D), ((E, D, F), D), ((E, F, D), F))]
    x = torch.randn((512, D), generator=gen, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        runs = [moe_ffn(x, *w, spec) for _ in range(2)]
        assert not bool(moe_route(x, w[0], spec).keep.all())  # drops happen
    assert bool(torch.isfinite(runs[0][0]).all())
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


# K3 flash_attention: bf16 on the tensor cores against its plain versions
# (float32 inside) on the same bf16 inputs; atol = rtol = 2e-2, the
# tolerance tests/test_kernels.py gives the Pallas kernel in bf16 (the
# kernel rounds P to bf16 before P V, and its output to bf16).  Late rows
# average many keys and are small, so each band of 64 query rows is also
# held normwise: ||got - want|| / ||want|| <= 1e-2.


def _band_rel_err(got, want, band=64):
    err2 = (got.float() - want.float()).square().sum(dim=(0, 1, 3))
    want2 = want.float().square().sum(dim=(0, 1, 3))
    pad = -got.shape[2] % band
    err2, want2 = (torch.nn.functional.pad(t, (0, pad)).view(-1, band).sum(1)
                   for t in (err2, want2))
    return float((err2 / want2).sqrt().max())

FA_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window)
    (1, 4, 2, 128, 128, 64, True, None),
    (2, 10, 2, 333, 333, 128, True, None),   # qwen3's G = 5, ragged
    (1, 8, 8, 200, 200, 128, True, 64),      # window: tiles skipped
    (2, 6, 3, 197, 197, 64, True, 100),
    (1, 4, 1, 100, 300, 128, False, None),   # not causal, Sq != Skv
    # the edges of the 128 x 128 tiles: the second consumer warpgroup (query
    # rows 64-127 of a tile) with some live rows and with none
    (1, 4, 2, 70, 70, 128, True, None),
    (2, 4, 2, 60, 60, 64, True, None),
    # fewer than 128 keys; windows narrower than a kv tile
    (1, 4, 4, 300, 90, 64, False, None),
    (1, 10, 2, 100, 100, 128, True, None),
    (1, 8, 2, 600, 600, 128, True, 50),
    (1, 2, 1, 256, 256, 64, True, 1),
    # S a multiple of 128 and just past one, G = 5 and G = 1
    (1, 10, 2, 512, 512, 128, True, None),
    (2, 4, 4, 129, 129, 128, True, None),
    (1, 5, 1, 256, 256, 64, True, None),
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window", FA_CASES,
                         ids=[f"fa{i}" for i in range(len(FA_CASES))])
def test_flash_attention_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D, causal, window):
    from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention import ops as k3_ops

    rng = np.random.default_rng(Sq + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        cuda, torch.bfloat16) for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    n0 = k3_ops.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k3_ops.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    for want in (attention_ref(q, k, v, causal=causal, window=window),
                 flash_attention_ref(q, k, v, causal=causal, window=window,
                                     block_q=128, block_k=128)):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
        assert _band_rel_err(got, want) <= 1e-2


def test_flash_attention_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        cuda, torch.bfloat16) for s in ((2, 10, 700, 128), (2, 2, 700, 128), (2, 2, 700, 128)))
    first = flash_attention(q, k, v, window=300)
    again = flash_attention(q, k, v, window=300)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_model_flash_attention_cuda_matches_cpu(cuda):
    """Strided model-layout views through K3 against the CPU plain path."""
    from repro_torch.models.attention import flash_attention

    rng = np.random.default_rng(4)
    B, S, Hkv, G, D = 2, 150, 2, 5, 128
    q = torch.from_numpy(rng.standard_normal((B, S, Hkv, G, D), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda))
    want = flash_attention(q, k, v)
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=2e-2, rtol=2e-2)


def test_flash_attention_wrapper_raises_on_cuda(cuda):
    """What neither body takes raises before any launch: float64, mixed
    dtypes, head dims past 256, a non-unit last stride."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as k3_ops

    q = torch.zeros(1, 2, 16, 128, device=cuda, dtype=torch.float64)
    n0 = k3_ops.launches, k3_ops.simt_launches
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="q is torch.float32"):
        flash_attention(q.float(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros(1, 2, 16, 300, device=cuda)
        flash_attention(x, x, x)
    with pytest.raises(ValueError, match="strides"):
        x = torch.zeros(1, 2, 64, 16, device=cuda).transpose(2, 3)
        flash_attention(x, x, x)
    assert (k3_ops.launches, k3_ops.simt_launches) == n0


# K3's SIMT body (float32, float16, bf16 at any head dim up to 256) against
# the plain versions on the same inputs: f32 FFMA against f32 einsums, so
# float32 agrees to 1e-4 (atol = rtol); float16 and bf16 outputs are
# rounded to their type, so 1e-2 and 2e-2 (the bf16 tolerance above).
SIMT_CASES = [
    # (dtype, B, Hq, Hkv, Sq, Skv, D, causal, window)
    ("float32", 2, 4, 2, 24, 24, 16, True, None),    # the smoke configs' shapes
    ("float32", 1, 10, 2, 333, 333, 128, True, None),
    ("float32", 2, 6, 3, 197, 197, 64, True, 100),
    ("float32", 1, 4, 1, 100, 300, 32, False, None),  # not causal, Sq != Skv
    ("float32", 1, 2, 2, 70, 70, 256, True, None),    # the largest head dim
    ("float32", 1, 4, 2, 129, 129, 20, True, 7),      # D off the power-of-two widths
    ("float16", 2, 8, 2, 200, 200, 80, True, 50),
    ("bfloat16", 1, 4, 4, 300, 90, 96, False, None),
    ("bfloat16", 1, 5, 1, 65, 65, 16, True, 1),
    # across the 64-row and 64-key tile edges: ragged Sq and Skv, D from 1
    # to 256, G 1 and 5, windowed without causality (every row keeps a key)
    ("float32", 1, 10, 2, 200, 200, 1, True, None),
    ("float32", 1, 5, 1, 150, 130, 33, False, 40),
    ("float32", 2, 4, 4, 129, 257, 100, False, None),
    ("float32", 1, 3, 3, 65, 65, 256, True, 30),
    ("float16", 1, 10, 2, 190, 190, 80, True, None),
    ("bfloat16", 1, 5, 1, 127, 127, 16, False, None),
]


@pytest.mark.parametrize("dtype,B,Hq,Hkv,Sq,Skv,D,causal,window", SIMT_CASES,
                         ids=[f"simt{i}" for i in range(len(SIMT_CASES))])
def test_flash_attention_simt_body_matches_plain(cuda, dtype, B, Hq, Hkv, Sq, Skv, D,
                                                 causal, window):
    from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention import ops as k3_ops

    dt = getattr(torch, dtype)
    tol = {"float32": 1e-4, "float16": 1e-2, "bfloat16": 2e-2}[dtype]
    rng = np.random.default_rng(Sq + D)
    # the model layout [B, S, H, D], read as [B, H, S, D] views
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        cuda, dt).transpose(1, 2) for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                            (B, Skv, Hkv, D)))
    n0 = k3_ops.launches, k3_ops.simt_launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (k3_ops.launches, k3_ops.simt_launches) == (n0[0], n0[1] + 2)
    assert got.dtype == dt and got.shape == q.shape and got.stride() == q.stride()
    assert torch.equal(got, again)
    for want in (attention_ref(q, k, v, causal=causal, window=window),
                 flash_attention_ref(q, k, v, causal=causal, window=window)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# K4 gather_segsum: float32 FFMA over destination rows against the plain
# row-level version, the plain tile-level version on the same edges' tiles
# (through rows_from_tiles) and the COO oracle: bit for bit on integer-valued
# weights and x, where every sum is exact, else atol = rtol = 1e-4
# (tests/test_kernels.py's contract).

K4_CASES = [
    # (n_dst, n_src, n_edges, F, seed): tests/test_kernels.py's sweep, GCN's
    # widths, and rows longer than a warp's edges in flight
    (256, 256, 1000, 64, 0),
    (300, 200, 700, 16, 1),
    (128, 512, 2000, 128, 2),
    (512, 512, 100, 200, 3),
    (3072, 3072, 10_752, 7, 4),
    (1000, 5000, 60_000, 33, 5),
]


@pytest.mark.parametrize("integer", [True, False], ids=["int", "normal"])
@pytest.mark.parametrize("n_dst,n_src,m,F,seed", K4_CASES,
                         ids=[f"k4_{i}" for i in range(len(K4_CASES))])
def test_gather_segsum_kernel_matches_plain(cuda, n_dst, n_src, m, F, seed, integer):
    from repro_torch.kernels.gather_segsum import (block_spmm_ref, build_rows, build_tiles,
                                                   gather_segsum, rows_from_tiles, spmm_ref,
                                                   spmm_rows_ref)
    from repro_torch.kernels.gather_segsum import ops as k4_ops

    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(0, n_src, m).astype(np.int32)).to(cuda)
    dst = torch.from_numpy(rng.integers(0, n_dst, m).astype(np.int32)).to(cuda)
    if integer:
        val = torch.from_numpy(rng.integers(-3, 4, m).astype(np.float32)).to(cuda)
        x = torch.from_numpy(rng.integers(-4, 5, (n_src, F)).astype(np.float32)).to(cuda)
    else:
        val = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(cuda)
        x = torch.from_numpy(rng.normal(size=(n_src, F)).astype(np.float32)).to(cuda)
    rows = build_rows(src, dst, val, n_dst, n_src)
    assert rows.col.is_cuda and rows.row_ptr.is_cuda
    bt = build_tiles(src, dst, val, n_dst, n_src)
    n0 = k4_ops.launches
    got = gather_segsum(rows, x, n_dst)
    again = gather_segsum(rows, x, n_dst)
    tiled = gather_segsum(rows_from_tiles(bt), x, n_dst)
    torch.cuda.synchronize()
    assert k4_ops.launches == n0 + 3
    assert got.shape == (n_dst, F)
    assert torch.equal(got, again)  # the same bits every run
    plain = spmm_rows_ref(rows, x)
    block = block_spmm_ref(bt.tiles, bt.tile_src, bt.tile_dst, bt.first_visit, x,
                           bt.n_out_blocks)[:n_dst]
    coo = spmm_ref(src, dst, val, x, n_dst)
    if integer:
        assert torch.equal(got, plain) and torch.equal(got, coo)
        assert torch.equal(tiled, block)
    else:
        for want in (coo, plain):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(tiled, block, atol=1e-4, rtol=1e-4)


def test_gather_segsum_wrapper_raises_on_cuda(cuda):
    from repro_torch.kernels.gather_segsum import BlockRows, gather_segsum
    from repro_torch.kernels.gather_segsum import ops as k4_ops

    rows = BlockRows(torch.tensor([0, 1, 3], device=cuda),
                     torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda),
                     torch.ones(3, device=cuda), n_out=2, n_src=256)
    x = torch.zeros(256, 8, device=cuda)
    n0 = k4_ops.launches
    with pytest.raises(TypeError, match="x"):
        gather_segsum(rows, x.double(), 2)
    with pytest.raises(ValueError, match="n_out 3"):
        gather_segsum(rows, x, 3)
    with pytest.raises(ValueError, match="contiguous"):
        gather_segsum(rows, torch.zeros(8, 256, device=cuda).t(), 2)
    rows.col = rows.col.cpu()
    with pytest.raises(ValueError, match="on cpu"):
        gather_segsum(rows, x, 2)
    assert k4_ops.launches == n0


@pytest.mark.parametrize("arch", ["gcn-cora", "gat-cora", "meshgraphnet", "dimenet"])
def test_gnn_forward_cuda_matches_cpu(cuda, arch):
    """Smoke configs on a small graph; GCN runs through K4, 4 launches."""
    import dataclasses

    from repro_torch.configs import GNN_SHAPES, get_smoke_config
    from repro_torch.kernels.gather_segsum import ops as k4_ops
    from repro_torch.launch.cells import graph_batch
    from repro_torch.models.gnn import GNN, gcn_rows

    cfg = get_smoke_config(arch)
    spec = dataclasses.replace(GNN_SHAPES["full_graph_sm"], n_nodes=700, n_edges=3000,
                               d_feat=8)
    g_cpu = graph_batch(cfg, spec, seed=1, device="cpu")
    g_gpu = graph_batch(cfg, spec, seed=1, device=cuda)
    cpu = GNN(cfg, 8, device="cpu")
    gpu = GNN(cfg, 8, device=cuda, init=False)
    gpu.load_state_dict(cpu.state_dict())
    rows = gcn_rows(g_gpu) if arch == "gcn-cora" else None
    n0 = k4_ops.launches
    got = gpu(g_gpu, rows)
    torch.cuda.synchronize()
    assert k4_ops.launches == n0 + (4 if arch == "gcn-cora" else 0)
    want = cpu(g_cpu)
    scale = want.abs().amax(-1, keepdim=True).clamp(min=1e-6)
    assert bool(((got.cpu() - want).abs() <= 1e-4 * scale).all())


def _sharded_service_rank(mesh, device: str, spec: dict):
    """A rank of the sharded service on ``device``: its report and state."""
    stream = make_transaction_stream(n=3000, m=15000, seed=9)
    svc = SpadeService("DG", batch_edges=512, device=device, mesh=mesh, **spec)
    return svc.run(stream).final_g, state_to_numpy(svc.final_state)


@pytest.mark.parametrize("spec", [{"window_ticks": 2}, {"window_ticks": 2, "workset": True}],
                         ids=["window2", "window2-workset"])
def test_sharded_service_on_the_card_equals_one_device(cuda, spec):
    """Two gloo ranks on the card (gloo takes the engine's CUDA all_reduces;
    nccl would need a card a rank): every rank's replicated state and the
    ranks' edge blocks joined equal the single-device service's on cuda
    bit for bit (DG)."""
    from repro_torch.dist import spawn

    ranks = spawn(_sharded_service_rank, 2, backend="gloo", device="cuda",
                  args=("cuda", spec), timeout=300)
    want_g, want = _sharded_service_rank(None, "cuda", spec)
    for g, got in ranks:
        assert g == want_g
        for f in ("level", "best_g", "community", "edge_count", "w0"):
            assert np.array_equal(got[f], want[f]), f
    for f in ("src", "dst", "c", "edge_mask"):
        joined = np.concatenate([r[1][f] for r in ranks])[:want[f].shape[0]]
        assert np.array_equal(joined, want[f]), f
