"""The port's kernels (their plain versions, on the CPU) against the JAX
reference: the Pallas ``peel_round`` kernel in interpret mode and its
oracle, the JAX expressions of the round's edge half
(``repro/core/peel.py:201-210``) and of the warm peel's prologue
(``repro/core/peel.py:324-329``), and one whole round against
``repro.core.peel._round_step(use_kernel=True)``.

Tolerances: on integer-valued inputs every result is bit-identical (every
float32 sum of integers below 2^24 is exact in any order).  On uniform
float inputs the per-vertex outputs stay bit-identical (one subtraction
each) and the partial sums agree to rtol 1e-5 (float32 sums of up to 10^4
terms taken in another order).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import peel as jpeel  # noqa: E402
from repro.kernels.peel_round import peel_round_ref as j_peel_round_ref  # noqa: E402
from repro.kernels.peel_round.kernel import peel_round_update  # noqa: E402
from repro_torch.core import peel as tpeel  # noqa: E402
from repro_torch.kernels.frontier_spmv import (frontier_spmv, frontier_spmv_ref,  # noqa: E402
                                               suffix_init, suffix_init_ref)
from repro_torch.kernels.frontier_spmv import ops as k2_ops  # noqa: E402
from repro_torch.kernels.peel_round import peel_round, peel_round_ref  # noqa: E402
from repro_torch.kernels.peel_round import ops as k1_ops  # noqa: E402

PEEL_SWEEP = [(1000, 0), (8192, 1), (10000, 2), (100, 3)]  # tests/test_kernels.py


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k1_inputs(V, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        w = rng.integers(0, 11, V).astype(np.float32)
        a = rng.integers(0, 3, V).astype(np.float32)
        dw = rng.integers(0, 2, V).astype(np.float32)
    else:
        w = rng.uniform(0, 10, V).astype(np.float32)
        a = rng.uniform(0, 2, V).astype(np.float32)
        dw = rng.uniform(0, 1, V).astype(np.float32)
    active = rng.random(V) > 0.3
    level = rng.integers(-1, 5, V).astype(np.int32)
    return w, a, active, level, dw


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("V,seed", PEEL_SWEEP,
                         ids=[f"peel{v}" for v, _ in PEEL_SWEEP])
def test_peel_round_ref_matches_pallas_and_oracle(V, seed, integer):
    w, a, active, level, dw = _k1_inputs(V, seed, integer)
    jargs = [jnp.asarray(x) for x in (w, a, active, level, dw)]
    jk = peel_round_update(*jargs, jnp.float32(5.0), jnp.int32(7), block=1024,
                           interpret=True)
    jk = (*jk[:4], jk[4].sum(0))
    jr = j_peel_round_ref(*jargs, jnp.float32(5.0), jnp.int32(7))
    # dw in the float64 accumulator K2 hands the round (exact), left zeroed
    acc = torch.from_numpy(dw).double()
    got = peel_round_ref(*[torch.from_numpy(x) for x in (w, a, active, level)], acc,
                         torch.tensor(5.0), torch.tensor(7, dtype=torch.int32))
    assert not bool(acc.any())
    for want in (jk, jr):
        for i in range(4):  # w', active', level', peeled: exact
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        if integer:
            np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        else:
            np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                       rtol=1e-5)


def _jax_edge_half(src, dst, c, alive, peel, V):
    """The reference's edge half, verbatim from repro/core/peel.py:201-210."""
    import jax

    e_ps = peel[src]
    e_pd = peel[dst]
    cm = jnp.where(alive, c, 0.0)
    drop_mass = jnp.sum(jnp.where(e_ps | e_pd, cm, 0.0))
    dw = jax.ops.segment_sum(
        jnp.where(e_ps & ~e_pd, cm, 0.0), dst, num_segments=V
    ) + jax.ops.segment_sum(jnp.where(e_pd & ~e_ps, cm, 0.0), src, num_segments=V)
    return dw, drop_mass, alive & ~(e_ps | e_pd)


def _edges_with_pads(seed, V, m, E, pad, integer):
    rng = np.random.default_rng(seed)
    pad_id = V - 1 if pad == "full" else 0
    src = np.full(E, pad_id, np.int32)
    dst = np.full(E, pad_id, np.int32)
    src[:m] = rng.integers(0, V, m)
    dst[:m] = rng.integers(0, V, m)
    c = np.zeros(E, np.float32)
    c[:m] = rng.integers(1, 6, m) if integer else rng.lognormal(1.0, 1.0, m)
    alive = np.zeros(E, bool)
    alive[:m] = rng.random(m) < 0.9
    peel = rng.random(V) < 0.2
    return src, dst, c, alive, peel


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("pad", ["full", "workset"])
def test_frontier_spmv_ref_matches_jax_edge_half(pad, integer):
    """Both pad kinds — full-buffer slots (src = dst = V-1, c = 0, dead) and
    workset lanes (endpoint 0, c = 0, dead) — are inert, with the pad
    vertex peeled or not.  Exact on integer weights; rtol 1e-6 on lognormal
    weights (the same scatter-add order, different summation of drop_mass).
    The plain version updates ``alive`` in place to the reference's
    ``alive & ~hit``: it clears the live slots with a peeled end and
    changes no other byte."""
    V, m, E = 300, 2000, 2600
    src, dst, c, alive, peel = _edges_with_pads(5, V, m, E, pad, integer)
    for pad_peeled in (False, True):
        peel[V - 1 if pad == "full" else 0] = pad_peeled
        want = _jax_edge_half(*[jnp.asarray(x) for x in (src, dst, c, alive, peel)], V)
        t_alive = torch.from_numpy(alive.copy())
        acc = torch.zeros(V, dtype=torch.float64)
        got = frontier_spmv_ref(*[torch.from_numpy(x) for x in (src, dst, c)], t_alive,
                                torch.from_numpy(peel), acc)
        assert len(got) == 2 and got[0] is acc
        np.testing.assert_array_equal(t_alive.numpy(), np.asarray(want[2]))
        hit = peel[src] | peel[dst]
        changed = t_alive.numpy() != alive
        np.testing.assert_array_equal(changed, alive & hit)
        if integer:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            assert float(got[1]) == float(want[1])
        else:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
            np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
        # the pad lanes themselves contribute nothing
        live = torch.from_numpy(np.arange(E) < m)
        real_alive = torch.from_numpy(alive[:m].copy())
        real = frontier_spmv_ref(*[torch.from_numpy(x)[:m] for x in (src, dst, c)],
                                 real_alive, torch.from_numpy(peel),
                                 torch.zeros(V, dtype=torch.float64))
        np.testing.assert_array_equal(real[0].numpy(), got[0].numpy())
        assert float(real[1]) == float(got[1])
        assert torch.equal(real_alive, t_alive[:m])
        assert not bool(t_alive[~live].any())


def _jax_prologue(src, dst, c, emask, live, a, V):
    """The reference's warm-peel prologue, verbatim from
    repro/core/peel.py:324-329."""
    import jax

    both = live[src] & live[dst] & emask
    cm = jnp.where(both, c, 0.0)
    w0 = jnp.where(live, a, 0.0)
    w0 = w0 + jax.ops.segment_sum(cm, src, num_segments=V)
    w0 = w0 + jax.ops.segment_sum(cm, dst, num_segments=V)
    f0 = jnp.sum(jnp.where(live, a, 0.0)) + jnp.sum(cm)
    return w0, f0, both


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("pad", ["full", "workset"])
def test_suffix_init_ref_matches_jax_prologue(pad, integer):
    """``suffix_init_ref`` against the reference's ``bulk_peel_warm``
    prologue on the same numpy inputs, with both pad kinds (their mask is
    false, and the pad vertex in or out of the live set).  Bit-identical on
    integer weights; rtol 1e-6 on lognormal ones (sums in another order)."""
    V, m, E = 300, 2000, 2600
    src, dst, c, emask, _ = _edges_with_pads(6, V, m, E, pad, integer)
    rng = np.random.default_rng(7)
    a = (rng.integers(0, 3, V) if integer else rng.lognormal(0.0, 1.0, V)).astype(np.float32)
    live = rng.random(V) < 0.6
    for pad_live in (False, True):
        live[V - 1 if pad == "full" else 0] = pad_live
        want = _jax_prologue(*[jnp.asarray(x) for x in (src, dst, c, emask, live, a)], V)
        got = suffix_init_ref(*[torch.from_numpy(x) for x in (src, dst, c, emask, live, a)])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert not bool(got[2][m:].any())
        if integer:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            assert float(got[1]) == float(want[1])
        else:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
            np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("pad", ["full", "workset"])
def test_suffix_init_ref_float64_mode(pad, integer):
    """``suffix_init_ref``'s float64 mode against its usual mode on the same
    inputs: the accumulators (no ``a``, float64) plus ``where(live, a, 0)``,
    rounded once, give ``w0``; the vertex sum plus ``acc[V]`` gives ``f0``;
    ``both`` is the same.  Bit for bit on integer weights; on lognormal
    weights the usual mode adds in float32 (rtol 1e-6).  A second call
    overwrites the whole buffer (it starts from garbage)."""
    V, m, E = 300, 2000, 2600
    src, dst, c, emask, _ = _edges_with_pads(6, V, m, E, pad, integer)
    rng = np.random.default_rng(8)
    a = (rng.integers(0, 3, V) if integer else rng.lognormal(0.0, 1.0, V)).astype(np.float32)
    live = rng.random(V) < 0.6
    args = [torch.from_numpy(x) for x in (src, dst, c, emask, live, a)]
    w0, f0, both = suffix_init_ref(*args)
    acc = torch.full((V + 1,), float("nan"), dtype=torch.float64)
    got, vsum, both64 = suffix_init_ref(*args, acc=acc)
    assert got is acc and vsum.dtype == torch.float32
    assert torch.equal(both64, both)
    assert not bool(acc[:V][~args[4]].any())  # nothing off the live set
    mine = torch.where(args[4], (args[5].double() + acc[:V]).float(), 0.0)
    f_mine = (vsum.double() + acc[V]).float()
    if integer:
        assert torch.equal(mine, w0) and float(f_mine) == float(f0)
    else:
        np.testing.assert_allclose(mine.numpy(), w0.numpy(), rtol=1e-6)
        np.testing.assert_allclose(float(f_mine), float(f0), rtol=1e-6)
    # and the float64 sums are the exact per-vertex sums of the both-masked c
    cm = np.where(both.numpy(), c, 0.0).astype(np.float64)
    exact = np.zeros(V)
    np.add.at(exact, src, cm)
    np.add.at(exact, dst, cm)
    np.testing.assert_allclose(acc[:V].numpy(), exact, rtol=1e-12)


def _graph(seed, n, m, with_a):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep].astype(np.int32), dst[keep].astype(np.int32)
    c = rng.integers(1, 6, src.shape[0]).astype(np.float32)
    a = rng.integers(0, 3, n).astype(np.float32) if with_a else np.zeros(n, np.float32)
    return src, dst, c, a


@pytest.mark.parametrize("force_peel", [False, True], ids=["thresh", "wmin"])
def test_round_step_matches_reference_kernel_round(force_peel):
    """One port round (CPU: the plain kernel versions) against the
    reference round with ``use_kernel=True``, bit-identical on integer
    weights — through the threshold branch and the min-weight force-peel
    branch (f forced so low that no weight passes the threshold)."""
    n = 150
    src, dst, c, a = _graph(11, n, 500, with_a=True)
    w0 = np.zeros(n, np.float32)
    np.add.at(w0, src, c)
    np.add.at(w0, dst, c)
    w0 += a
    f0 = np.float32(1.0 if force_peel else a.sum() + c.sum())
    active = np.ones(n, bool)
    active[:7] = False
    fields = dict(w=w0, active=active, edge_alive=np.ones(src.shape[0], bool),
                  f=f0, n_act=np.int32(active.sum()),
                  level=np.full(n, -1, np.int32), best_g=np.float32(3.0),
                  best_level=np.int32(2), round_=np.int32(4))
    js = jpeel._BulkState(**{k: jnp.asarray(v) for k, v in fields.items()})
    # copies: the port's round updates edge_alive in place; its dw
    # accumulator (no field of the reference's state) starts at zero
    ts = tpeel._BulkState(**{k: torch.as_tensor(v).clone() for k, v in fields.items()},
                          dw=torch.zeros(n, dtype=torch.float64))
    for _ in range(3):
        js = jpeel._round_step(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(c),
                               jnp.asarray(a), 0.1, True, js)
        ts = tpeel._round_step(torch.from_numpy(src), torch.from_numpy(dst),
                               torch.from_numpy(c), torch.from_numpy(a), 0.1, ts)
        for k in fields:
            got, want = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_wrappers_take_plain_path_on_cpu_without_launching():
    k1_ops.launches = 0
    k2_ops.launches = 0
    k2_ops.suffix_init_launches = 0
    w, a, active, level, dw = (torch.from_numpy(x) for x in _k1_inputs(64, 0, True))
    th, r = torch.tensor(5.0), torch.tensor(3, dtype=torch.int32)
    dw = [dw.double(), dw.double()]
    for x, y in zip(peel_round(w, a, active, level, dw[0], th, r),
                    peel_round_ref(w, a, active, level, dw[1], th, r)):
        assert torch.equal(x, y)
    assert not bool(dw[0].any())
    e = [torch.from_numpy(x) for x in _edges_with_pads(1, 50, 100, 128, "full", True)]
    alive = [e[3].clone(), e[3].clone()]
    acc = [torch.zeros(50, dtype=torch.float64) for _ in range(2)]
    for x, y in zip(frontier_spmv(*e[:3], alive[0], e[4], acc[0]),
                    frontier_spmv_ref(*e[:3], alive[1], e[4], acc[1])):
        assert torch.equal(x, y)
    assert torch.equal(alive[0], alive[1]) and not torch.equal(alive[0], e[3])
    live = e[4].logical_not()
    a = torch.arange(50, dtype=torch.float32)
    for x, y in zip(suffix_init(*e[:4], live, a), suffix_init_ref(*e[:4], live, a)):
        assert torch.equal(x, y)
    assert k1_ops.launches == 0 and k2_ops.launches == 0
    assert k2_ops.suffix_init_launches == 0


@pytest.mark.parametrize("V,shift", [(1, 8), (5000, 8), (100_000, 10), (1_000_003, 13),
                                     (6_023_168, 13), (1 << 26, 13)])
def test_suffix_init_bins_and_scratch_sizing(V, shift):
    """The prologue's bins: 2^shift vertices each (64 KB of float64 at most
    in one CTA's shared memory), at most 8,192 of them; its pair buffer, two
    8-byte pairs a slot (440 MB at the spade-grab edge capacity)."""
    assert k2_ops.bin_shift(V) == shift
    assert -(-V // (1 << shift)) <= 8192 and 8 << shift <= 64 << 10
    assert k2_ops.prologue_scratch_bytes(27_500_032) == 440_000_512


@pytest.mark.parametrize("V", [0, (1 << 26) + 1])
def test_suffix_init_refuses_vertex_counts_it_cannot_bin(V):
    with pytest.raises(ValueError, match="vertices"):
        k2_ops.bin_shift(V)


def test_wrappers_refuse_other_devices():
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        peel_round(meta, meta, meta.bool(), meta.int(), meta, meta[0], meta[0].int())
    with pytest.raises(ValueError, match="unsupported device"):
        frontier_spmv(meta.int(), meta.int(), meta, meta.bool(), meta.bool(), meta.double())
    with pytest.raises(ValueError, match="unsupported device"):
        suffix_init(meta.int(), meta.int(), meta, meta.bool(), meta.bool(), meta)
