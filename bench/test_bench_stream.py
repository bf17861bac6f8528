"""The device draw of the Grab-like stream against the frozen NumPy copy
of the port's generator, at a small size on the CPU."""

import numpy as np
import torch

from spade import numpy_stream
from spade.stream import Stream

N, M = 20_000, 400_000
CFG = {"graph": {"n_vertices": N, "background_edges": M, "base_fraction": 0.9,
                 "zipf_alpha": 0.3, "amount_lognormal": {"mu": 2.0, "sigma": 1.0},
                 "dense_blocks": {"count": 2, "size": 12, "edges": 1600,
                                  "amount_lognormal": {"mu": 3.5, "sigma": 0.3}}}}
TRAFFIC = {"batch_edges": 4096, "chunk_ticks": 8,
           "burst": {"edges": 300, "amount_lognormal": {"mu": 5.0, "sigma": 0.3}}}


def draw(seed, burst_at=3):
    return Stream(CFG, TRAFFIC, seed, "cpu", burst_at=burst_at)


def tail(deg, q):
    """The share of edges that the top ``q`` of vertices by degree hold."""
    d = np.sort(np.asarray(deg))[::-1]
    return d[: int(q * d.shape[0])].sum() / d.sum()


def test_bench_stream_matches_generator_statistics():
    ref = numpy_stream.make_transaction_stream(n=N, m=M, seed=0)
    s = draw(2**31 + 12345)
    m_bg = int(M * 0.9)
    assert s.base_edges == m_bg + 2 * 1600
    # the copy drops self-loops (a few in 10^4 here); the draw moves them
    assert abs(ref["base_src"].shape[0] / s.base_edges - 1) < 1e-3
    src, dst = s.base_src[:m_bg].numpy(), s.base_dst[:m_bg].numpy()
    assert (src != dst).all()
    rs, rd = ref["base_src"][:-3200], ref["base_dst"][:-3200]
    for mine, theirs in ((dst, rd), (src, rs)):
        deg = np.bincount(mine, minlength=N)
        want = np.bincount(theirs, minlength=N)
        for q in (0.001, 0.01, 0.1):
            assert abs(tail(deg, q) - tail(want, q)) < 0.01, q
        assert abs(deg.max() / want.max() - 1) < 0.15
    la = np.log(s.base_amt[:m_bg].numpy().astype(np.float64))
    lr = np.log(ref["base_amt"][:-3200])
    assert abs(la.mean() - lr.mean()) < 0.01 and abs(la.std() - lr.std()) < 0.01
    # the standing blocks: 1,600 edges each among 12 members, no self-loop
    for b in range(2):
        bs = s.base_src[m_bg + 1600 * b: m_bg + 1600 * (b + 1)]
        bd = s.base_dst[m_bg + 1600 * b: m_bg + 1600 * (b + 1)]
        assert len(set(bs.tolist()) | set(bd.tolist())) == 12 and bool((bs != bd).all())
    assert set(s.base_src[m_bg:m_bg + 1600].tolist()) == set(s.ring.tolist())
    lb = np.log(s.base_amt[m_bg:].numpy().astype(np.float64))
    assert abs(lb.mean() - 3.5) < 0.02 and abs(lb.std() - 0.3) < 0.02


def test_bench_stream_burst_is_the_join_case():
    s = draw(7, burst_at=3)
    src, dst, amt = s.tick(3)
    actor = s.n
    lanes = (src == actor) | (dst == actor)
    assert int(lanes.sum()) == 300
    idx = torch.nonzero(lanes).flatten()
    assert int(idx[-1] - idx[0]) == 299  # one run of lanes in the tick
    other = torch.where(src[lanes] == actor, dst[lanes], src[lanes])
    assert set(other.tolist()) <= set(s.ring.tolist())
    assert 0.3 < float((src[lanes] == actor).float().mean()) < 0.7  # both directions
    assert abs(float(amt[lanes].double().log().mean()) - 5.0) < 0.1
    for t in (0, 1, 2, 4, 9):  # no other tick carries the actor
        a, b, _ = s.tick(t)
        assert not bool(((a == actor) | (b == actor)).any())
    ref = numpy_stream.make_transaction_stream(n=3000, m=15000, seed=1)
    assert ref["n_vertices"] == 3001 and s.n_vertices == N + 1


def test_bench_stream_same_seed_same_stream():
    a, b = draw(2**33 + 5), draw(2**33 + 5)
    for x, y in ((a.base_src, b.base_src), (a.base_dst, b.base_dst), (a.base_amt, b.base_amt)):
        assert torch.equal(x, y)
    later = b.chunk(2)  # chunks do not depend on the order they are drawn in
    for x, y in zip(a.chunk(0) + a.chunk(1) + a.chunk(2), b.chunk(0) + b.chunk(1) + later):
        assert torch.equal(x, y)
    c = draw(2**33 + 6)
    assert not torch.equal(a.base_dst, c.base_dst)
    assert not torch.equal(a.chunk(0)[0], a.chunk(1)[0])
