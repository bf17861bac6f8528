"""A frozen NumPy copy of the port's Grab-like stream generator.

Copied verbatim from ``src/repro_torch/graphstore/generators.py`` (lines
51-172: ``make_power_law_graph`` and ``make_transaction_stream``), with the
``TxStream`` record reduced to a dict.  The benchmark draws its stream on
the device (``bench/spade/stream.py``); the tests hold that draw's
statistics against this copy at a small size.
"""

from __future__ import annotations

import numpy as np


def make_power_law_graph(
    n: int, m: int, seed: int = 0, alpha: float = 0.9
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Preferential-attachment-flavoured bipartite-ish edge sampler.

    Endpoint popularity ~ Zipf(alpha-ish) so the degree distribution is
    heavy-tailed (paper Fig. 9b).  Returns (src, dst, amount).
    """
    rng = np.random.default_rng(seed)
    # Zipf-like popularity via inverse-rank weights
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    perm_s = rng.permutation(n)
    perm_d = rng.permutation(n)
    src = perm_s[rng.choice(n, size=m, p=p)]
    dst = perm_d[rng.choice(n, size=m, p=p)]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    amt = rng.lognormal(mean=2.0, sigma=1.0, size=src.shape[0])
    return src.astype(np.int64), dst.astype(np.int64), amt.astype(np.float64)


def make_transaction_stream(
    n: int = 20_000,
    m: int = 80_000,
    inc_fraction: float = 0.1,
    fraud_block_size: int = 12,
    fraud_edges: int = 300,
    rate_hz: float = 1000.0,
    seed: int = 0,
    alpha: float = 0.3,
    base_dense_blocks: int = 2,
    base_block_edges: int = 1600,
    scenario: str = "join",
) -> dict:
    """Paper-style experimental setup (Fig 2 / Fig 8): 90% of edges form the
    base graph — including ``base_dense_blocks`` mature dense communities
    (the standing fraudulent ring the detector already reports) — and the
    remaining 10% replay as a timestamped stream.

    ``scenario='join'`` (the paper's case study): a NEW actor performs a
    burst of ``fraud_edges`` fictitious transactions with ring members; it
    is "detected" when it enters the maintained community S^P.  Early burst
    edges are benign under Def 4.1 (the actor's weight is still below
    g(S^P)) and queue in the buffer — reproducing the paper's observation
    that latency is dominated by queueing time, and the prevention ratio =
    fraction of the burst after detection.

    ``scenario='burst'``: a fresh dense block is built from scratch in the
    stream (deal-hunter pattern).
    """
    rng = np.random.default_rng(seed)
    bg_src, bg_dst, bg_amt = make_power_law_graph(n, m, seed=seed, alpha=alpha)
    n_base_bg = int(bg_src.shape[0] * (1 - inc_fraction))
    # base graph = 90% of background + the mature dense communities
    src = bg_src[:n_base_bg]
    dst = bg_dst[:n_base_bg]
    amt = bg_amt[:n_base_bg]
    ring = None
    for b in range(base_dense_blocks):
        blk = rng.choice(n, size=fraud_block_size, replace=False)
        if ring is None:
            ring = blk
        es, ed = [], []
        for _ in range(base_block_edges):
            u, v = rng.choice(blk, size=2, replace=False)
            es.append(u)
            ed.append(v)
        src = np.concatenate([src, es])
        dst = np.concatenate([dst, ed])
        amt = np.concatenate([amt, rng.lognormal(3.5, 0.3, size=len(es))])

    inc_src = bg_src[n_base_bg:].copy()
    inc_dst = bg_dst[n_base_bg:].copy()
    inc_amt = bg_amt[n_base_bg:].copy()
    labels = np.zeros(inc_src.shape[0], dtype=bool)

    if scenario == "join":
        # one new actor (vertex id n) colludes with the standing ring
        actor = n
        fs = np.full(fraud_edges, actor, dtype=np.int64)
        fd = rng.choice(ring, size=fraud_edges).astype(np.int64)
        flip = rng.random(fraud_edges) < 0.5  # both directions occur
        fs2 = np.where(flip, fd, fs)
        fd2 = np.where(flip, fs, fd)
        fs, fd = fs2, fd2
        famt = rng.lognormal(5.0, 0.3, size=fraud_edges)
        fraud_block = np.array([actor], dtype=np.int64)
        n_vertices = n + 1
    else:  # 'burst': fresh dense block built in-stream
        block = rng.choice(n, size=fraud_block_size, replace=False)
        fs = np.empty(fraud_edges, np.int64)
        fd = np.empty(fraud_edges, np.int64)
        for i in range(fraud_edges):
            u, v = rng.choice(block, size=2, replace=False)
            fs[i], fd[i] = u, v
        famt = rng.lognormal(5.0, 0.3, size=fraud_edges)
        fraud_block = np.sort(block)
        n_vertices = n

    insert_at = rng.integers(0, max(inc_src.shape[0] - 1, 1))
    inc_src = np.concatenate([inc_src[:insert_at], fs, inc_src[insert_at:]])
    inc_dst = np.concatenate([inc_dst[:insert_at], fd, inc_dst[insert_at:]])
    inc_amt = np.concatenate([inc_amt[:insert_at], famt, inc_amt[insert_at:]])
    labels = np.concatenate(
        [labels[:insert_at], np.ones(len(fs), bool), labels[insert_at:]]
    )

    t = np.cumsum(rng.exponential(1.0 / rate_hz, size=inc_src.shape[0]))
    return dict(
        n_vertices=n_vertices,
        base_src=src,
        base_dst=dst,
        base_amt=amt,
        inc_src=inc_src.astype(np.int64),
        inc_dst=inc_dst.astype(np.int64),
        inc_amt=inc_amt,
        inc_time=t,
        fraud_label=labels,
        fraud_block=fraud_block,
    )
