"""Synthetic evolving transaction graphs (the paper's Grab/Amazon/
Wiki-vote/Epinion datasets are stood in for by generators matched to their published statistics:
power-law degree graphs — Fig. 9b — plus injected dense fraud blocks with
timestamps, fraud labels, and a replayable edge stream).

A verbatim numpy copy of ``repro.graphstore.generators``: the port keeps
its own so that it never imports the JAX package, and the same seed gives
byte-identical arrays in both (``tests/test_torch_structs.py`` pins it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TxStream", "make_transaction_stream", "make_power_law_graph", "DATASET_STATS"]

# |V|, |E| of the paper's datasets (Table 3) for scaled-down replicas
DATASET_STATS = {
    "grab1": (3_991_000, 10_000_000),
    "grab2": (4_805_000, 15_000_000),
    "grab3": (5_433_000, 20_000_000),
    "grab4": (6_023_000, 25_000_000),
    "amazon": (28_000, 28_000),
    "wiki_vote": (16_000, 103_000),
    "epinion": (264_000, 841_000),
}


@dataclass
class TxStream:
    """A replayable transaction stream: base graph + timestamped increments.

    ``fraud_label[i]`` marks increment edges generated by an injected
    fraud block (used for latency / prevention-ratio metrics, §4.3).
    """

    n_vertices: int
    base_src: np.ndarray
    base_dst: np.ndarray
    base_amt: np.ndarray
    inc_src: np.ndarray
    inc_dst: np.ndarray
    inc_amt: np.ndarray
    inc_time: np.ndarray  # float64 seconds, increasing
    fraud_label: np.ndarray  # bool
    fraud_block: np.ndarray  # vertex ids of the injected fraud community


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
) -> TxStream:
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
    return TxStream(
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
