"""Fanout neighbor sampler (GraphSAGE-style) for ``minibatch_lg`` (a numpy
copy of ``repro/graphstore/sampler.py``: the same seed gives the same
arrays).

Produces fixed-shape sampled subgraphs (every batch has identical shapes;
short neighborhoods are padded with self-edges of weight 0).  The CSR
neighbor table lives on the host (NumPy): sampling is a data-pipeline
stage, the sampled block is what goes to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CSRNeighbors", "SampledBlock", "build_csr_neighbors", "sample_fanout"]


@dataclass
class CSRNeighbors:
    indptr: np.ndarray  # int64 [n+1]
    indices: np.ndarray  # int32 [m]
    n: int


@dataclass
class SampledBlock:
    """Fixed-shape k-hop sampled subgraph.

    ``nodes``: unique node ids, seeds first (padded with -1 -> mapped to 0).
    ``edge_src/edge_dst``: local indices into ``nodes``; ``edge_mask``
    marks real edges.  Shapes depend only on (batch, fanouts).
    """

    nodes: np.ndarray
    seeds: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    node_mask: np.ndarray


def build_csr_neighbors(n: int, src: np.ndarray, dst: np.ndarray) -> CSRNeighbors:
    order = np.argsort(dst, kind="stable")
    s = np.asarray(src, np.int32)[order]
    d = np.asarray(dst)[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, d + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRNeighbors(indptr=indptr, indices=s, n=n)


def sample_fanout(
    csr: CSRNeighbors,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    rng: np.random.Generator,
) -> SampledBlock:
    """Uniform fanout sampling; fixed shapes for all batches."""
    seeds = np.asarray(seeds, np.int64)
    frontier = seeds
    all_src, all_dst = [], []
    for f in fanouts:
        deg = csr.indptr[frontier + 1] - csr.indptr[frontier]
        # sample f neighbors per frontier node (with replacement; deg==0 -> self)
        offs = (rng.random((frontier.shape[0], f)) * np.maximum(deg, 1)[:, None]).astype(
            np.int64
        )
        nbr = csr.indices[csr.indptr[frontier][:, None] + offs].astype(np.int64)
        nbr = np.where(deg[:, None] > 0, nbr, frontier[:, None])  # self-pad
        src = nbr.reshape(-1)
        dst = np.repeat(frontier, f)
        all_src.append(src)
        all_dst.append(dst)
        frontier = np.unique(src)

    src = np.concatenate(all_src)
    dst = np.concatenate(all_dst)
    nodes, inv = np.unique(np.concatenate([seeds, src, dst]), return_inverse=True)
    # stable remap with seeds first
    seed_pos = np.searchsorted(nodes, seeds)
    perm = np.concatenate([seed_pos, np.setdiff1d(np.arange(nodes.shape[0]), seed_pos)])
    rank = np.empty_like(perm)
    rank[perm] = np.arange(perm.shape[0])
    nodes_ordered = nodes[perm]
    local = rank[inv]
    k = seeds.shape[0]
    return SampledBlock(
        nodes=nodes_ordered.astype(np.int64),
        seeds=np.arange(k, dtype=np.int64),
        edge_src=local[k : k + src.shape[0]].astype(np.int32),
        edge_dst=local[k + src.shape[0] :].astype(np.int32),
        edge_mask=np.ones(src.shape[0], dtype=bool),
        node_mask=np.ones(nodes_ordered.shape[0], dtype=bool),
    )
