"""Concrete GNN graph batches of the port (port of ``_graph_batch`` in
``repro/launch/cells.py``; the rest of that module waits for ROADMAP A.11.4).

:func:`graph_batch` draws the same arrays as the reference from the same
seed: one ``numpy`` Generator consumed in the reference's order (``src``,
``dst``, triplets, ``node_feat``, ``edge_feat``, ``labels``,
``tri_angle``, ``edge_len``), then moved to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models.gnn import GraphBatch, make_triplets

__all__ = ["graph_batch"]


def _round_up(x: int, m: int = 512) -> int:
    return -(-int(x) // m) * m


def _graph_size(cfg: GNNConfig, spec: ShapeSpec) -> tuple[int, int, int]:
    """(nodes, edges, feature width) of ``spec``'s batch: a sampled block's
    worst case for ``graph_mini`` (seeds plus fanout expansion), all graphs
    of a ``graph_batch``; node and edge counts rounded up to 512."""
    if spec.kind == "graph_mini":
        e1 = spec.batch_nodes * spec.fanout[0]
        e2 = e1 * spec.fanout[1] if len(spec.fanout) > 1 else 0
        E = e1 + e2
        N = spec.batch_nodes + E  # every sampled edge can introduce a new node
    elif spec.kind == "graph_batch":
        N, E = spec.n_nodes * spec.n_graphs, spec.n_edges * spec.n_graphs
    else:
        N, E = spec.n_nodes, spec.n_edges
    return _round_up(N), _round_up(E), spec.d_feat if spec.d_feat else cfg.d_feat


def graph_batch(cfg: GNNConfig, spec: ShapeSpec, seed: int,
                device: str | torch.device | None = None) -> GraphBatch:
    """A uniform random graph of ``spec``'s size for ``cfg`` on ``device``
    (default ``cuda``, raising without a GPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    N, E, F = _graph_size(cfg, spec)
    Fe = 4 if cfg.kind == "meshgraphnet" else 0
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    if cfg.kind == "dimenet":
        ti, to, tm = make_triplets(src, dst, cfg.triplet_cap_per_edge, rng)
    else:
        ti = to = np.zeros(1, np.int32)
        tm = np.zeros(1, bool)
    node_feat = rng.normal(size=(N, F)).astype(np.float32)
    edge_feat = rng.normal(size=(E, Fe)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, N).astype(np.int32)
    tri_angle = rng.uniform(0, np.pi, ti.shape[0]).astype(np.float32)
    edge_len = rng.uniform(0.5, 4.0, E).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(dev)
    return GraphBatch(
        node_feat=put(node_feat), edge_src=put(src), edge_dst=put(dst),
        edge_mask=torch.ones(E, dtype=torch.bool, device=dev),
        node_mask=torch.ones(N, dtype=torch.bool, device=dev),
        edge_feat=put(edge_feat), labels=put(labels), tri_in=put(ti), tri_out=put(to),
        tri_angle=put(tri_angle), tri_mask=put(tm), edge_len=put(edge_len))
