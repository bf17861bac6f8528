"""Config dataclasses of every architecture family and their shape specs.

A copy of ``repro/configs/base.py`` (``MoESpec``, ``LMConfig``,
``GNNConfig``, ``RecsysConfig``, ``SpadeConfig``, ``ShapeSpec``,
``LM_SHAPES``, ``GNN_SHAPES``, ``RECSYS_SHAPES``, ``SPADE_SHAPES``), kept
free of ``jax`` and of ``repro``.  Configs are shapes only: no
weights are read from anywhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

__all__ = ["MoESpec", "LMConfig", "GNNConfig", "RecsysConfig", "SpadeConfig", "ShapeSpec",
           "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "SPADE_SHAPES"]


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    expert_parallel: bool = True
    virtual_split: int = 1


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int  # dense FFN width (ignored when moe is set)
    vocab: int
    moe: MoESpec | None = None
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 1e6
    dtype: str = "bfloat16"
    # attention blocking of the plain (CPU) attention path
    q_block: int = 512
    kv_block: int = 1024
    unroll: bool = False

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding + layers + head)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        attn = D * (self.n_heads * self.d_head) * 2 + D * (
            self.n_kv_heads * self.d_head
        ) * 2
        if self.moe:
            ffn = self.moe.n_experts * 3 * D * self.moe.d_ff_expert + D * self.moe.n_experts
        else:
            ffn = 3 * D * F
        norms = 2 * D + (2 * self.d_head if self.qk_norm else 0)
        return V * D * 2 + L * (attn + ffn + norms) + D

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE top-k)."""
        if not self.moe:
            return self.n_params
        D, L = self.d_model, self.n_layers
        attn = D * (self.n_heads * self.d_head) * 2 + D * (
            self.n_kv_heads * self.d_head
        ) * 2
        ffn = self.moe.top_k * 3 * D * self.moe.d_ff_expert + D * self.moe.n_experts
        return self.vocab * D * 2 + L * (attn + ffn + 2 * D) + D


@dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: Literal["gcn", "gat", "meshgraphnet", "dimenet"]
    n_layers: int
    d_hidden: int
    d_feat: int  # input feature dim (overridden per shape)
    n_classes: int = 16
    n_heads: int = 1  # gat
    aggregator: str = "sum"
    mlp_layers: int = 2  # meshgraphnet
    n_bilinear: int = 8  # dimenet
    n_spherical: int = 7
    n_radial: int = 6
    triplet_cap_per_edge: int = 4  # dimenet subsampled triplets at scale
    dtype: str = "float32"


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    embed_dim: int = 256
    tower_mlp: tuple[int, ...] = (1024, 512, 256)
    n_user_fields: int = 8
    n_item_fields: int = 4
    user_vocab: int = 50_000_000
    item_vocab: int = 10_000_000
    multi_hot: int = 16  # lookups per bag (user history etc.)
    interaction: str = "dot"
    dtype: str = "float32"


@dataclass(frozen=True)
class SpadeConfig:
    """The paper's own workload: evolving-graph peeling at Grab scale."""

    name: str
    n_capacity: int
    e_capacity: int
    batch_edges: int = 4096
    eps: float = 0.1
    max_rounds: int = 64


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode", "graph_full", "graph_mini", "graph_batch",
                  "recsys_train", "recsys_serve", "retrieval", "spade_stream", "spade_static"]
    # LM
    seq_len: int = 0
    global_batch: int = 0
    # GNN
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple[int, ...] = ()
    n_graphs: int = 0
    # recsys
    batch: int = 0
    n_candidates: int = 0


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "graph_full", n_nodes=2708, n_edges=10556, d_feat=1433
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg",
        "graph_mini",
        n_nodes=232965,
        n_edges=114615892,
        batch_nodes=1024,
        fanout=(15, 10),
        d_feat=602,
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "graph_full", n_nodes=2449029, n_edges=61859140, d_feat=100
    ),
    "molecule": ShapeSpec(
        "molecule", "graph_batch", n_nodes=30, n_edges=64, n_graphs=128, d_feat=32
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "recsys_train", batch=65536),
    "serve_p99": ShapeSpec("serve_p99", "recsys_serve", batch=512),
    "serve_bulk": ShapeSpec("serve_bulk", "recsys_serve", batch=262144),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000
    ),
}

SPADE_SHAPES = {
    "grab4_static": ShapeSpec("grab4_static", "spade_static", n_nodes=6_023_000,
                              n_edges=25_000_000),
    "grab4_stream": ShapeSpec("grab4_stream", "spade_stream", n_nodes=6_023_000,
                              n_edges=27_500_000),
}
