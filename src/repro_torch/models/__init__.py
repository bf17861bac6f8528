"""Models of the port: the LM (attention, layers, the MoE FFN, the
transformer's scoring forward and serving entry points), the GNN zoo
(``gnn``) and two-tower retrieval (``two_tower``)."""

from .attention import decode_attention, flash_attention
from .gnn import GNN, GCNRows, GraphBatch, gcn_rows, gnn_forward, gnn_loss, init_gnn_params
from .moe import moe_ffn, router_aux_loss
from .transformer import (DecoderLayer, KVCache, TransformerLM, cache_window,
                          decode_step, forward, lm_loss, prefill)
from .two_tower import (RecsysBatch, init_two_tower_params, item_tower, retrieval_scores,
                        score_pairs, two_tower_loss, user_tower)

__all__ = ["decode_attention", "flash_attention", "DecoderLayer", "KVCache",
           "TransformerLM", "cache_window", "decode_step", "forward", "lm_loss",
           "moe_ffn", "prefill", "router_aux_loss",
           "GNN", "GCNRows", "GraphBatch", "gcn_rows", "gnn_forward", "gnn_loss",
           "init_gnn_params", "RecsysBatch", "init_two_tower_params", "user_tower",
           "item_tower", "two_tower_loss", "score_pairs", "retrieval_scores"]
