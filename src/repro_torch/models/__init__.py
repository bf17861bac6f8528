"""Models of the port: the LM's serving half (attention, layers,
transformer) and the GNN zoo's forward (``gnn``)."""

from .attention import decode_attention, flash_attention
from .gnn import GNN, GCNRows, GraphBatch, gcn_rows, gnn_forward, gnn_loss, init_gnn_params
from .transformer import (DecoderLayer, KVCache, TransformerLM, cache_window,
                          decode_step, prefill)

__all__ = ["decode_attention", "flash_attention", "DecoderLayer", "KVCache",
           "TransformerLM", "cache_window", "decode_step", "prefill",
           "GNN", "GCNRows", "GraphBatch", "gcn_rows", "gnn_forward", "gnn_loss",
           "init_gnn_params"]
