"""Graph substrate on torch: fixed-capacity device COO buffers and the
(numpy) transaction-stream generators."""

from .generators import DATASET_STATS, TxStream, make_power_law_graph, make_transaction_stream
from .structs import DeviceGraph, append_edges, device_graph_from_coo, remove_edges

__all__ = [
    "DeviceGraph",
    "device_graph_from_coo",
    "append_edges",
    "remove_edges",
    "TxStream",
    "make_transaction_stream",
    "make_power_law_graph",
    "DATASET_STATS",
]
