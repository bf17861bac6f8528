"""Spade core on PyTorch: peeling algorithms, incremental maintenance, fraud
semantics (the counterpart of ``repro.core``).

Host plane (exact oracle, NumPy): :mod:`repro_torch.core.reference`,
                                  :mod:`repro_torch.core.spade`.
Device plane (torch, CUDA):       :mod:`repro_torch.core.peel`,
                                  :mod:`repro_torch.core.incremental`.
Semantics API:                    :mod:`repro_torch.core.semantics`
                                  (SuspSemantics — one VSusp/ESusp
                                  definition compiled into every engine;
                                  DG / DW / FD as registered instances)
                                  with the host projection in
                                  :mod:`repro_torch.core.metrics`.
"""

from .metrics import DG, DW, FD, DensityMetric, make_fd, make_metric
from .semantics import SuspSemantics, available, register, resolve
from .reference import (
    AdjGraph,
    PeelState,
    ReorderStats,
    delete_edge,
    density_sequence,
    detect,
    enumerate_communities,
    insert_edges,
    peeling_weights_full,
    recompute,
    static_peel,
)
from .spade import InsertResult, Spade

__all__ = [
    "AdjGraph",
    "PeelState",
    "ReorderStats",
    "DensityMetric",
    "SuspSemantics",
    "register",
    "resolve",
    "available",
    "DG",
    "DW",
    "FD",
    "make_fd",
    "make_metric",
    "static_peel",
    "insert_edges",
    "delete_edge",
    "enumerate_communities",
    "detect",
    "density_sequence",
    "peeling_weights_full",
    "recompute",
    "Spade",
    "InsertResult",
]
