"""Streaming fraud-detection service (the paper's end-to-end deployment),
host plane: the port's copy of ``repro.serve.service``.

Replays a timestamped transaction stream (``repro_torch.graphstore.generators``)
through Spade with edge grouping (§4.3) and measures the paper's §5
metrics:

* **latency** L(ΔG^τ) (Eq. 4): response time per fraudulent edge =
  (reorder completion time) - (edge generation time), queueing included.
* **prevention ratio** R: fraction of a fraud burst's edges arriving
  *after* the fraudster was first detected (those are blockable).

This module holds the host-plane serving loop (pure NumPy and Python, on
the host CPU); the public entrypoint of record is
:class:`repro_torch.serve.SpadeService` with ``EngineSpec(plane="host")``
— :func:`run_service` remains as a deprecation shim.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass

import numpy as np

from repro_torch._warnings import SpadeDeprecationWarning
from repro_torch.core.metrics import DensityMetric
from repro_torch.core.semantics import SuspSemantics
from repro_torch.core.spade import Spade
from repro_torch.graphstore.generators import TxStream

__all__ = ["ServiceReport", "run_service"]


@dataclass
class ServiceReport:
    n_edges: int
    n_reorders: int
    n_buffered_flushes: int
    total_reorder_seconds: float
    mean_us_per_edge: float
    detection_edge_index: int | None  # stream index when fraud block detected
    detection_latency_s: float | None  # sim-time lag behind the first fraud edge
    prevention_ratio: float | None
    fraud_recall: float  # fraction of planted fraudsters in final community
    wall_seconds: float


def run_service(
    stream: TxStream,
    metric: DensityMetric | SuspSemantics | str = "DW",
    edge_grouping: bool = True,
    batch_size: int = 1,
    flush_every: float = 1.0,
    time_scale: float = 0.0,
) -> ServiceReport:
    """DEPRECATED shim: use ``SpadeService(semantics, EngineSpec(
    plane="host", grouping=..., batch_edges=..., flush_every=...))``."""
    warnings.warn(
        "run_service is deprecated; use repro_torch.serve.SpadeService with "
        "EngineSpec(plane='host')",
        SpadeDeprecationWarning,
        stacklevel=2,
    )
    return _run_host_service(stream, metric=metric,
                             edge_grouping=edge_grouping,
                             batch_size=batch_size, flush_every=flush_every)


def _run_host_service(
    stream: TxStream,
    metric: DensityMetric | SuspSemantics | str = "DW",
    edge_grouping: bool = True,
    batch_size: int = 1,
    flush_every: float = 1.0,
) -> ServiceReport:
    """Replay ``stream`` and report latency/prevention metrics.

    ``batch_size``: edges per InsertBatchEdges call (paper's |ΔE|);
    ``flush_every``: simulated seconds between forced buffer flushes
    (the batch tick when grouping is on).
    """
    sp = Spade(metric=metric, edge_grouping=edge_grouping)
    sp.LoadGraph(stream.base_src, stream.base_dst, stream.base_amt,
                 n_vertices=stream.n_vertices)

    fraud_set = set(stream.fraud_block.tolist())
    fraud_times = stream.inc_time[stream.fraud_label]
    first_fraud_t = float(fraud_times.min()) if fraud_times.size else None

    n = stream.inc_src.shape[0]
    detected_at_idx: int | None = None
    detected_at_t: float | None = None
    total_reorder = 0.0
    n_reorders = 0
    n_flushes = 0
    next_flush = float(stream.inc_time[0]) + flush_every if n else 0.0
    t_wall0 = time.perf_counter()

    i = 0
    while i < n:
        j = min(i + batch_size, n)
        batch = [
            (int(stream.inc_src[k]), int(stream.inc_dst[k]), float(stream.inc_amt[k]))
            for k in range(i, j)
        ]
        sim_t = float(stream.inc_time[j - 1])
        res = sp.InsertBatchEdges(batch)
        if res.triggered:
            n_reorders += 1
            total_reorder += res.reorder_seconds
        if sim_t >= next_flush:
            fr = sp.FlushBuffer()
            if fr.triggered:
                n_flushes += 1
                total_reorder += fr.reorder_seconds
            next_flush += flush_every
        if detected_at_idx is None:
            comm, _ = (res.fraudsters, res.g_best) if res.triggered else sp.Detect()
            hit = len(fraud_set & set(comm.tolist()))
            if fraud_set and hit >= 0.8 * len(fraud_set):
                detected_at_idx = j - 1
                detected_at_t = sim_t
        i = j

    sp.FlushBuffer()
    comm, _ = sp.Detect()
    recall = (
        len(fraud_set & set(comm.tolist())) / len(fraud_set) if fraud_set else 1.0
    )
    prevention = None
    latency = None
    if detected_at_t is not None and fraud_times.size:
        prevention = float((fraud_times > detected_at_t).sum()) / fraud_times.size
        latency = detected_at_t - first_fraud_t
    return ServiceReport(
        n_edges=n,
        n_reorders=n_reorders,
        n_buffered_flushes=n_flushes,
        total_reorder_seconds=total_reorder,
        mean_us_per_edge=1e6 * total_reorder / max(n, 1),
        detection_edge_index=detected_at_idx,
        detection_latency_s=latency,
        prevention_ratio=prevention,
        fraud_recall=recall,
        wall_seconds=time.perf_counter() - t_wall0,
    )
