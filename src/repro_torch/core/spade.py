"""The Spade public API (paper Listing 1), host plane.

The port's copy of ``repro.core.spade``: pure NumPy and Python, with the
same edge grouping and the same ``w0`` bookkeeping.  ``Spade`` wraps the
exact incremental engine (:mod:`repro_torch.core.reference`) with the
developer-facing surface from the paper:

* ``VSusp`` / ``ESusp``      — plug in fraud semantics (or pass a
  :class:`~repro_torch.core.semantics.SuspSemantics` / a registered name /
  a host-only :class:`~repro_torch.core.metrics.DensityMetric`).  A
  ``SuspSemantics`` is compiled into the host funnel through its
  :meth:`~repro_torch.core.semantics.SuspSemantics.host_metric` adapter —
  the same definition the device engine compiles, so this class is a thin
  adapter over the semantics plane.
* ``Detect``                 — current fraudulent community S^P.
* ``InsertEdge`` / ``InsertBatchEdges`` — incremental maintenance.
* ``DeleteEdge``             — incremental deletion (Appendix C.1); with
  inserts this composes into time-window detection (C.3).
* ``TurnOnEdgeGrouping``     — benign/urgent routing (§4.3, Def 4.1):
  benign edges queue in a buffer, urgent edges flush the buffer and trigger
  immediate reordering.

The class maintains ``w0[u] = w_u(S_0)`` (full-graph peeling weight)
incrementally in O(1) per edge for the benign test, and a conservative
cache of ``g(S^P)`` that is refreshed exactly by every ``Detect``/reorder.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from .metrics import DensityMetric, make_metric, quantize_susp
from .reference import (
    AdjGraph,
    PeelState,
    ReorderStats,
    delete_edge,
    detect,
    insert_edges,
    static_peel,
)

__all__ = ["Spade", "InsertResult"]


@dataclass
class InsertResult:
    """Outcome of one Insert call."""

    fraudsters: np.ndarray  # current community S^P (vertex ids)
    g_best: float
    triggered: bool  # did this call run a reorder (False: buffered benign)
    buffered: int  # edges currently waiting in the benign buffer
    new_fraudsters: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int64)
    )
    stats: ReorderStats | None = None
    reorder_seconds: float = 0.0


class Spade:
    """Real-time fraud detection on an evolving transaction graph."""

    def __init__(self, metric="FD", edge_grouping: bool = False):
        # accepts a registered name, a SuspSemantics, or a DensityMetric —
        # make_metric funnels all three through the one semantics registry
        self._metric = make_metric(metric)
        self._g = AdjGraph(0)
        self._state: PeelState | None = None
        self._edge_grouping = bool(edge_grouping)
        self._benign_edges: list[tuple[int, int, float]] = []
        self._benign_new_vertices: list[tuple[int, float]] = []
        self._w0 = np.zeros(0, dtype=np.float64)  # w_u(S_0), maintained O(1)/edge
        self._known = np.zeros(0, dtype=bool)
        self._prev_community: set[int] = set()

    # -- paper API -----------------------------------------------------------

    def VSusp(self, fn) -> None:
        self._metric = DensityMetric(self._metric.name, fn, self._metric.esusp)

    def ESusp(self, fn) -> None:
        self._metric = DensityMetric(self._metric.name, self._metric.vsusp, fn)

    def TurnOnEdgeGrouping(self) -> None:
        self._edge_grouping = True

    def LoadGraph(
        self,
        src: Sequence[int],
        dst: Sequence[int],
        raw_weight: Sequence[float] | None = None,
        n_vertices: int | None = None,
    ) -> None:
        """Build the initial graph and run the static peel (Algorithm 1)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        raw = (
            np.asarray(raw_weight, dtype=np.float64)
            if raw_weight is not None
            else np.ones(src.shape[0])
        )
        n = int(n_vertices if n_vertices is not None else (max(src.max(initial=-1), dst.max(initial=-1)) + 1))
        g = AdjGraph(n)
        for u in range(n):
            g.a[u] = self._metric.vertex_susp(u, g)
        for u, v, r in zip(src.tolist(), dst.tolist(), raw.tolist()):
            g.add_edge(int(u), int(v), self._metric.edge_susp(int(u), int(v), float(r), g))
        self._g = g
        self._state = static_peel(g)
        self._w0 = self._recompute_w0()
        detect(self._state)
        self._prev_community = set(self.Detect()[0].tolist())

    def Detect(self) -> tuple[np.ndarray, float]:
        """Current fraudulent community S^P and its density g(S^P)."""
        self._require_loaded()
        return detect(self._state)

    def InsertEdge(self, u: int, v: int, raw_weight: float = 1.0) -> InsertResult:
        return self.InsertBatchEdges([(u, v, raw_weight)])

    def InsertBatchEdges(
        self, edges: Iterable[tuple[int, int, float]]
    ) -> InsertResult:
        """Insert transactions; route through edge grouping when enabled."""
        self._require_loaded()
        pending_edges: list[tuple[int, int, float]] = []
        pending_new: list[tuple[int, float]] = []
        any_urgent = False
        for u, v, raw in edges:
            u, v = int(u), int(v)
            pending_new.extend(self._admit_vertices(u, v, pending=pending_new))
            c = self._metric.edge_susp(u, v, float(raw), self._g)
            pending_edges.append((u, v, c))
            # O(1) benign/urgent test (Def 4.1) against the cached g(S^P)
            urgent = (
                self._w0_of(u) + c >= self._state.g_best_cache
                or self._w0_of(v) + c >= self._state.g_best_cache
            )
            self._w0_add(u, c)
            self._w0_add(v, c)
            any_urgent = any_urgent or urgent

        if self._edge_grouping and not any_urgent:
            self._benign_edges.extend(pending_edges)
            self._benign_new_vertices.extend(pending_new)
            return InsertResult(
                fraudsters=np.empty(0, dtype=np.int64),
                g_best=self._state.g_best_cache,
                triggered=False,
                buffered=len(self._benign_edges),
            )

        # urgent (or grouping off): flush buffer + this batch, reorder now
        batch_edges = self._benign_edges + pending_edges
        batch_new = self._benign_new_vertices + pending_new
        self._benign_edges, self._benign_new_vertices = [], []
        return self._reorder_and_detect(batch_edges, batch_new)

    def DeleteEdge(self, u: int, v: int, c: float | None = None) -> InsertResult:
        """Delete (all or ``c`` of) the combined edge weight between ``u``
        and ``v`` and reorder incrementally (paper Appendix C.1).

        ``c`` is in *suspiciousness units* — the stored adjacency weight,
        i.e. what ``ESusp`` returned at arrival time (for DW that is the
        grid-snapped raw amount; for FD the arrival-time degree weighting,
        which cannot be recomputed from a raw amount later).  It is
        snapped to the same dyadic grid as every stored weight, so passing
        the original raw DW amount deletes the edge exactly instead of
        tripping the more-than-present check or leaving a sub-quantum
        residual edge.

        The benign buffer is flushed first: a buffered edge may be the one
        being expired, and the deletion invalidates the cached g(S^P) the
        buffered edges were classified against — flushing re-anchors both.
        Composed with ``InsertEdge`` this is the paper's C.3 time-window
        maintenance on the host plane.
        """
        self._require_loaded()
        if self._benign_edges or self._benign_new_vertices:
            self.FlushBuffer()
        u, v = int(u), int(v)
        if u >= self._g.n or v >= self._g.n:
            # match delete_edge's missing-edge contract instead of letting
            # the adjacency lookup die with a bare IndexError
            raise KeyError(f"no edge between {u} and {v}")
        if c is not None:
            c = quantize_susp(float(c))
        w_before = self._g.adj[u].get(v, 0.0)
        t0 = time.perf_counter()
        stats = delete_edge(self._state, u, v, c)
        dt = time.perf_counter() - t0
        w_removed = w_before - self._g.adj[u].get(v, 0.0)
        # O(1) w0 maintenance, mirroring the insert path's increment
        self._w0_add(u, -w_removed)
        self._w0_add(v, -w_removed)
        comm, gb = detect(self._state)
        comm_set = set(comm.tolist())
        new_f = np.asarray(sorted(comm_set - self._prev_community), dtype=np.int64)
        self._prev_community = comm_set
        return InsertResult(
            fraudsters=comm,
            g_best=gb,
            triggered=True,
            buffered=0,
            new_fraudsters=new_f,
            stats=stats,
            reorder_seconds=dt,
        )

    def FlushBuffer(self) -> InsertResult:
        """Force-process all buffered benign edges (periodic batch tick)."""
        self._require_loaded()
        batch_edges, batch_new = self._benign_edges, self._benign_new_vertices
        self._benign_edges, self._benign_new_vertices = [], []
        if not batch_edges and not batch_new:
            comm, gb = self.Detect()
            return InsertResult(comm, gb, triggered=False, buffered=0)
        return self._reorder_and_detect(batch_edges, batch_new)

    # -- internals -------------------------------------------------------------

    @property
    def graph(self) -> AdjGraph:
        return self._g

    @property
    def state(self) -> PeelState:
        self._require_loaded()
        return self._state

    @property
    def metric(self) -> DensityMetric:
        return self._metric

    @property
    def buffered_edges(self) -> int:
        return len(self._benign_edges)

    def _require_loaded(self) -> None:
        if self._state is None:
            raise RuntimeError("call LoadGraph first")

    def _admit_vertices(
        self, *vids: int, pending: Sequence[tuple[int, float]] = ()
    ) -> list[tuple[int, float]]:
        """Vertices not yet in the graph are scheduled for head insertion.

        ``pending`` holds vertices already admitted by earlier edges of the
        *current* batch (they are not yet in ``_benign_new_vertices``), so
        a batch introducing several new vertices via separate edges counts
        them toward the next dense id.
        """
        out: list[tuple[int, float]] = []
        for vid in sorted(set(vids)):
            next_id = (
                self._g.n + len(out) + len(pending) + len(self._benign_new_vertices)
            )
            if vid > next_id:
                # ids must arrive densely; generators guarantee this
                raise ValueError(f"vertex id {vid} skips ahead of next id {next_id}")
            if vid >= self._g.n:
                already = (
                    any(x[0] == vid for x in self._benign_new_vertices)
                    or any(x[0] == vid for x in pending)
                    or any(x[0] == vid for x in out)
                )
                if not already:
                    a = self._metric.vertex_susp(vid, self._g)
                    out.append((vid, a))
                    self._w0_add(vid, a)
        return out

    def _reorder_and_detect(
        self,
        batch_edges: list[tuple[int, int, float]],
        batch_new: list[tuple[int, float]],
    ) -> InsertResult:
        t0 = time.perf_counter()
        stats = insert_edges(self._state, batch_edges, batch_new)
        dt = time.perf_counter() - t0
        comm, gb = detect(self._state)
        comm_set = set(comm.tolist())
        new_f = np.asarray(sorted(comm_set - self._prev_community), dtype=np.int64)
        self._prev_community = comm_set
        return InsertResult(
            fraudsters=comm,
            g_best=gb,
            triggered=True,
            buffered=0,
            new_fraudsters=new_f,
            stats=stats,
            reorder_seconds=dt,
        )

    def _recompute_w0(self) -> np.ndarray:
        from .reference import peeling_weights_full

        w0 = np.zeros(max(self._g.n, 1), dtype=np.float64)
        w0[: self._g.n] = peeling_weights_full(self._g)
        return w0

    def _w0_of(self, u: int) -> float:
        if u >= self._w0.shape[0]:
            return 0.0
        return float(self._w0[u])

    def _w0_add(self, u: int, c: float) -> None:
        if u >= self._w0.shape[0]:
            grow = max(256, u + 1 - self._w0.shape[0])
            self._w0 = np.concatenate([self._w0, np.zeros(grow)])
        self._w0[u] += c
