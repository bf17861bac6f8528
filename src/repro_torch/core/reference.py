"""Exact host-plane reference implementation of Spade (paper-faithful oracle).

A verbatim copy of ``repro.core.reference`` (pure NumPy and ``heapq``), kept
in the port so that it never imports the JAX package; the same input gives
the same peel order and bit-identical ``delta`` in both
(``tests/test_torch_host_plane.py`` pins it).  It implements, on the host
CPU:

* **Algorithm 1** — the static peeling paradigm (Charikar-style greedy):
  iteratively remove the vertex with the smallest *peeling weight*
  ``w_u(S) = a_u + sum of incident edge suspiciousness within S`` and record
  the peeling sequence ``O`` and the peel-time weights ``Delta``.
* **Algorithm 2** — incremental peeling-sequence reordering in batch
  (the paper's core contribution): on edge insertions, only an *affected
  area* is re-examined using a pending priority queue ``T`` and black/gray/
  white coloring; the untouched prefix (Lemma 4.1) and the untouched tail
  are kept in place.

The port's device plane (``core.peel``: the torch ``exact_peel`` and the
bulk peels, and the CUDA kernels under them) is held against this module.

Determinism contract
--------------------
All vertex selections are ordered by the lexicographic key ``(weight, id)``
so that the incremental reorder provably reproduces the from-scratch
sequence even in the presence of ties.  Host arithmetic is float64; property
tests draw integer weights so cross-plane (float32 device) comparisons are
exact.

Density bookkeeping contract
----------------------------
``order``/``delta``/adjacency/``f0`` are *always exact* after each update
(this is what correctness proofs need).  Density sequences ``f(S_m)`` /
``g(S_m)`` are **derived on demand** in ``detect`` via one vectorized pass
(O(n) NumPy, milliseconds at millions of vertices), mirroring the paper's
C++ design which stores only ``_seq`` and ``_weight``.  The cached best
density used by the benign/urgent test is therefore conservative (never
stale-high in a way that hides fraud: a stale-low bound only makes *more*
edges urgent).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

import numpy as np

__all__ = [
    "AdjGraph",
    "PeelState",
    "ReorderStats",
    "static_peel",
    "insert_edges",
    "delete_edge",
    "enumerate_communities",
    "detect",
    "peeling_weights_full",
]


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------


class AdjGraph:
    """Directed multigraph with per-vertex suspiciousness, stored undirected-
    combined for peeling (peeling weights are direction-agnostic, Eq. 2).

    ``adj[u][v]`` accumulates the total suspiciousness of all edges between
    ``u`` and ``v`` in either direction.  ``a[u]`` is the vertex
    suspiciousness. ``out_deg``/``in_deg`` track raw directed edge counts
    (used by e.g. Fraudar's column-weighting ``esusp``).
    """

    __slots__ = ("n", "adj", "a", "out_deg", "in_deg", "edge_weight_total", "m")

    def __init__(self, n: int = 0):
        self.n = int(n)
        self.adj: list[dict[int, float]] = [dict() for _ in range(self.n)]
        self.a = np.zeros(self.n, dtype=np.float64)
        self.out_deg = np.zeros(self.n, dtype=np.int64)
        self.in_deg = np.zeros(self.n, dtype=np.int64)
        self.edge_weight_total = 0.0
        self.m = 0  # directed edge count (multi-edges counted)

    # -- construction ------------------------------------------------------

    def add_vertex(self, a: float = 0.0) -> int:
        uid = self.n
        self.n += 1
        self.adj.append(dict())
        if self.a.shape[0] < self.n:
            grow = max(256, self.n)
            self.a = np.concatenate([self.a, np.zeros(grow)])
            self.out_deg = np.concatenate([self.out_deg, np.zeros(grow, np.int64)])
            self.in_deg = np.concatenate([self.in_deg, np.zeros(grow, np.int64)])
        self.a[uid] = float(a)
        return uid

    def add_edge(self, u: int, v: int, c: float) -> None:
        """Insert a directed edge with suspiciousness ``c > 0``."""
        if c <= 0:
            raise ValueError(f"edge suspiciousness must be > 0, got {c}")
        self.adj[u][v] = self.adj[u].get(v, 0.0) + c
        if u != v:
            self.adj[v][u] = self.adj[v].get(u, 0.0) + c
        self.out_deg[u] += 1
        self.in_deg[v] += 1
        self.edge_weight_total += c
        self.m += 1

    # -- queries -----------------------------------------------------------

    def f_total(self) -> float:
        """f(V): total suspiciousness of the whole graph (Eq. 1)."""
        return float(self.a[: self.n].sum()) + self.edge_weight_total

    def incident_weight(self, u: int) -> float:
        return sum(self.adj[u].values())

    def copy(self) -> "AdjGraph":
        g = AdjGraph(0)
        g.n = self.n
        g.adj = [dict(d) for d in self.adj]
        g.a = self.a.copy()
        g.out_deg = self.out_deg.copy()
        g.in_deg = self.in_deg.copy()
        g.edge_weight_total = self.edge_weight_total
        g.m = self.m
        return g

    @staticmethod
    def from_arrays(
        n: int,
        src: np.ndarray,
        dst: np.ndarray,
        c: np.ndarray,
        a: np.ndarray | None = None,
    ) -> "AdjGraph":
        g = AdjGraph(n)
        if a is not None:
            g.a[:n] = np.asarray(a, dtype=np.float64)
        for u, v, w in zip(
            np.asarray(src).tolist(), np.asarray(dst).tolist(), np.asarray(c).tolist()
        ):
            g.add_edge(int(u), int(v), float(w))
        return g


def peeling_weights_full(g: AdjGraph) -> np.ndarray:
    """w_u(S_0) = a_u + total incident suspiciousness, for every vertex."""
    w = g.a[: g.n].copy()
    for u in range(g.n):
        w[u] += sum(g.adj[u].values())
    return w


# ---------------------------------------------------------------------------
# Peel state
# ---------------------------------------------------------------------------

_HEADROOM = 1024  # buffer slots reserved in front for prepended new vertices


@dataclass
class PeelState:
    """Peeling sequence + peel-time weights over an :class:`AdjGraph`.

    Buffers are stored with a ``head`` offset so that vertex prepends (new
    vertices go to the head of the sequence, §4.1) are O(1).  ``pos_abs[u]``
    is the absolute buffer index of ``u``; its *rank* is
    ``pos_abs[u] - head``.
    """

    graph: AdjGraph
    order_buf: np.ndarray  # int64, vertex ids, valid in [head, head+n)
    delta_buf: np.ndarray  # float64, peel-time weights, aligned with order_buf
    pos_abs: np.ndarray  # int64, vertex id -> absolute buffer index
    head: int
    # conservative cache of the best community density (refreshed by detect())
    g_best_cache: float = 0.0

    @property
    def n(self) -> int:
        return self.graph.n

    def rank(self, u: int) -> int:
        return int(self.pos_abs[u]) - self.head

    def order(self) -> np.ndarray:
        """The peeling sequence O as a length-n array of vertex ids."""
        return self.order_buf[self.head : self.head + self.n]

    def delta(self) -> np.ndarray:
        """Peel-time weights Delta_i aligned with :meth:`order`."""
        return self.delta_buf[self.head : self.head + self.n]

    def _ensure_capacity(self, extra_head: int, extra_tail: int) -> None:
        need_head = extra_head - self.head
        cur_cap = self.order_buf.shape[0]
        need_tail = (self.head + self.n + extra_tail) - cur_cap
        if need_head <= 0 and need_tail <= 0:
            return
        grow_head = max(need_head, 0) + _HEADROOM
        grow_tail = max(need_tail, 0) + _HEADROOM
        new_cap = cur_cap + grow_head + grow_tail
        ob = np.empty(new_cap, dtype=np.int64)
        db = np.empty(new_cap, dtype=np.float64)
        ob[grow_head + self.head : grow_head + self.head + self.n] = self.order_buf[
            self.head : self.head + self.n
        ]
        db[grow_head + self.head : grow_head + self.head + self.n] = self.delta_buf[
            self.head : self.head + self.n
        ]
        self.order_buf, self.delta_buf = ob, db
        self.pos_abs = self.pos_abs + grow_head
        self.head += grow_head


@dataclass
class ReorderStats:
    """Affected-area instrumentation for one ``insert_edges`` call."""

    n_inserted_edges: int = 0
    n_new_vertices: int = 0
    n_pending: int = 0  # vertices that entered the pending queue T (|V_T|)
    n_edges_scanned: int = 0  # adjacency entries touched (|E_T|)
    n_appended_moved: int = 0  # vertices written back in processed windows
    n_windows: int = 0
    n_heap_ops: int = 0


# ---------------------------------------------------------------------------
# Algorithm 1: static peeling
# ---------------------------------------------------------------------------


def static_peel(g: AdjGraph) -> PeelState:
    """Run the peeling paradigm (Algorithm 1) from scratch.

    O(|E| log |V|) with a lazy-deletion binary heap.  Ties broken by vertex
    id (lexicographic ``(weight, id)`` key).
    """
    n = g.n
    w = peeling_weights_full(g)
    heap: list[tuple[float, int]] = [(w[u], u) for u in range(n)]
    heapq.heapify(heap)
    removed = np.zeros(n, dtype=bool)

    cap = n + 2 * _HEADROOM
    order_buf = np.empty(cap, dtype=np.int64)
    delta_buf = np.empty(cap, dtype=np.float64)
    pos_abs = np.empty(n, dtype=np.int64)
    head = _HEADROOM

    for step in range(n):
        while True:
            wu, u = heapq.heappop(heap)
            if not removed[u] and wu == w[u]:
                break
        removed[u] = True
        order_buf[head + step] = u
        delta_buf[head + step] = wu
        pos_abs[u] = head + step
        for v, c in g.adj[u].items():
            if not removed[v]:
                w[v] -= c
                heapq.heappush(heap, (w[v], v))

    state = PeelState(g, order_buf, delta_buf, pos_abs, head)
    # initialize the density cache exactly
    detect(state)
    return state


# ---------------------------------------------------------------------------
# Detection (argmax_g over the peel sequence) — vectorized, on demand
# ---------------------------------------------------------------------------


def detect(state: PeelState) -> tuple[np.ndarray, float]:
    """Return (community vertex ids S^P, g(S^P)).

    ``f(S_m) = sum_{j >= m} Delta_j`` (suffix sum of peel-time weights);
    ``g(S_m) = f(S_m) / (n - m)``; the best prefix set is returned.
    One vectorized O(n) pass; refreshes ``state.g_best_cache`` exactly.
    """
    n = state.n
    if n == 0:
        return np.empty(0, dtype=np.int64), 0.0
    delta = state.delta()
    f_suffix = np.cumsum(delta[::-1])[::-1]  # f_suffix[m] = f(S_m)
    sizes = n - np.arange(n)
    gseq = f_suffix / sizes
    best_m = int(np.argmax(gseq))
    g_best = float(gseq[best_m])
    state.g_best_cache = g_best
    return state.order()[best_m:].copy(), g_best


def density_sequence(state: PeelState) -> np.ndarray:
    """g(S_m) for m = 0..n-1 (diagnostics / tests)."""
    delta = state.delta()
    f_suffix = np.cumsum(delta[::-1])[::-1]
    return f_suffix / (state.n - np.arange(state.n))


# ---------------------------------------------------------------------------
# Algorithm 2: incremental peeling-sequence reordering in batch
# ---------------------------------------------------------------------------


def insert_edges(
    state: PeelState,
    edges: Sequence[tuple[int, int, float]],
    new_vertices: Sequence[tuple[int, float]] = (),
    stats: ReorderStats | None = None,
) -> ReorderStats:
    """Insert a batch of suspiciousness-weighted edges and reorder in place.

    Implements Algorithm 2 (batch reordering with black/gray/white coloring
    and peeling-weight recovery), generalized to also admit new vertices
    (prepended at the head of the sequence and treated as black so they sink
    to their correct position — this preserves *exact* equality with the
    from-scratch sequence, unlike a bare head insertion).

    Args:
      state: peel state; mutated in place (graph, order, delta, pos).
      edges: ``(u, v, c)`` directed edges with suspiciousness ``c > 0``;
        endpoints must already exist (use ``new_vertices`` first).
      new_vertices: ``(vertex_id, a)`` — ids must be exactly
        ``state.n, state.n+1, ...`` in order.
      stats: optional stats object to accumulate into.

    Returns the :class:`ReorderStats` for this call.
    """
    st = stats if stats is not None else ReorderStats()
    g = state.graph

    # ---- 0. apply new vertices (head prepend, colored black) -------------
    new_ids: list[int] = []
    for vid, a in new_vertices:
        got = g.add_vertex(a)
        if got != vid:
            raise ValueError(f"new vertex ids must be dense: expected {got}, got {vid}")
        new_ids.append(got)
    if new_ids:
        state._ensure_capacity(len(new_ids), 0)
        if state.pos_abs.shape[0] < g.n:
            grow = max(256, g.n - state.pos_abs.shape[0])
            state.pos_abs = np.concatenate(
                [state.pos_abs, np.zeros(grow, dtype=np.int64)]
            )
        # prepend in reverse so earlier ids sit earlier in the sequence
        for vid in reversed(new_ids):
            state.head -= 1
            state.order_buf[state.head] = vid
            # delta = a: recovery adds edge terms on top of the stored value.
            state.delta_buf[state.head] = g.a[vid]
            state.pos_abs[vid] = state.head
    st.n_new_vertices += len(new_ids)

    # ---- 1. apply edges to the graph --------------------------------------
    new_inc: dict[int, list[tuple[int, float]]] = {}
    for u, v, c in edges:
        g.add_edge(u, v, c)
        new_inc.setdefault(u, []).append((v, float(c)))
        if v != u:
            new_inc.setdefault(v, []).append((u, float(c)))
    st.n_inserted_edges += len(edges)

    dirty = set(new_inc.keys()) | set(new_ids)
    if not dirty:
        return st

    # ---- 2. reorder --------------------------------------------------------
    _reorder(state, dirty, new_inc, st)
    return st


def _reorder(
    state: PeelState,
    dirty: set[int],
    new_inc: dict[int, list[tuple[int, float]]],
    st: ReorderStats,
) -> None:
    g = state.graph
    n = state.n
    h = state.head
    order_buf = state.order_buf
    delta_buf = state.delta_buf
    pos_abs = state.pos_abs

    blacks = sorted(dirty, key=lambda u: pos_abs[u])
    black_ranks = [int(pos_abs[u]) - h for u in blacks]

    # pending queue T: lexicographic (weight, id); lazy deletion via wT
    T: list[tuple[float, int]] = []
    wT: dict[int, float] = {}
    in_T: set[int] = set()
    gray: set[int] = set()

    def recover_weight(u: int, k: int) -> float:
        """Current peeling weight of u w.r.t. remaining set T ∪ O[k:].

        = Delta_old(u) + old-edge weights to T members + new-edge weights to
        endpoints still remaining (rank > k, not in T).  ``adj`` already
        contains the new edges, so the T term uses the *updated* adjacency
        (covering new-edges-to-T exactly once) and the new-edge term is
        restricted to endpoints with rank > k outside T.
        """
        w = float(delta_buf[pos_abs[u]])
        au = g.adj[u]
        # old+new edges to pending vertices
        if len(in_T) < len(au):
            for v in in_T:
                c = au.get(v)
                if c is not None and v != u:
                    w += c
            st.n_edges_scanned += len(in_T)
        else:
            for v, c in au.items():
                if v in in_T:
                    w += c
            st.n_edges_scanned += len(au)
        # new edges to not-yet-scanned endpoints
        for v, c in new_inc.get(u, ()):
            if v not in in_T and (int(pos_abs[v]) - h) > k and v != u:
                w += c
        return w

    def push(u: int, w: float) -> None:
        wT[u] = w
        in_T.add(u)
        heapq.heappush(T, (w, u))
        st.n_heap_ops += 1
        st.n_pending += 1
        # color neighbors gray (affected-area frontier)
        gray.update(g.adj[u].keys())
        st.n_edges_scanned += len(g.adj[u])

    def pop_min() -> tuple[float, int]:
        while True:
            w, u = T[0]
            if u in in_T and wT[u] == w:
                heapq.heappop(T)
                st.n_heap_ops += 1
                in_T.discard(u)
                del wT[u]
                return w, u
            heapq.heappop(T)
            st.n_heap_ops += 1

    bi = 0  # index into blacks
    k = black_ranks[0] if black_ranks else n  # scan pointer (rank)
    newO: list[int] = []
    newD: list[float] = []
    w_start = k  # window start rank

    def flush(k_end: int) -> None:
        nonlocal newO, newD
        if not newO:
            return
        assert len(newO) == k_end - w_start, (len(newO), w_start, k_end)
        seg = np.asarray(newO, dtype=np.int64)
        order_buf[h + w_start : h + k_end] = seg
        delta_buf[h + w_start : h + k_end] = np.asarray(newD, dtype=np.float64)
        pos_abs[seg] = np.arange(h + w_start, h + k_end, dtype=np.int64)
        st.n_appended_moved += len(newO)
        st.n_windows += 1
        newO, newD = [], []

    while True:
        # activate any black vertex whose rank the scan pointer reached
        if bi < len(blacks) and k == black_ranks[bi]:
            u = blacks[bi]
            bi += 1
            push(u, recover_weight(u, k))
            k += 1
            continue

        if not in_T:
            # T drained: window closes here; jump to the next black vertex.
            flush(k)
            if bi >= len(blacks):
                break
            k = black_ranks[bi]
            w_start = k
            continue

        wmin, umin = T[0]
        while not (umin in in_T and wT[umin] == wmin):
            heapq.heappop(T)
            st.n_heap_ops += 1
            wmin, umin = T[0]

        if k >= n:
            # old sequence exhausted; drain T
            w, u = pop_min()
            newO.append(u)
            newD.append(w)
            for v, c in g.adj[u].items():
                if v in in_T:
                    wT[v] -= c
                    heapq.heappush(T, (wT[v], v))
                    st.n_heap_ops += 1
            st.n_edges_scanned += len(g.adj[u])
            continue

        uk = int(order_buf[h + k])
        dk = float(delta_buf[h + k])

        if (wmin, umin) < (dk, uk):
            # Case 1: pending head peels first
            w, u = pop_min()
            newO.append(u)
            newD.append(w)
            for v, c in g.adj[u].items():
                if v in in_T:
                    wT[v] -= c
                    heapq.heappush(T, (wT[v], v))
                    st.n_heap_ops += 1
            st.n_edges_scanned += len(g.adj[u])
        elif uk in gray:
            # Case 2(a): affected vertex — recover weight, move to T
            push(uk, recover_weight(uk, k))
            k += 1
        else:
            # Case 2(b): white vertex peels in place
            newO.append(uk)
            newD.append(dk)
            k += 1

    state.head = h  # unchanged (prepends already accounted)


# ---------------------------------------------------------------------------
# Convenience: full recompute for equivalence tests
# ---------------------------------------------------------------------------


def recompute(state: PeelState) -> PeelState:
    """From-scratch peel of the state's current graph (for tests)."""
    return static_peel(state.graph.copy())


# ---------------------------------------------------------------------------
# Appendix C.1: incremental edge deletion
# ---------------------------------------------------------------------------


def delete_edge(
    state: PeelState,
    u: int,
    v: int,
    c: float | None = None,
    stats: ReorderStats | None = None,
) -> ReorderStats:
    """Delete (all or ``c`` of) the edge weight between u and v and reorder
    incrementally (paper Appendix C.1).

    Deletion only *decreases* the endpoints' weights, so vertices may move
    EARLIER.  Phase 1 (downward scan): starting from the earlier endpoint's
    position, prefix vertices are pulled into the pending pool while their
    ``w(S_0)`` upper bound exceeds the pool's current exact minimum (the
    minimum is recomputed at each step — weights w.r.t. larger prefixes
    only grow, so the current value lower-bounds all earlier positions,
    making the stop test sound).  Phase 2: the forward merge of Algorithm 2
    with exact (direct-recompute) weight recovery.
    """
    st = stats if stats is not None else ReorderStats()
    g = state.graph
    if v not in g.adj[u]:
        raise KeyError(f"no edge between {u} and {v}")
    w_edge = g.adj[u][v] if c is None else float(c)
    if w_edge > g.adj[u][v] + 1e-12:
        raise ValueError("cannot delete more weight than present")
    if abs(g.adj[u][v] - w_edge) < 1e-15:
        del g.adj[u][v]
        if u != v:
            del g.adj[v][u]
    else:
        g.adj[u][v] -= w_edge
        if u != v:
            g.adj[v][u] -= w_edge
    g.edge_weight_total -= w_edge
    st.n_inserted_edges += 1  # counted as one update

    h = state.head
    order_buf, delta_buf, pos_abs = state.order_buf, state.delta_buf, state.pos_abs
    n = state.n
    i_hi = min(state.rank(u), state.rank(v))

    members: set[int] = {u, v}

    def direct_weight(x: int, k: int) -> float:
        """Exact current weight of x w.r.t. members ∪ O[k:] (minus peeled)."""
        w = float(g.a[x])
        for y, cw in g.adj[x].items():
            if y == x:
                continue
            if y in members or (int(pos_abs[y]) - h) >= k:
                w += cw
        st.n_edges_scanned += len(g.adj[x])
        return w

    # --- phase 1: downward scan -------------------------------------------
    # Stop at k0 only when EVERY remaining prefix position certifiably peels
    # before every pool member: lexicographic (Δ_j, id_j) < pool minimum
    # (prefix deltas are unchanged by the deletion — the endpoints sit at
    # ranks >= i_hi).  Violating positions (and everything after them) are
    # pulled into the pool and re-merged in phase 2.
    k0 = i_hi
    while k0 > 0:
        pool_w, pool_id = min((direct_weight(t, k0), t) for t in members)
        dd = delta_buf[h : h + k0]
        oo = order_buf[h : h + k0]
        viol = (dd > pool_w) | ((dd == pool_w) & (oo > pool_id))
        idx = np.nonzero(viol)[0]
        if idx.size == 0:
            break
        j = int(idx.max())
        for kk in range(j, k0):
            members.add(int(order_buf[h + kk]))
        k0 = j

    # --- phase 2: forward merge (Algorithm 2 with exact recovery) ----------
    T: list[tuple[float, int]] = []
    wT: dict[int, float] = {}
    gray: set[int] = set()
    for x in members:
        w = direct_weight(x, k0)
        wT[x] = w
        heapq.heappush(T, (w, x))
        gray.update(g.adj[x].keys())
        st.n_pending += 1
        st.n_heap_ops += 1
    consumed = set(members)

    newO: list[int] = []
    newD: list[float] = []
    k = k0

    def pop_min():
        while True:
            w, x = heapq.heappop(T)
            st.n_heap_ops += 1
            if x in wT and wT[x] == w:
                del wT[x]
                members.discard(x)  # peeled: no longer counts in recovery
                return w, x

    def pop_and_append():
        w, x = pop_min()
        newO.append(x)
        newD.append(w)
        for y, cw in g.adj[x].items():
            if y in wT:
                wT[y] -= cw
                heapq.heappush(T, (wT[y], y))
                st.n_heap_ops += 1
        st.n_edges_scanned += len(g.adj[x])

    while True:
        while k < n and int(order_buf[h + k]) in consumed:
            k += 1
        if not wT:
            break
        if k >= n:
            pop_and_append()
            continue
        uk = int(order_buf[h + k])
        dk = float(delta_buf[h + k])
        wmin, umin = T[0]
        while not (umin in wT and wT[umin] == wmin):
            heapq.heappop(T)
            st.n_heap_ops += 1
            wmin, umin = T[0]
        if (wmin, umin) < (dk, uk):
            pop_and_append()
        elif uk in gray:
            members.add(uk)  # direct_weight counts it as pending
            wT[uk] = direct_weight(uk, k + 1)
            heapq.heappush(T, (wT[uk], uk))
            st.n_heap_ops += 1
            st.n_pending += 1
            gray.update(g.adj[uk].keys())
            consumed.add(uk)
            k += 1
        else:
            newO.append(uk)
            newD.append(dk)
            consumed.add(uk)
            k += 1

    # splice: [k0, k0+len(newO)) := newO, untouched tail (old ranks >= k) follows
    tail_o = order_buf[h + k : h + n].copy()
    tail_d = delta_buf[h + k : h + n].copy()
    seg = np.asarray(newO, dtype=np.int64)
    order_buf[h + k0 : h + k0 + seg.shape[0]] = seg
    delta_buf[h + k0 : h + k0 + seg.shape[0]] = np.asarray(newD)
    order_buf[h + k0 + seg.shape[0] : h + n] = tail_o
    delta_buf[h + k0 + seg.shape[0] : h + n] = tail_d
    pos_abs[order_buf[h + k0 : h + n]] = np.arange(h + k0, h + n)
    st.n_appended_moved += len(newO)
    st.n_windows += 1
    return st


# ---------------------------------------------------------------------------
# Appendix C.2: dense-subgraph enumeration
# ---------------------------------------------------------------------------


def enumerate_communities(g: AdjGraph, max_k: int = 5, min_density: float = 0.0):
    """Recursively peel, report, remove (paper C.2, static form).

    Returns a list of (vertex ids in ORIGINAL numbering, density), in
    discovery (decreasing-density) order.
    """
    work = g.copy()
    ids = np.arange(g.n)  # work-index -> original id
    out = []
    for _ in range(max_k):
        if work.n == 0 or work.f_total() <= 0:
            break
        st = static_peel(work.copy())
        comm, dens = detect(st)
        if dens <= min_density or comm.shape[0] == 0:
            break
        out.append((ids[comm], dens))
        comm_set = set(comm.tolist())
        keep = [x for x in range(work.n) if x not in comm_set]
        if not keep:
            break
        remap = {x: i for i, x in enumerate(keep)}
        g2 = AdjGraph(len(keep))
        g2.a[: len(keep)] = work.a[keep]
        for x in keep:
            for y, cw in work.adj[x].items():
                if y in remap and x < y:
                    g2.add_edge(remap[x], remap[y], cw)
                elif y == x:
                    g2.add_edge(remap[x], remap[x], cw)
        ids = ids[keep]
        work = g2
    return out
