"""Device-plane peeling on torch (the counterpart of ``repro.core.peel``).

:func:`exact_peel` is the paper-faithful sequential peel (Algorithm 1, one
vertex per step, the (w, id) tie-break of the host oracle), in plain torch
on the graph's device; the reference's is jnp as well, not a Pallas
kernel.  It has no caller on the serving path: it is the device oracle.

:func:`bulk_peel` is the threshold bulk peel (Bahmani et al.): each round
peels every active vertex with ``w_u <= 2(1+eps) g(S)`` and carries a
``2(1+eps)``-approximation guarantee.  A round (:func:`_round_step`) has two
halves, each one hand-written CUDA kernel on CUDA tensors:

* the edge half, :func:`repro_torch.kernels.frontier_spmv.frontier_spmv` —
  the SpMV over the peeled frontier, the dropped edge mass and the edge
  liveness update;
* the elementwise half, :func:`repro_torch.kernels.peel_round.peel_round` —
  the threshold test, weight subtract, active/level update and the peeled
  mass partials.

**Host reads.**  Eager torch has no ``lax.while_loop`` or ``lax.cond``.
With ``max_rounds > 0`` (the serving default, 20) the round loop is a
Python loop of exactly ``max_rounds`` rounds and reads nothing on the
host: rounds after convergence are no-ops in the reference too
(``n_act = 0`` makes the threshold ``+inf`` over an empty active set).
With ``max_rounds = 0`` (start-up and refresh) the loop reads ``n_act``
once per round.  Every device->host read of the engine goes through
:func:`host_read`, which counts them in :data:`HOST_READS`.

**Every peel opens with K2's second entry**,
:func:`repro_torch.kernels.frontier_spmv.suffix_init`: the restricted
set's weights, total and induced edges.  For :func:`bulk_peel` the set is
every slot (the reference's ``peel_weights`` and ``f_total``), for
:func:`bulk_peel_warm` the kept vertices, for the workset its gathered
lanes; each is the reference's expression for that peel.  On CUDA that
entry and the round's edge kernel accumulate in float64, so a peel gives
the same bits on every run (``csrc/frontier_spmv.cu``).

**Edge liveness is updated in place.**  The reference is pure; here each
peel owns its liveness tensor (the prologue's fresh ``both``), and every
round's edge kernel clears the slots that leave the set in that one
tensor.

``unroll`` (an XLA lowering knob of the reference) has no meaning in eager
torch and is dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.graphstore.structs import DeviceGraph
from repro_torch.kernels.frontier_spmv import frontier_spmv, suffix_init
from repro_torch.kernels.peel_round import peel_round

__all__ = [
    "PeelResultDevice",
    "HOST_READS",
    "host_read",
    "exact_peel",
    "bulk_peel",
    "bulk_peel_warm",
    "bulk_peel_warm_workset",
    "bulk_peel_warm_checked",
    "select_bucket",
    "workset_sizes",
]

_INF = float("inf")

HOST_READS = [0]  # device->host reads made by the engine (see host_read)


def host_read(t: torch.Tensor) -> list:
    """Copy ``t`` to the host as a Python list (a scalar as a 1-list).

    The one funnel for every device->host read of the peel and
    maintenance engine, so tests can pin the reads per tick."""
    HOST_READS[0] += 1
    return t.detach().reshape(-1).cpu().tolist()


class PeelResultDevice(NamedTuple):
    """Result of a device peel.

    ``level[u]``: step/round at which u was peeled (int32; never peeled =
    -1).  ``best_level``: community = vertices with ``level >= best_level``.
    ``best_g``: density of the detected community.  ``n_rounds``: rounds
    (bulk) or steps (exact) executed.  ``delta``: bulk peels — final
    weights per vertex id; exact peel — peel-time weights aligned with
    ``order``.  ``order``: exact peel only — the peeling sequence (vertex
    ids, -1 past the last vertex); ``None`` for bulk peels (the reference
    fills it with zeros there).  Scalars are 0-dim device tensors.
    """

    level: torch.Tensor
    best_level: torch.Tensor
    best_g: torch.Tensor
    n_rounds: torch.Tensor
    delta: torch.Tensor
    order: torch.Tensor | None = None

    def community_mask(self) -> torch.Tensor:
        return self.level >= self.best_level


# ---------------------------------------------------------------------------
# exact sequential peel (paper-faithful)
# ---------------------------------------------------------------------------


def exact_peel(g: DeviceGraph) -> PeelResultDevice:
    """Algorithm 1, one vertex per step, deterministic (w, id) tie-break.

    Each of the ``n_capacity`` steps takes the active vertex of least
    weight (``torch.argmin`` returns the first minimum, so ties go to the
    lowest id, as in the host oracle's heap) and subtracts its live
    incident suspiciousness from its neighbours.  Steps after the last
    active vertex are no-ops, as in the reference's ``fori_loop``; no step
    reads anything on the host.  O(V) steps of O(E) work: an oracle, not a
    serving path.
    """
    V = g.n_capacity
    dev = g.device
    cm = torch.where(g.edge_mask, g.c, 0.0)
    w = g.peel_weights()
    f = g.f_total()
    n_act = g.vertex_mask.sum().to(torch.int32)
    n0 = n_act
    active = g.vertex_mask
    ids = torch.arange(V, device=dev)
    order = torch.full((V,), -1, dtype=torch.int32, device=dev)
    delta = torch.zeros(V, dtype=torch.float32, device=dev)
    level = torch.full((V,), -1, dtype=torch.int32, device=dev)
    best_g = _scalar(-_INF, torch.float32, dev)
    best_i = _scalar(0, torch.int32, dev)
    for i in range(V):
        key = torch.where(active, w, _INF)
        u = torch.argmin(key)
        wu = key[u]
        # density of the set *before* this peel
        g_cur = torch.where(n_act > 0, f / torch.clamp(n_act, min=1), -_INF)
        improved = g_cur > best_g
        best_g = torch.where(improved, g_cur, best_g)
        best_i = torch.where(improved, i, best_i)

        live = torch.where(active, 1.0, 0.0)
        from_u = torch.where((g.src == u) & g.edge_mask, cm, 0.0) * live[g.dst]
        to_u = torch.where((g.dst == u) & g.edge_mask, cm, 0.0) * live[g.src]
        dw = (torch.zeros(V, dtype=torch.float32, device=dev).index_add_(0, g.dst, from_u)
              + torch.zeros(V, dtype=torch.float32, device=dev).index_add_(0, g.src, to_u))
        peel_now = n_act > 0
        w = torch.where(peel_now, w - dw, w)
        active = active & ~((ids == u) & peel_now)
        order[i] = torch.where(peel_now, u, -1)
        delta[i] = torch.where(peel_now, wu, 0.0)
        level[u] = torch.where(peel_now, i, level[u])
        f = torch.where(peel_now, f - wu, f)
        n_act = n_act - peel_now.to(torch.int32)
    return PeelResultDevice(level=level, best_level=best_i, best_g=best_g,
                            n_rounds=n0, delta=delta, order=order)


class _BulkState(NamedTuple):
    w: torch.Tensor
    active: torch.Tensor
    edge_alive: torch.Tensor
    dw: torch.Tensor  # float64 [V] accumulator of the edge half, zero between rounds
    f: torch.Tensor
    n_act: torch.Tensor
    level: torch.Tensor
    best_g: torch.Tensor
    best_level: torch.Tensor
    round_: torch.Tensor


def _scalar(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def _round_step(src, dst, c, a, eps: float, s: _BulkState, reduce=None) -> _BulkState:
    """One bulk-peeling round over explicit COO arrays (the full buffer, or
    the gathered workset with locally relabeled endpoints).

    The scalar arithmetic keeps the reference's exact form, so it rounds
    the same way in float32: ``g = f / max(n_act, 1)`` and
    ``thresh = 2.0 * (1.0 + eps) * g`` (a Python double times a float32
    tensor).  The peel mask is materialised once as
    ``active & (w <= eff_thresh)``, which equals the reference's mask in
    both branches of its min-weight force-peel; the edge kernel reads it
    and the elementwise kernel recomputes it from ``eff_thresh``.  The
    edge kernel updates ``s.edge_alive`` in place and adds into ``s.dw``,
    which the elementwise kernel reads and leaves zeroed; the new state
    keeps both tensors.

    ``reduce(dw, drop_mass) -> drop_mass``, when given, runs between the
    two kernels: the edge-sharded engine (``repro_torch.dist.graph``) sums
    the ranks' ``dw`` and dropped mass there, in place in ``dw``.
    """
    g_cur = s.f / torch.clamp(s.n_act, min=1).to(torch.float32)
    improved = (g_cur > s.best_g) & (s.n_act > 0)
    best_g = torch.where(improved, g_cur, s.best_g)
    best_level = torch.where(improved, s.round_, s.best_level)

    thresh = 2.0 * (1.0 + eps) * g_cur
    # progress guarantee: under f32 drift the threshold can fall below every
    # remaining weight; then force-peel the min-weight vertices (a no-op
    # whenever the threshold test fires, hence invisible on integer weights)
    wmin = torch.where(s.active, s.w, _INF).min()
    eff_thresh = torch.where((s.active & (s.w <= thresh)).any(), thresh, wmin)
    peel = s.active & (s.w <= eff_thresh)
    dw, drop_mass = frontier_spmv(src, dst, c, s.edge_alive, peel, s.dw)
    if reduce is not None:
        drop_mass = reduce(dw, drop_mass)
    w, active, level, _, partials = peel_round(
        s.w, a, s.active, s.level, dw, eff_thresh, s.round_
    )
    return _BulkState(
        w=w,
        active=active,
        edge_alive=s.edge_alive,
        dw=dw,
        f=s.f - partials[0] - drop_mass,
        n_act=s.n_act - partials[2].to(torch.int32),
        level=level,
        best_g=best_g,
        best_level=best_level,
        round_=s.round_ + 1,
    )


def _run_rounds(src, dst, c, a, eps: float, s: _BulkState,
                max_rounds: int, reduce=None) -> _BulkState:
    if max_rounds > 0:
        for _ in range(max_rounds):
            s = _round_step(src, dst, c, a, eps, s, reduce)
        return s
    while host_read(s.n_act)[0] > 0:
        s = _round_step(src, dst, c, a, eps, s, reduce)
    return s


def _init_state(w0, active, edge_alive, f0, best_g, dw=None) -> _BulkState:
    """``dw``: the peel's float64 accumulator, zeros (a fresh one if None)."""
    dev = w0.device
    return _BulkState(
        w=w0,
        active=active,
        edge_alive=edge_alive,
        dw=torch.zeros(w0.shape, dtype=torch.float64, device=dev) if dw is None else dw,
        f=f0,
        n_act=active.sum().to(torch.int32),
        level=torch.full(w0.shape, -1, dtype=torch.int32, device=dev),
        best_g=best_g.to(torch.float32),
        best_level=_scalar(0, torch.int32, dev),
        round_=_scalar(0, torch.int32, dev),
    )


def _result(state: _BulkState, level, delta) -> PeelResultDevice:
    return PeelResultDevice(
        level=level,
        best_level=state.best_level,
        best_g=state.best_g,
        n_rounds=state.round_,
        delta=delta,
    )


def bulk_peel(g: DeviceGraph, eps: float = 0.1, max_rounds: int = 0
              ) -> PeelResultDevice:
    """Threshold bulk peeling; guarantees ``g_best >= g* / (2(1+eps))``.

    ``max_rounds = 0`` runs to completion (one host read per round); a
    positive value runs exactly that many rounds with no host read.
    """
    # every slot's ends count: w0 = g.peel_weights(), f0 = g.f_total(),
    # and the liveness is a copy of g.edge_mask
    a = torch.where(g.vertex_mask, g.a, 0.0)
    w0, f0, alive = suffix_init(g.src, g.dst, g.c, g.edge_mask,
                                torch.ones_like(g.vertex_mask), a)
    init = _init_state(w0, g.vertex_mask, alive, f0,
                       _scalar(-_INF, torch.float32, g.device))
    s = _run_rounds(g.src, g.dst, g.c, g.a, eps, init, max_rounds)
    return _result(s, s.level, s.w)


def bulk_peel_warm(
    g: DeviceGraph,
    keep: torch.Tensor,
    prior_best_g: torch.Tensor,
    eps: float = 0.1,
    max_rounds: int = 0,
) -> PeelResultDevice:
    """Bulk peel restricted to ``keep`` vertices (warm start).

    Vertices outside ``keep`` count as already peeled; weights, f and n are
    recovered w.r.t. the restricted set, so every round's threshold is
    valid on the current set.  ``prior_best_g`` seeds the best-density
    tracker.  This is the full-buffer warm path: every round streams the
    capacity-padded buffers.  Its prologue (the restricted set's weights,
    total and induced edges) is one :func:`suffix_init` call, whose fresh
    ``both`` becomes the peel's own liveness tensor.
    """
    live = keep & g.vertex_mask
    w0, f0, both = suffix_init(g.src, g.dst, g.c, g.edge_mask, live, g.a)
    init = _init_state(w0, live, both, f0, prior_best_g)
    s = _run_rounds(g.src, g.dst, g.c, g.a, eps, init, max_rounds)
    return _result(s, s.level, s.w)


# ---------------------------------------------------------------------------
# affected-area workset engine
# ---------------------------------------------------------------------------


def select_bucket(count: int, capacity: int, floor: int = 64) -> int | None:
    """Pick the power-of-two workset bucket for ``count`` elements.

    Returns the smallest power of two ``>= max(count, floor)``, or ``None``
    when ``count`` exceeds the largest bucket — the largest power of two
    ``<= max(capacity // 2, floor)``; the caller then falls through to the
    full-buffer warm path.
    """
    if count < 0:
        raise ValueError(f"negative workset count {count}")
    largest = max(capacity // 2, floor)
    largest = 1 << (largest.bit_length() - 1)  # round DOWN to a power of two
    if count > largest:
        return None
    bucket = max(count, floor)
    return 1 << (bucket - 1).bit_length()  # round UP to a power of two


def workset_sizes(g: DeviceGraph, keep: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(live suffix vertices, suffix-induced live edges) as int32 device
    scalars."""
    live = keep & g.vertex_mask
    both = live[g.src] & live[g.dst] & g.edge_mask
    return live.sum().to(torch.int32), both.sum().to(torch.int32)


class Workset(NamedTuple):
    """The gathered affected suffix (leading dims are bucket-sized).

    ``vid[j]``: global id of local vertex ``j`` (``n_capacity`` on pad
    lanes, so scatter-back drops them).  Edge endpoints are local ids; pad
    edge lanes carry ``c = 0``, ``alive = False`` and endpoint 0 (inert).
    """

    vid: torch.Tensor  # int32 [Bv]
    a: torch.Tensor  # float32 [Bv]
    active: torch.Tensor  # bool [Bv]
    src: torch.Tensor  # int32 [Be] local
    dst: torch.Tensor  # int32 [Be] local
    c: torch.Tensor  # float32 [Be]
    alive: torch.Tensor  # bool [Be]


def _compact_workset(src, dst, c, emask, a, live, v_bucket: int,
                     e_bucket: int) -> Workset:
    """Compact the affected suffix into bucket-sized buffers.

    The k-th live vertex (in id order) gets local id k.  The compaction is
    a **gather**: workset lane ``k`` locates the k-th live vertex/edge by
    binary search over a prefix sum.  Callers guarantee (via
    :func:`select_bucket`) that the counts fit the buckets.
    """
    V = a.shape[0]
    dev = a.device
    vsum = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32)
    local = vsum - 1
    nv = vsum[V - 1]
    vlane = torch.arange(v_bucket, dtype=torch.int32, device=dev)
    vid = torch.searchsorted(vsum, vlane + 1, out_int32=True)
    active0 = vlane < nv
    vid = torch.where(active0, vid, V)
    a_ws = torch.where(active0, a[torch.clamp(vid, max=V - 1)], 0.0)

    both = live[src] & live[dst] & emask
    esum = torch.cumsum(both.to(torch.int32), 0, dtype=torch.int32)
    ne = esum[src.shape[0] - 1]
    elane = torch.arange(e_bucket, dtype=torch.int32, device=dev)
    eidx = torch.searchsorted(esum, elane + 1, out_int32=True)
    alive0 = elane < ne
    eidx = torch.where(alive0, eidx, 0)  # clamp; pad lanes masked below
    lsrc = torch.where(alive0, local[src[eidx]], 0)
    ldst = torch.where(alive0, local[dst[eidx]], 0)
    c_ws = torch.where(alive0, c[eidx], 0.0)
    return Workset(vid=vid, a=a_ws, active=active0, src=lsrc, dst=ldst,
                   c=c_ws, alive=alive0)


def bulk_peel_warm_workset(
    g: DeviceGraph,
    keep: torch.Tensor,
    prior_best_g: torch.Tensor,
    eps: float = 0.1,
    max_rounds: int = 0,
    *,
    v_bucket: int,
    e_bucket: int,
) -> PeelResultDevice:
    """Workset twin of :func:`bulk_peel_warm`: gather -> peel -> scatter.

    Bit-identical to the full-buffer warm peel on integer weights: the
    workset holds exactly the suffix's live vertices and induced live
    edges, and every per-vertex/per-set quantity is the same integer sum.
    """
    V = g.n_capacity
    live = keep & g.vertex_mask
    ws = _compact_workset(g.src, g.dst, g.c, g.edge_mask, g.a, live,
                          v_bucket, e_bucket)
    # a live lane's ends are active lanes and ws.a is 0 off them, so this
    # is (ws.a + the alive c at both ends, their sum, ws.alive)
    w0, f0, alive = suffix_init(ws.src, ws.dst, ws.c, ws.alive, ws.active, ws.a)
    init = _init_state(w0, ws.active, alive, f0, prior_best_g)
    s = _run_rounds(ws.src, ws.dst, ws.c, ws.a, eps, init, max_rounds)
    # scatter the suffix back; pad lanes carry vid = V and land in the
    # spare slot past the end
    level = torch.full((V + 1,), -1, dtype=torch.int32, device=g.device)
    level.index_put_((ws.vid,), s.level)
    delta = torch.zeros(V + 1, dtype=torch.float32, device=g.device)
    delta.index_put_((ws.vid,), s.w)
    return _result(s, level[:V], delta[:V])


def bulk_peel_warm_checked(
    g: DeviceGraph,
    keep: torch.Tensor,
    prior_best_g: torch.Tensor,
    nv: int,
    ne: int,
    eps: float = 0.1,
    max_rounds: int = 0,
    *,
    v_bucket: int,
    e_bucket: int,
    warm=None,
    workset=None,
) -> tuple[PeelResultDevice, bool]:
    """Warm peel with a bucket-fit check: the workset path when this tick's
    counts ``nv/ne`` fit the predicted buckets, else the full-buffer warm
    peel.  Both give the same result on integer weights.

    The reference decides on the device (``lax.cond``).  Eager torch has no
    device-side branch, so here the counts come in as host integers — the
    caller's one blocking read per tick — and the branch is taken on the
    host.  ``warm``/``workset`` replace :func:`bulk_peel_warm` and
    :func:`bulk_peel_warm_workset` (the edge-sharded engine passes its
    own).  Returns ``(result, fits)``.
    """
    fits = nv <= v_bucket and ne <= e_bucket
    if fits:
        res = (workset or bulk_peel_warm_workset)(
            g, keep, prior_best_g, eps=eps, max_rounds=max_rounds,
            v_bucket=v_bucket, e_bucket=e_bucket)
    else:
        res = (warm or bulk_peel_warm)(g, keep, prior_best_g, eps=eps,
                                       max_rounds=max_rounds)
    return res, fits
