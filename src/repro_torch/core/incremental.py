"""Device-plane incremental maintenance on torch (the paper's §4; the
counterpart of ``repro.core.incremental``).

Each vertex carries the ``level`` (bulk-peel round) at which it was peeled
during the last maintenance pass.  An update touches only the suffix
``keep = level >= r0``, with ``r0`` the minimum endpoint level over the
inserted and dropped edges, so maintenance re-peels only that suffix
(warm start).  New vertices are admitted with ``level = INT32_MAX``.

Three dispatchers run the same maintenance:

* **fused** (:func:`insert_and_maintain`, :func:`slide_and_maintain`):
  the full-buffer warm re-peel; with ``max_rounds > 0`` it makes no
  device->host read.
* **auto** (``*_auto``): the workset engine — one read per tick of the
  suffix counts, then the bucketed workset peel or the full-buffer
  fallback.
* **predictive** (``*_predictive``): buckets from the previous ticks'
  counts.  The reference checks the fit on the device (``lax.cond``) and
  never blocks; eager torch has no device-side branch, so this port reads
  this tick's two counts once, before dispatch (one blocking read per
  tick).  Removing it (a CUDA graph per bucket, or a conditional graph
  node) is listed in ROADMAP.md.

Every read goes through :func:`repro_torch.core.peel.host_read`.

The reference donates ``state`` to the fused programs.  This port does not
update buffers in place: every function returns new tensors and leaves the
state passed in intact.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.peel import (
    PeelResultDevice,
    bulk_peel,
    bulk_peel_warm,
    bulk_peel_warm_checked,
    bulk_peel_warm_workset,
    host_read,
    select_bucket,
    workset_sizes,
)
from repro_torch.graphstore.structs import (
    DeviceGraph,
    append_edges,
    remove_edges,
    scatter_drop,
)
from repro_torch.kernels.frontier_spmv import suffix_init

__all__ = [
    "DeviceSpadeState",
    "WorksetTickInfo",
    "BucketPredictor",
    "init_state",
    "insert_and_maintain",
    "insert_and_maintain_auto",
    "insert_and_maintain_predictive",
    "delete_and_maintain",
    "slide_and_maintain",
    "slide_and_maintain_auto",
    "slide_and_maintain_predictive",
    "full_refresh",
    "admit_vertices",
    "benign_mask",
]

_LEVEL_NEW = 2**31 - 1  # int32 max: admitted vertices sit in every suffix
_R0_CAP = 2**30  # r0 + suffix level stays inside int32


@dataclasses.dataclass(frozen=True)
class DeviceSpadeState:
    """Evolving-graph fraud-detection state on one device.

    ``w0[u]`` mirrors the full-graph peeling weight ``w_u(S_0)`` for the
    O(1) benign/urgent test (Def 4.1).  Scalars are 0-dim tensors.
    """

    graph: DeviceGraph
    level: torch.Tensor  # int32 [V_cap] peel round per vertex
    best_g: torch.Tensor  # float32 scalar — maintained best density
    community: torch.Tensor  # bool [V_cap] — maintained S^P
    edge_count: torch.Tensor  # int32 scalar — next free edge slot
    w0: torch.Tensor  # float32 [V_cap]


def _from_peel(g: DeviceGraph, res: PeelResultDevice,
               edge_count: torch.Tensor) -> DeviceSpadeState:
    return DeviceSpadeState(
        graph=g,
        level=res.level,
        best_g=res.best_g,
        community=res.community_mask() & g.vertex_mask,
        edge_count=edge_count,
        w0=g.peel_weights(),
    )


def init_state(g: DeviceGraph, eps: float = 0.1) -> DeviceSpadeState:
    """Static bulk peel to completion (one host read per round) to seed
    the state."""
    return _from_peel(g, bulk_peel(g, eps=eps),
                      g.edge_mask.sum().to(torch.int32))


def benign_mask(state: DeviceSpadeState, src, dst, c) -> torch.Tensor:
    """Vectorized Def 4.1: an edge is benign iff *both* endpoint tests fail
    the urgency condition ``w_u(S_0) + c >= g(S^P)``."""
    urgent = (state.w0[src] + c >= state.best_g) | (state.w0[dst] + c >= state.best_g)
    return ~urgent


class _SlideBookkeeping(NamedTuple):
    """Pre-re-peel bookkeeping of a tick (``dropped``/``cd`` are ``None``
    on insert-only ticks)."""

    dropped: torch.Tensor | None  # [E] live slots being expired
    cd: torch.Tensor | None  # [E] expired suspiciousness (0 elsewhere)
    n_new: torch.Tensor
    r0: torch.Tensor
    keep: torch.Tensor
    prior_g: torch.Tensor
    # (src, dst, c, mask) of the dropped edges in slot order, when the
    # caller gathered them (the edge-sharded engine); else None and
    # _tick_w0 reads them from the state's graph
    drop_lanes: tuple | None = None


def _masked_min(mask, values) -> torch.Tensor:
    return torch.where(mask, values, _LEVEL_NEW).min()


def _drop_terms(state: DeviceSpadeState, dropped) -> tuple:
    """What the prologue needs of the dropped slots: their least endpoint
    level, whether there is one, and the old community's exact density
    loss in the post-deletion graph (the dropped mass with both endpoints
    inside S^P)."""
    g0 = state.graph
    lvl = torch.minimum(_masked_min(dropped, state.level[g0.src]),
                        _masked_min(dropped, state.level[g0.dst]))
    in_comm = state.community[g0.src] & state.community[g0.dst]
    return lvl, dropped.any(), torch.where(dropped & in_comm, g0.c, 0.0).sum()


def _slide_prologue(state: DeviceSpadeState, drop, src, dst,
                    valid, drop_terms=_drop_terms) -> _SlideBookkeeping:
    """``drop = None`` marks an insert-only tick: the dropped bookkeeping
    is skipped entirely.  ``drop_terms(state, dropped)`` gives
    :func:`_drop_terms`' three values; the edge-sharded engine passes one
    that reduces them across its ranks."""
    g0 = state.graph
    dev = g0.device
    n_new = valid.sum().to(torch.int32)
    lvl = torch.minimum(_masked_min(valid, state.level[src]),
                        _masked_min(valid, state.level[dst]))
    if drop is None:
        dropped = cd = None
        any_update = n_new > 0
        comm_loss = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        dropped = drop & g0.edge_mask
        cd = torch.where(dropped, g0.c, 0.0)
        # affected suffix start: min endpoint level over dropped AND
        # inserted edges
        lvl_drop, any_drop, comm_loss = drop_terms(state, dropped)
        lvl = torch.minimum(lvl_drop, lvl)
        any_update = any_drop | (n_new > 0)
    r0 = torch.where(any_update, lvl, _LEVEL_NEW)
    r0 = torch.clamp(r0, max=_R0_CAP)
    # re-seed the best tracker with the old community's exact
    # post-deletion density
    n_comm = state.community.sum().to(torch.float32)
    prior_g = torch.where(
        n_comm > 0, state.best_g - comm_loss / torch.clamp(n_comm, min=1.0),
        -float("inf"),
    )
    return _SlideBookkeeping(dropped=dropped, cd=cd, n_new=n_new, r0=r0,
                             keep=state.level >= r0, prior_g=prior_g)


def _slide_epilogue(
    state: DeviceSpadeState,
    g: DeviceGraph,
    res: PeelResultDevice,
    bk: _SlideBookkeeping,
    n_removed: torch.Tensor,
    src, dst, c, valid,
    with_drops: bool = True,
    d_bucket: int = 0,
) -> DeviceSpadeState:
    """Merge a warm re-peel back into the state (level rebase, community
    update, exact w0 decrement/increment, edge-counter move).

    ``with_drops = False`` (insert-only ticks, or nothing dropped) skips the
    dropped-mass w0 decrement.  ``d_bucket > 0`` compacts the dropped edges
    into a ``d_bucket``-sized buffer by a searchsorted gather first, so the
    decrement (:func:`_tick_w0`) takes O(dropped) lanes instead of
    O(E_capacity).
    """
    suffix_level = torch.where(res.level >= 0, res.level, res.n_rounds)
    new_level = torch.where(bk.keep, bk.r0 + suffix_level, state.level)
    improved = res.best_g > bk.prior_g
    new_comm = torch.where(
        improved, (res.level >= res.best_level) & bk.keep & g.vertex_mask,
        state.community,
    )
    w0 = _tick_w0(state, bk, src, dst, c, valid, with_drops, d_bucket)
    return DeviceSpadeState(
        graph=g,
        level=new_level,
        best_g=torch.maximum(res.best_g, bk.prior_g),
        community=new_comm,
        edge_count=state.edge_count - n_removed + bk.n_new,
        w0=w0,
    )


def _tick_w0(state: DeviceSpadeState, bk: _SlideBookkeeping, src, dst, c, valid,
             with_drops: bool, d_bucket: int) -> torch.Tensor:
    """``state.w0`` after a tick: the dropped ``-c`` and the inserted
    ``cv`` added at both ends of their edges by one :func:`suffix_init`
    over those lanes (every vertex live, ``a = w0``): float64 sums rounded
    to float32 once, so the bits are the same whatever order the device
    adds them in, and groups of slots with no dropped edge cost the kernel
    one mask read.

    Each end of a batch lane lands as ``w0.at[end].add(cv, mode="drop")``
    would land it: an end in ``[-V, 0)`` counts from the end of ``w0``,
    any other end outside ``[0, V)`` goes to a spare vertex ``V`` that is
    cut off, and the lane's other end still takes ``cv``.  The graph's
    stored ends are in ``[0, V)`` (the peel that stores an edge indexes
    with them)."""
    g0 = state.graph
    V = state.w0.shape[0]
    cv = torch.where(valid, c.to(torch.float32), 0.0)

    def end(x):
        x = torch.where(x < 0, x + V, x)
        return torch.where(valid & (x >= 0) & (x < V), x, V)

    bsrc, bdst = end(src), end(dst)
    if with_drops and bk.drop_lanes is not None:
        ds, dd, dc, dm = bk.drop_lanes
        lanes = [ds, bsrc], [dd, bdst], [-dc, cv], [dm, valid]
    elif with_drops and d_bucket:
        E = g0.e_capacity
        dsum = torch.cumsum(bk.dropped.to(torch.int32), 0, dtype=torch.int32)
        lane = torch.arange(d_bucket, dtype=torch.int32, device=g0.device)
        didx = torch.searchsorted(dsum, lane + 1, out_int32=True)
        dlive = lane < dsum[E - 1]
        didx = torch.where(dlive, didx, 0)
        lanes = ([g0.src[didx], bsrc], [g0.dst[didx], bdst],
                 [-torch.where(dlive, bk.cd[didx], 0.0), cv], [dlive, valid])
    elif with_drops:
        lanes = [g0.src, bsrc], [g0.dst, bdst], [-bk.cd, cv], [bk.dropped, valid]
    else:
        lanes = [bsrc], [bdst], [cv], [valid]
    live = torch.ones(V + 1, dtype=torch.bool, device=g0.device)
    a = torch.cat([state.w0, state.w0.new_zeros(1)])
    return suffix_init(*(torch.cat(x) for x in lanes), live, a)[0][:V]


def _zero_i32(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=like.device)


def insert_and_maintain(
    state: DeviceSpadeState, src, dst, c, valid,
    eps: float = 0.1, max_rounds: int = 0,
) -> DeviceSpadeState:
    """Insert an edge batch and maintain the community incrementally.

    ``src/dst/c`` are fixed-size batch arrays with a ``valid`` mask.
    Append -> affected-suffix recovery -> warm bulk re-peel -> state merge.
    """
    bk = _slide_prologue(state, None, src, dst, valid)
    g = append_edges(state.graph, state.edge_count, src, dst, c, valid=valid)
    res = bulk_peel_warm(g, bk.keep, prior_best_g=bk.prior_g, eps=eps,
                         max_rounds=max_rounds)
    return _slide_epilogue(state, g, res, bk, _zero_i32(src), src, dst, c,
                           valid, with_drops=False)


def slide_and_maintain(
    state: DeviceSpadeState, drop, src, dst, c, valid,
    eps: float = 0.1, max_rounds: int = 0,
) -> DeviceSpadeState:
    """One fused sliding-window tick: expire the slots in ``drop``, insert
    the batch, re-peel **once** (paper Appendix C.3)."""
    bk = _slide_prologue(state, drop, src, dst, valid)
    g, n_removed = remove_edges(state.graph, drop)
    g = append_edges(g, state.edge_count - n_removed, src, dst, c, valid=valid)
    res = bulk_peel_warm(g, bk.keep, prior_best_g=bk.prior_g, eps=eps,
                         max_rounds=max_rounds)
    return _slide_epilogue(state, g, res, bk, n_removed, src, dst, c, valid)


def delete_and_maintain(
    state: DeviceSpadeState, drop, eps: float = 0.1, max_rounds: int = 0,
) -> DeviceSpadeState:
    """Delete the edges in slot mask ``drop`` and maintain incrementally:
    a window slide with an empty insert batch."""
    z = torch.zeros(1, dtype=torch.int32, device=drop.device)
    return slide_and_maintain(
        state, drop, z, z, z.to(torch.float32), z.to(torch.bool),
        eps=eps, max_rounds=max_rounds,
    )


# ---------------------------------------------------------------------------
# workset dispatch: gather the affected suffix, peel the workset only
# ---------------------------------------------------------------------------


class WorksetTickInfo(NamedTuple):
    """Host-side telemetry for one workset-dispatched maintenance tick."""

    n_suffix_vertices: int
    n_suffix_edges: int
    v_bucket: int  # 0 on fallback
    e_bucket: int  # 0 on fallback
    fallback: bool
    predicted: bool = False
    miss: bool = False


def _insert_phase_a(state, src, dst, c, valid):
    bk = _slide_prologue(state, None, src, dst, valid)
    g = append_edges(state.graph, state.edge_count, src, dst, c, valid=valid)
    nv, ne = workset_sizes(g, bk.keep)
    return g, bk, _zero_i32(src), nv, ne


def _slide_phase_a(state, drop, src, dst, c, valid):
    bk = _slide_prologue(state, drop, src, dst, valid)
    g, n_removed = remove_edges(state.graph, drop)
    g = append_edges(g, state.edge_count - n_removed, src, dst, c, valid=valid)
    nv, ne = workset_sizes(g, bk.keep)
    return g, bk, n_removed, nv, ne


class _Peels(NamedTuple):
    """The two warm peels a dispatcher chooses between, and the edge
    capacity its edge buckets are sized against: the single-device
    engine's (:func:`_local_peels`), or the edge-sharded engine's, whose
    edge buckets are per rank (``repro_torch.dist.graph``)."""

    warm: object  # (g, keep, prior_best_g, eps, max_rounds) -> PeelResultDevice
    workset: object  # the same, with keyword v_bucket and e_bucket
    e_capacity: int


def _local_peels(g: DeviceGraph) -> _Peels:
    return _Peels(bulk_peel_warm, bulk_peel_warm_workset, g.e_capacity)


def _phase_b(state, g, bk, n_removed, src, dst, c, valid, eps, max_rounds,
             v_bucket: int = 0, e_bucket: int = 0, with_drops: bool = True,
             d_bucket: int = 0, peels: _Peels | None = None) -> DeviceSpadeState:
    """Warm re-peel + state merge.  ``v_bucket/e_bucket = 0`` selects the
    full-buffer fallback; otherwise the bucketed workset path."""
    peels = peels or _local_peels(state.graph)
    if v_bucket and e_bucket:
        res = peels.workset(
            g, bk.keep, bk.prior_g, eps=eps,
            max_rounds=max_rounds, v_bucket=v_bucket, e_bucket=e_bucket,
        )
    else:
        res = peels.warm(g, bk.keep, bk.prior_g, eps=eps, max_rounds=max_rounds)
    return _slide_epilogue(state, g, res, bk, n_removed, src, dst, c, valid,
                           with_drops=with_drops, d_bucket=d_bucket)


def _dispatch_phase_b(state, g, bk, n_removed, src, dst, c, valid, nv, ne,
                      eps, max_rounds, min_bucket, with_drops=True,
                      peels: _Peels | None = None
                      ) -> tuple[DeviceSpadeState, WorksetTickInfo]:
    peels = peels or _local_peels(state.graph)
    n_cap, e_cap = state.graph.n_capacity, state.graph.e_capacity
    # the tick's one device->host read: three scalars in one transfer
    nv_i, ne_i, nd_i = host_read(torch.stack([nv, ne, n_removed]))
    bv = select_bucket(nv_i, n_cap, floor=min_bucket)
    be = select_bucket(ne_i, peels.e_capacity, floor=min_bucket)
    if bv is None or be is None:  # suffix too large: full-buffer fallback
        bv = be = 0
    with_drops = with_drops and nd_i > 0
    bd = 0
    if with_drops:
        bd = select_bucket(nd_i, e_cap, floor=min_bucket) or 0
    new_state = _phase_b(state, g, bk, n_removed, src, dst, c, valid, eps,
                         max_rounds, v_bucket=bv, e_bucket=be,
                         with_drops=with_drops, d_bucket=bd, peels=peels)
    return new_state, WorksetTickInfo(nv_i, ne_i, bv, be, not (bv and be))


def insert_and_maintain_auto(
    state: DeviceSpadeState, src, dst, c, valid,
    eps: float = 0.1, max_rounds: int = 0, min_bucket: int = 64,
) -> tuple[DeviceSpadeState, WorksetTickInfo]:
    """:func:`insert_and_maintain` through the workset engine: one host
    read per tick; the same state as the fused path on integer weights."""
    g, bk, n_removed, nv, ne = _insert_phase_a(state, src, dst, c, valid)
    return _dispatch_phase_b(state, g, bk, n_removed, src, dst, c, valid,
                             nv, ne, eps, max_rounds, min_bucket,
                             with_drops=False)


def slide_and_maintain_auto(
    state: DeviceSpadeState, drop, src, dst, c, valid,
    eps: float = 0.1, max_rounds: int = 0, min_bucket: int = 64,
) -> tuple[DeviceSpadeState, WorksetTickInfo]:
    """:func:`slide_and_maintain` through the workset engine (also covers
    pure deletion: pass an all-False ``valid``)."""
    g, bk, n_removed, nv, ne = _slide_phase_a(state, drop, src, dst, c, valid)
    return _dispatch_phase_b(state, g, bk, n_removed, src, dst, c, valid,
                             nv, ne, eps, max_rounds, min_bucket)


# ---------------------------------------------------------------------------
# predictive dispatch: buckets from the previous ticks' counts
# ---------------------------------------------------------------------------


class BucketPredictor:
    """Host-side predictive workset-bucket selector.

    Buckets come from the running max of the last ``history`` ticks'
    counts.  A tick whose counts outgrow the prediction (a miss) takes the
    full-buffer warm peel — the same result, only slower.
    """

    def __init__(self, n_capacity: int, e_capacity: int,
                 min_bucket: int = 64, history: int = 4):
        self.n_capacity = int(n_capacity)
        self.e_capacity = int(e_capacity)
        self.min_bucket = int(min_bucket)
        self.history = max(int(history), 1)
        self._nv: list[int] = []
        self._ne: list[int] = []

    def predict(self) -> tuple[int, int] | None:
        """``None`` before any observation (callers take the synced path);
        ``(0, 0)`` when the recent suffix outgrew the bucket ladder (direct
        full-buffer dispatch); else ``(v_bucket, e_bucket)``."""
        if not self._nv:
            return None
        bv = select_bucket(max(self._nv), self.n_capacity, floor=self.min_bucket)
        be = select_bucket(max(self._ne), self.e_capacity, floor=self.min_bucket)
        if bv is None or be is None:
            return (0, 0)
        return (bv, be)

    def observe(self, nv: int, ne: int) -> None:
        self._nv = (self._nv + [int(nv)])[-self.history:]
        self._ne = (self._ne + [int(ne)])[-self.history:]


def _predictive_dispatch(
    state, g, bk, n_removed, src, dst, c, valid, nv, ne,
    predictor: BucketPredictor, eps, max_rounds, with_drops=True,
    n_dropped=None, peels: _Peels | None = None,
) -> tuple[DeviceSpadeState, WorksetTickInfo]:
    """``n_dropped`` is the host's count of live edges in the drop mask
    (the windowed service knows it from its ring), which sizes the
    ``d_bucket`` compaction without a read; ``None`` keeps the full-width
    w0 decrement."""
    pred = predictor.predict()
    if pred is None:
        # no history yet: the synced dispatch seeds the predictor
        new_state, info = _dispatch_phase_b(
            state, g, bk, n_removed, src, dst, c, valid, nv, ne, eps,
            max_rounds, predictor.min_bucket, with_drops=with_drops, peels=peels,
        )
        predictor.observe(info.n_suffix_vertices, info.n_suffix_edges)
        return new_state, info

    wd = with_drops and n_dropped != 0
    bd = 0
    if wd and n_dropped is not None:
        bd = select_bucket(n_dropped, state.graph.e_capacity,
                           floor=predictor.min_bucket) or 0
    # the one blocking read of the tick: eager torch cannot branch on the
    # device, so the fit check needs this tick's counts on the host
    nv_i, ne_i = host_read(torch.stack([nv, ne]))
    bv, be = pred
    hit = False
    if bv and be:
        peels = peels or _local_peels(state.graph)
        res, hit = bulk_peel_warm_checked(
            g, bk.keep, bk.prior_g, nv_i, ne_i, eps=eps,
            max_rounds=max_rounds, v_bucket=bv, e_bucket=be,
            warm=peels.warm, workset=peels.workset,
        )
        new_state = _slide_epilogue(state, g, res, bk, n_removed, src, dst,
                                    c, valid, with_drops=wd, d_bucket=bd)
    else:  # recent suffixes outgrew the ladder: full buffer, no check
        new_state = _phase_b(state, g, bk, n_removed, src, dst, c, valid,
                             eps, max_rounds, with_drops=wd, d_bucket=bd,
                             peels=peels)
    predictor.observe(nv_i, ne_i)
    return new_state, WorksetTickInfo(
        nv_i, ne_i,
        v_bucket=bv if hit else 0,
        e_bucket=be if hit else 0,
        fallback=not hit,
        predicted=True,
        miss=bool(bv and be) and not hit,
    )


def insert_and_maintain_predictive(
    state: DeviceSpadeState, src, dst, c, valid, predictor: BucketPredictor,
    eps: float = 0.1, max_rounds: int = 0,
) -> tuple[DeviceSpadeState, WorksetTickInfo]:
    """:func:`insert_and_maintain_auto` with buckets predicted from
    ``predictor``'s history; one host read per tick."""
    g, bk, n_removed, nv, ne = _insert_phase_a(state, src, dst, c, valid)
    return _predictive_dispatch(state, g, bk, n_removed, src, dst, c, valid,
                                nv, ne, predictor, eps, max_rounds,
                                with_drops=False, n_dropped=0)


def slide_and_maintain_predictive(
    state: DeviceSpadeState, drop, src, dst, c, valid,
    predictor: BucketPredictor, n_dropped: int | None = None,
    eps: float = 0.1, max_rounds: int = 0,
) -> tuple[DeviceSpadeState, WorksetTickInfo]:
    """:func:`slide_and_maintain_auto` with predicted buckets; one host read
    per tick.  ``n_dropped``: host-known count of live edges in ``drop``."""
    g, bk, n_removed, nv, ne = _slide_phase_a(state, drop, src, dst, c, valid)
    return _predictive_dispatch(state, g, bk, n_removed, src, dst, c, valid,
                                nv, ne, predictor, eps, max_rounds,
                                n_dropped=n_dropped)


def full_refresh(state: DeviceSpadeState, eps: float = 0.1) -> DeviceSpadeState:
    """Periodic from-scratch bulk peel to completion (one host read per
    round)."""
    return _from_peel(state.graph, bulk_peel(state.graph, eps=eps),
                      state.edge_count)


def admit_vertices(state: DeviceSpadeState, ids, a) -> DeviceSpadeState:
    """Activate new vertex ids (out-of-capacity ids are dropped)."""
    g = state.graph
    a = a.to(torch.float32)
    true = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    new = torch.full(ids.shape, _LEVEL_NEW, dtype=torch.int32, device=ids.device)
    return dataclasses.replace(
        state,
        graph=dataclasses.replace(
            g, vertex_mask=scatter_drop(g.vertex_mask, ids, None, true),
            a=scatter_drop(g.a, ids, None, a),
        ),
        level=scatter_drop(state.level, ids, None, new),
        w0=scatter_drop(state.w0, ids, None, a),
    )
