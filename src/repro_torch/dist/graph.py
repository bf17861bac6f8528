"""Mesh-sharded incremental peeling on ``torch.distributed``: the dist
plane's graph engine (the counterpart of ``repro.dist.graph``).

Edge partitioning: a :class:`DeviceGraph`'s COO edge buffers are cut into
one block per rank of an edge group of a ``DeviceMesh`` while every vertex
array stays replicated.  ``axis`` (default ``"data"``) names the group:
one mesh dim, a tuple of dims in the mesh's order (their flattened group,
:func:`repro_torch.dist.sharding.mesh_group`, whose index is pod-major as
GSPMD's ``P(("pod", "data"))``), or none (``()``: a group of this rank
alone, which issues no collective and gives the single-device bits).
Ranks that differ only along the other dims (``model``) hold the same
block and do the same work; every collective runs over the edge group.
One process per rank, PyTorch's SPMD idiom: every rank calls the same
entry points with the same replicated batch and gets the same replicated
results.  A rank holds its ``e_capacity / world`` slots as a
:class:`ShardedGraph`, each block its own allocation, so K2 and
``suffix_init`` take their 16-byte vector paths on it;
:func:`unshard_graph` joins the blocks again.

A bulk-peel round (the twin of ``core.peel._round_step``) runs K2 on the
rank's block into the peel's float64 ``dw``, then **one** fused
``all_reduce(SUM)`` of ``dw`` and the dropped mass (``dw ‖ drop``, float64,
``V + 1`` elements), then K1 on the replicated state, which clears ``dw``.
Every peel opens with ``suffix_init`` in its float64 mode on the rank's
block: the sums before ``a`` is added are all-reduced in float64, then
``a`` is added and the result rounded once.  So a world of one repeats the
single-device engine's bits.  A larger world does on integer weights
while the float32 sums stay exact, below 2^24: each rank's edge part of
``f0`` and each round's dropped mass are float32 sums of its block (the
single device sums all blocks in float32, the ranks add theirs in
float64), so past 2^24 ``f0`` and the running ``f`` may round apart.
The vertex sums are float64 throughout; on other weights the ranks' add
in another order (a few float64 ulps).  Thresholds and peel masks come
from replicated quantities, so every rank takes the same round sequence
and the 2(1+eps) guarantee carries over.

Streaming maintenance reuses ``core.incremental``'s bookkeeping
(``_slide_prologue`` / ``_slide_epilogue`` / ``_tick_w0`` and the workset
dispatchers) with the cross-rank terms supplied here:

* insertion: the batch is replicated; each rank writes the lanes whose
  global compacted slot falls in its block;
* a slide's dropped edges: one ``all_reduce`` of a small table (each
  rank's survivors and dropped edges, their least endpoint level and the
  community's lost mass) read once on the host, which sizes the exchange;
* compaction (``remove_edges``' layout: the k-th survivor moves to global
  slot k): a rank's survivors only move to lower slots, so only the first
  ones of a block can change rank; those, and the dropped edges (the
  tick's ``w0`` bookkeeping runs replicated on them, so ``w0`` keeps the
  single-device bits), go to every rank in one int32 ``all_reduce`` of a
  buffer in which each rank fills its own span (``c`` as its bits);
* the workset engine's edge count is an ``all_reduce(MAX)``, before the
  tick's one host read, so every rank picks the same buckets.

Every collective is an ``all_reduce``, which both ``nccl`` and ``gloo``
take on CUDA tensors, so the engine stages nothing through the host by
hand; ``gloo`` copies a CUDA tensor through host memory itself, inside
the timed ``all_reduce``.
:data:`STATS` counts them, their bytes and the slides' exchanges; with
``TIME_REDUCES[0]`` set, each is timed (synchronised on both sides).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.incremental import (
    BucketPredictor,
    DeviceSpadeState,
    WorksetTickInfo,
    _dispatch_phase_b,
    _drop_terms,
    _Peels,
    _predictive_dispatch,
    _slide_epilogue,
    _slide_prologue,
    _zero_i32,
)
from repro_torch.core.peel import (
    PeelResultDevice,
    _compact_workset,
    _init_state,
    _result,
    _run_rounds,
    _scalar,
    host_read,
)
from repro_torch.dist.sharding import mesh_group
from repro_torch.graphstore.structs import DeviceGraph, compact_slots, scatter_drop
from repro_torch.kernels.frontier_spmv import suffix_init

__all__ = [
    "ShardedGraph",
    "STATS",
    "TIME_REDUCES",
    "reset_stats",
    "shard_graph",
    "unshard_graph",
    "cell_step_collectives",
    "sharded_peel_weights",
    "sharded_bulk_peel",
    "sharded_bulk_peel_warm",
    "sharded_bulk_peel_warm_workset",
    "sharded_workset_sizes",
    "init_sharded_state",
    "sharded_insert_and_maintain",
    "sharded_insert_and_maintain_auto",
    "sharded_insert_and_maintain_predictive",
    "sharded_delete_and_maintain",
    "sharded_slide_and_maintain",
    "sharded_slide_and_maintain_auto",
    "sharded_slide_and_maintain_predictive",
    "sharded_full_refresh",
]

_INF = float("inf")
_SUM = dist.ReduceOp.SUM


def _zero_stats() -> dict:
    return {
        "all_reduces": 0,  # every all_reduce of the engine
        "round_all_reduces": 0,  # the one of each peel round
        "reduced_bytes": 0,  # bytes of the tensors all-reduced
        "reduce_seconds": 0.0,  # host clock around them, while TIME_REDUCES[0]
        "round_reduce_seconds": 0.0,
        "slides": 0,
        "moved_edges": 0,  # survivors that changed rank in a compaction
        "exchange_bytes": 0,  # the slides' exchange buffers (moved and dropped edges)
    }


STATS = _zero_stats()
TIME_REDUCES = [False]


def reset_stats() -> None:
    STATS.update(_zero_stats())


def _all_reduce(t: torch.Tensor, group, op=_SUM, round_: bool = False) -> None:
    """``t`` reduced in place over ``group``; a group of this rank alone
    (None) is ``t`` itself, and no collective is issued or counted."""
    if group is None:
        return
    STATS["all_reduces"] += 1
    STATS["round_all_reduces"] += round_
    STATS["reduced_bytes"] += t.numel() * t.element_size()
    if not TIME_REDUCES[0]:
        dist.all_reduce(t, op=op, group=group)
        return
    sync = torch.cuda.synchronize if t.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    sync()
    dt = time.perf_counter() - t0
    STATS["reduce_seconds"] += dt
    if round_:
        STATS["round_reduce_seconds"] += dt


@dataclasses.dataclass(frozen=True)
class ShardedGraph(DeviceGraph):
    """A :class:`DeviceGraph` of which this rank holds edge slots
    ``[rank * e_local, (rank + 1) * e_local)`` of the ``e_capacity`` padded
    slots (``src/dst/c/edge_mask``); the vertex arrays are whole.  Made by
    :func:`shard_graph`."""

    rank: int = 0
    world: int = 1
    e_unpadded: int = 0  # the whole graph's e_capacity before padding

    @property
    def e_local(self) -> int:
        return self.e_capacity // self.world

    def f_total(self):
        raise TypeError("a ShardedGraph holds one rank's edges; reduce across "
                        "the mesh (repro_torch.dist.graph)")

    def peel_weights(self):
        raise TypeError("a ShardedGraph holds one rank's edges; use "
                        "sharded_peel_weights(g, mesh)")


Axis = str | tuple[str, ...] | None  # an edge group: one mesh dim, several, or none


def _axis(mesh, axis: Axis):
    """(process group, this rank's index in it, its ranks) of the edge
    group ``axis`` names on ``mesh``: one dim, a tuple of dims (their
    flattened group, pod-major), or none (``()`` or None: this rank alone,
    group None)."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    axes = () if axis is None else (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in names:
            raise ValueError(f"mesh has no dim named {a!r} (dims {names})")
    dims = [names.index(a) for a in axes]
    if dims != sorted(set(dims)):
        raise ValueError(f"edge dims {axes} are not in the mesh's order {names}")
    if not dims:
        return None, 0, 1
    group = mesh_group(mesh, dims)
    if isinstance(group, tuple):  # one dim
        m, d = group
        return m.get_group(d), m.get_local_rank(d), m.size(d)
    return group.get_group(), group.get_local_rank(), group.size()


def _check(g: DeviceGraph, mesh, axis: Axis):
    group, rank, world = _axis(mesh, axis)
    if g.e_capacity % world:
        raise ValueError(
            f"e_capacity={g.e_capacity} not divisible by mesh axis {axis!r} "
            f"({world} shards); use shard_graph() to pad+place")
    if not isinstance(g, ShardedGraph) or (g.rank, g.world) != (rank, world):
        raise ValueError(f"the graph is not placed on mesh axis {axis!r} as rank "
                         f"{rank} of {world}; use shard_graph()")
    return group, rank, world


def shard_graph(g: DeviceGraph, mesh, axis: Axis = "data") -> ShardedGraph:
    """Pad ``e_capacity`` to a multiple of the ranks and keep this rank's
    block of the edge buffers, a fresh allocation; the vertex buffers stay
    whole.  Padding slots are the inert self-loops (``src = dst =
    n_capacity - 1``, ``c = 0``, not live) at the tail, after the free
    region the edge counter grows into."""
    _, rank, world = _axis(mesh, axis)
    e_pad = -(-g.e_capacity // world) * world
    el = e_pad // world
    lo = rank * el
    n = max(0, min(el, g.e_capacity - lo))

    def block(x, fill):
        out = torch.full((el,), fill, dtype=x.dtype, device=x.device)
        out[:n] = x[lo:lo + n]
        return out

    pad = g.n_capacity - 1
    return ShardedGraph(
        src=block(g.src, pad), dst=block(g.dst, pad), c=block(g.c, 0.0),
        edge_mask=block(g.edge_mask, False), a=g.a, vertex_mask=g.vertex_mask,
        n_capacity=g.n_capacity, e_capacity=e_pad, rank=rank, world=world,
        e_unpadded=g.e_capacity,
    )


def unshard_graph(g: ShardedGraph, mesh, axis: Axis = "data") -> DeviceGraph:
    """The whole graph on every rank: the ranks' edge blocks joined in rank
    order (one int32 ``all_reduce`` of a buffer in which each rank fills
    its block, ``c`` as its bits), cut to the unpadded ``e_capacity``."""
    group, rank, world = _check(g, mesh, axis)
    el = g.e_local
    buf = torch.zeros((4, world * el), dtype=torch.int32, device=g.device)
    buf[:, rank * el:(rank + 1) * el] = torch.stack(
        [g.src, g.dst, g.c.view(torch.int32), g.edge_mask.to(torch.int32)])
    _all_reduce(buf, group)
    E = g.e_unpadded
    return DeviceGraph(src=buf[0, :E], dst=buf[1, :E], c=buf[2, :E].view(torch.float32),
                       edge_mask=buf[3, :E].bool(), a=g.a, vertex_mask=g.vertex_mask,
                       n_capacity=g.n_capacity, e_capacity=E)


# ---------------------------------------------------------------------------
# sharded peels: one fused all_reduce per round
# ---------------------------------------------------------------------------


def _prologue(src, dst, c, emask, live, a, group):
    """The single-device peel's ``suffix_init`` over this rank's edges:
    its float64 sums all-reduced, then ``a`` added and rounded once.
    Returns ``(w0, f0, this rank's liveness, buf)``, ``buf`` the float64
    [V + 1] buffer, zeroed, which the peel's rounds take as ``dw ‖ drop``."""
    V = live.shape[0]
    buf = torch.empty(V + 1, dtype=torch.float64, device=live.device)
    _, vsum, both = suffix_init(src, dst, c, emask, live, a, acc=buf)
    _all_reduce(buf, group)
    w0 = torch.where(live, (a.to(torch.float64) + buf[:V]).to(torch.float32), 0.0)
    f0 = (vsum.to(torch.float64) + buf[V]).to(torch.float32)
    buf.zero_()
    return w0, f0, both, buf


def _round_reduce(buf, group):
    """The round's reduction (``core.peel._round_step``'s ``reduce``): the
    rank's dropped mass goes into ``buf[V]`` beside its ``dw = buf[:V]``,
    and one all_reduce sums both."""
    V = buf.shape[0] - 1

    def reduce(dw, drop_mass):
        buf[V:].copy_(drop_mass.reshape(1))
        _all_reduce(buf, group, round_=True)
        return buf[V].to(torch.float32)

    return reduce


def _sharded_peel(g, keep, prior_g, mesh, axis, eps, max_rounds, warm) -> PeelResultDevice:
    group, _, _ = _check(g, mesh, axis)
    if warm:  # bulk_peel_warm's prologue
        live = keep & g.vertex_mask
        w0, f0, alive, buf = _prologue(g.src, g.dst, g.c, g.edge_mask, live, g.a, group)
        active = live
    else:  # bulk_peel's: every slot's ends count
        a = torch.where(g.vertex_mask, g.a, 0.0)
        w0, f0, alive, buf = _prologue(g.src, g.dst, g.c, g.edge_mask,
                                       torch.ones_like(g.vertex_mask), a, group)
        active = g.vertex_mask
    init = _init_state(w0, active, alive, f0, prior_g, dw=buf[:g.n_capacity])
    s = _run_rounds(g.src, g.dst, g.c, g.a, eps, init, max_rounds,
                    reduce=_round_reduce(buf, group))
    return _result(s, s.level, s.w)


def sharded_bulk_peel(g: ShardedGraph, mesh, axis: Axis = "data", eps: float = 0.1,
                      max_rounds: int = 0) -> PeelResultDevice:
    """Edge-sharded twin of :func:`repro_torch.core.peel.bulk_peel`."""
    return _sharded_peel(g, g.vertex_mask, _scalar(-_INF, torch.float32, g.device),
                         mesh, axis, eps, max_rounds, warm=False)


def sharded_bulk_peel_warm(g: ShardedGraph, keep, prior_best_g, mesh, axis: Axis = "data",
                           eps: float = 0.1, max_rounds: int = 0) -> PeelResultDevice:
    """Edge-sharded twin of :func:`repro_torch.core.peel.bulk_peel_warm`."""
    return _sharded_peel(g, keep, prior_best_g, mesh, axis, eps, max_rounds, warm=True)


def sharded_bulk_peel_warm_workset(
    g: ShardedGraph, keep, prior_best_g, mesh, axis: Axis = "data", eps: float = 0.1,
    max_rounds: int = 0, *, v_bucket: int, e_bucket: int,
) -> PeelResultDevice:
    """Edge-sharded twin of
    :func:`repro_torch.core.peel.bulk_peel_warm_workset`: each rank gathers
    the suffix's induced edges of its block into ``e_bucket`` lanes (sized
    from the largest rank's count, :func:`sharded_workset_sizes`); the
    vertex compaction is replicated math, so every rank has the same local
    ids and round sequence."""
    group, _, _ = _check(g, mesh, axis)
    V = g.n_capacity
    live = keep & g.vertex_mask
    ws = _compact_workset(g.src, g.dst, g.c, g.edge_mask, g.a, live, v_bucket, e_bucket)
    w0, f0, alive, buf = _prologue(ws.src, ws.dst, ws.c, ws.alive, ws.active, ws.a, group)
    init = _init_state(w0, ws.active, alive, f0, prior_best_g, dw=buf[:v_bucket])
    s = _run_rounds(ws.src, ws.dst, ws.c, ws.a, eps, init, max_rounds,
                    reduce=_round_reduce(buf, group))
    # scatter the suffix back; pad lanes carry vid = V and land past the end
    level = torch.full((V + 1,), -1, dtype=torch.int32, device=g.device)
    level.index_put_((ws.vid,), s.level)
    delta = torch.zeros(V + 1, dtype=torch.float32, device=g.device)
    delta.index_put_((ws.vid,), s.w)
    return _result(s, level[:V], delta[:V])


def sharded_workset_sizes(g: ShardedGraph, keep, mesh, axis: Axis = "data"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(live suffix vertices, the LARGEST rank's suffix-induced live edges)
    as int32 device scalars, equal on every rank."""
    group, _, _ = _check(g, mesh, axis)
    live = keep & g.vertex_mask
    ne = (live[g.src] & live[g.dst] & g.edge_mask).sum().to(torch.int32).reshape(1)
    _all_reduce(ne, group, op=dist.ReduceOp.MAX)
    return live.sum().to(torch.int32), ne[0]


def sharded_peel_weights(g: ShardedGraph, mesh, axis: Axis = "data") -> torch.Tensor:
    """Edge-sharded ``DeviceGraph.peel_weights`` (the static peel's
    prologue: one all_reduce)."""
    group, _, _ = _check(g, mesh, axis)
    a = torch.where(g.vertex_mask, g.a, 0.0)
    return _prologue(g.src, g.dst, g.c, g.edge_mask, torch.ones_like(g.vertex_mask), a,
                     group)[0]


def cell_step_collectives(n_capacity: int, max_rounds: int, has_group: bool = True) -> dict:
    """The collectives a rank makes in one step of a Spade cell on this
    engine, :func:`sharded_bulk_peel` or :func:`sharded_insert_and_maintain`
    with ``max_rounds > 0`` (exactly that many rounds), counted from this
    module's structure: the peel's prologue and each round all-reduce the
    float64 ``dw ‖ drop`` buffer of ``n_capacity + 1`` elements, and
    nothing else reduces (the insertion writes the replicated batch into
    the blocks, the bookkeeping is replicated).  ``has_group`` False: the
    edges resolve to no mesh dim, and nothing is reduced.  As
    :data:`STATS` counts them: ``{"calls": ..., "bytes": ...}``."""
    if max_rounds < 1:
        raise ValueError("a step's rounds are counted only for max_rounds > 0")
    calls = (1 + max_rounds) if has_group else 0
    return {"calls": calls, "bytes": calls * (n_capacity + 1) * 8}


# ---------------------------------------------------------------------------
# sharded streaming maintenance
# ---------------------------------------------------------------------------


def _peels(mesh, axis: Axis, g: ShardedGraph) -> _Peels:
    return _Peels(partial(sharded_bulk_peel_warm, mesh=mesh, axis=axis),
                  partial(sharded_bulk_peel_warm_workset, mesh=mesh, axis=axis),
                  g.e_local)


def init_sharded_state(g: ShardedGraph, mesh, axis: Axis = "data",
                       eps: float = 0.1) -> DeviceSpadeState:
    """Sharded twin of :func:`repro_torch.core.incremental.init_state`;
    ``g`` comes from :func:`shard_graph`."""
    group, _, _ = _check(g, mesh, axis)
    res = sharded_bulk_peel(g, mesh, axis=axis, eps=eps)
    count = g.edge_mask.sum().to(torch.int32).reshape(1)
    _all_reduce(count, group)
    return DeviceSpadeState(
        graph=g, level=res.level, best_g=res.best_g,
        community=res.community_mask() & g.vertex_mask, edge_count=count[0],
        w0=sharded_peel_weights(g, mesh, axis=axis),
    )


def sharded_full_refresh(state: DeviceSpadeState, mesh, axis: Axis = "data",
                         eps: float = 0.1) -> DeviceSpadeState:
    """Edge-sharded twin of :func:`repro_torch.core.incremental.full_refresh`."""
    g = state.graph
    res = sharded_bulk_peel(g, mesh, axis=axis, eps=eps)
    return DeviceSpadeState(
        graph=g, level=res.level, best_g=res.best_g,
        community=res.community_mask() & g.vertex_mask, edge_count=state.edge_count,
        w0=sharded_peel_weights(g, mesh, axis=axis),
    )


def _sharded_append(g: ShardedGraph, offset, src, dst, c, valid) -> ShardedGraph:
    """``append_edges`` over the blocks: the batch is replicated; this rank
    writes the lanes whose global compacted slot falls in its block."""
    idx, ok = compact_slots(offset, valid, g.e_capacity)
    li = idx - g.rank * g.e_local
    ok = ok & (li >= 0) & (li < g.e_local)
    true = torch.ones(src.shape, dtype=torch.bool, device=src.device)
    return dataclasses.replace(
        g, src=scatter_drop(g.src, li, ok, src), dst=scatter_drop(g.dst, li, ok, dst),
        c=scatter_drop(g.c, li, ok, c), edge_mask=scatter_drop(g.edge_mask, li, ok, true),
    )


def _exclusive(xs: list[int]) -> list[int]:
    out = [0]
    for x in xs:
        out.append(out[-1] + x)
    return out


def _nth(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Slots of the first ``n`` set entries of ``mask``, in order."""
    csum = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, n + 1, dtype=torch.int32, device=mask.device)
    return torch.searchsorted(csum, want, out_int32=True)


def _sharded_remove(g: ShardedGraph, survive, dropped, n_survive: list[int],
                    n_dropped: list[int], group):
    """``remove_edges`` over the blocks, with the same global slot layout
    (the k-th survivor in global slot k), and the dropped edges gathered to
    every rank in global slot order.  ``n_survive``/``n_dropped``: every
    rank's counts, on the host.  Returns ``(graph, drop_lanes)``."""
    rank, world, el = g.rank, g.world, g.e_local
    dev = g.device
    off = _exclusive(n_survive)  # a rank's first survivor's new global slot
    # a rank's survivors move to lower slots only: its first `leave` ones
    # land on lower ranks
    leave = [min(n_survive[p], p * el - off[p]) for p in range(world)]
    xb = _exclusive(leave)
    db = _exclusive(n_dropped)
    M, D = xb[-1], db[-1]
    buf = torch.zeros((3, M + D), dtype=torch.int32, device=dev)

    def pack(slots):
        return torch.stack([g.src[slots], g.dst[slots], g.c[slots].view(torch.int32)])

    if leave[rank]:
        buf[:, xb[rank]:xb[rank + 1]] = pack(_nth(survive, leave[rank]))
    if n_dropped[rank]:
        buf[:, M + db[rank]:M + db[rank + 1]] = pack(_nth(dropped, n_dropped[rank]))
    if M + D:
        _all_reduce(buf, group)
    STATS["slides"] += 1
    STATS["moved_edges"] += M
    STATS["exchange_bytes"] += buf.numel() * buf.element_size()

    # this block's new slots: global slot k holds survivor k, of rank p
    k = torch.arange(rank * el, (rank + 1) * el, dtype=torch.int32, device=dev)
    p = torch.searchsorted(torch.tensor(off[1:], dtype=torch.int32, device=dev), k,
                           right=True, out_int32=True)
    j = k - torch.tensor(off, dtype=torch.int32, device=dev)[p]  # p's j-th survivor
    kept = k < off[-1]
    own = kept & (p == rank)
    csum = torch.cumsum(survive.to(torch.int32), 0, dtype=torch.int32)
    oi = torch.searchsorted(csum, torch.where(own, j, 0) + 1, out_int32=True).clamp_(max=el - 1)
    pad = g.n_capacity - 1
    src = torch.where(own, g.src[oi], pad)
    dst = torch.where(own, g.dst[oi], pad)
    c = torch.where(own, g.c[oi], 0.0)
    if M:
        ext = kept & ~own
        xi = torch.where(ext, torch.tensor(xb, dtype=torch.int32, device=dev)[p] + j, 0)
        src = torch.where(ext, buf[0][xi], src)
        dst = torch.where(ext, buf[1][xi], dst)
        c = torch.where(ext, buf[2][xi].view(torch.float32), c)
    lanes = (buf[0, M:], buf[1, M:], buf[2, M:].view(torch.float32),
             torch.ones(D, dtype=torch.bool, device=dev))
    return dataclasses.replace(g, src=src, dst=dst, c=c, edge_mask=kept), lanes


def _sharded_slide_phase_a(state, drop, src, dst, c, valid, mesh, axis):
    """The tick's bookkeeping, compaction and append over the blocks.
    ``drop`` is the global ``[e_capacity]`` slot mask; this rank reads its
    block.  Returns ``(graph, bookkeeping, n_removed)``."""
    group, rank, world = _check(state.graph, mesh, axis)
    g0 = state.graph
    el = g0.e_local
    drop = drop[rank * el:(rank + 1) * el]
    dropped = drop & g0.edge_mask
    survive = g0.edge_mask & ~drop
    # each rank's row: survivors, dropped, the community's lost mass, the
    # dropped edges' least endpoint level; summed, the rows are everyone's
    lvl, _, loss = _drop_terms(state, dropped)
    table = torch.zeros((world, 4), dtype=torch.float64, device=g0.device)
    table[rank] = torch.stack([survive.sum().double(), dropped.sum().double(),
                               loss.double(), lvl.double()])
    _all_reduce(table, group)
    counts = [int(x) for x in host_read(table[:, :2])]
    n_survive, n_dropped = counts[0::2], counts[1::2]
    terms = (table[:, 3].min().to(torch.int32), table[:, 1].sum() > 0,
             table[:, 2].sum().to(torch.float32))
    bk = _slide_prologue(state, drop, src, dst, valid, drop_terms=lambda *_: terms)
    g, lanes = _sharded_remove(g0, survive, dropped, n_survive, n_dropped, group)
    n_removed = table[:, 1].sum().to(torch.int32)
    g = _sharded_append(g, state.edge_count - n_removed, src, dst, c, valid)
    return g, bk._replace(drop_lanes=lanes), n_removed


def sharded_insert_and_maintain(state: DeviceSpadeState, src, dst, c, valid, mesh,
                                axis: Axis = "data", eps: float = 0.1,
                                max_rounds: int = 0) -> DeviceSpadeState:
    """Edge-sharded twin of
    :func:`repro_torch.core.incremental.insert_and_maintain`: sharded
    append, replicated suffix recovery, a sharded warm re-peel, the
    single-device state merge."""
    _check(state.graph, mesh, axis)
    bk = _slide_prologue(state, None, src, dst, valid)
    g = _sharded_append(state.graph, state.edge_count, src, dst, c, valid)
    res = sharded_bulk_peel_warm(g, bk.keep, bk.prior_g, mesh, axis, eps, max_rounds)
    return _slide_epilogue(state, g, res, bk, _zero_i32(src), src, dst, c, valid,
                           with_drops=False)


def sharded_slide_and_maintain(state: DeviceSpadeState, drop, src, dst, c, valid, mesh,
                               axis: Axis = "data", eps: float = 0.1,
                               max_rounds: int = 0) -> DeviceSpadeState:
    """Edge-sharded twin of
    :func:`repro_torch.core.incremental.slide_and_maintain`: one window
    tick (sharded compaction, sharded append, one warm re-peel).  One host
    read, of the ranks' counts."""
    g, bk, n_removed = _sharded_slide_phase_a(state, drop, src, dst, c, valid, mesh, axis)
    res = sharded_bulk_peel_warm(g, bk.keep, bk.prior_g, mesh, axis, eps, max_rounds)
    return _slide_epilogue(state, g, res, bk, n_removed, src, dst, c, valid)


def sharded_delete_and_maintain(state: DeviceSpadeState, drop, mesh, axis: Axis = "data",
                                eps: float = 0.1, max_rounds: int = 0) -> DeviceSpadeState:
    """Edge-sharded twin of
    :func:`repro_torch.core.incremental.delete_and_maintain`: a sharded
    slide with an empty insert batch."""
    z = torch.zeros(1, dtype=torch.int32, device=drop.device)
    return sharded_slide_and_maintain(state, drop, z, z, z.to(torch.float32),
                                      z.to(torch.bool), mesh, axis, eps, max_rounds)


def _sharded_insert_phase_a(state, src, dst, c, valid, mesh, axis):
    _check(state.graph, mesh, axis)
    bk = _slide_prologue(state, None, src, dst, valid)
    g = _sharded_append(state.graph, state.edge_count, src, dst, c, valid)
    nv, ne = sharded_workset_sizes(g, bk.keep, mesh, axis)
    return g, bk, _zero_i32(src), nv, ne


def _sharded_slide_phase_a_sized(state, drop, src, dst, c, valid, mesh, axis):
    g, bk, n_removed = _sharded_slide_phase_a(state, drop, src, dst, c, valid, mesh, axis)
    nv, ne = sharded_workset_sizes(g, bk.keep, mesh, axis)
    return g, bk, n_removed, nv, ne


def sharded_insert_and_maintain_auto(
    state: DeviceSpadeState, src, dst, c, valid, mesh, axis: Axis = "data",
    eps: float = 0.1, max_rounds: int = 0, min_bucket: int = 64,
) -> tuple[DeviceSpadeState, WorksetTickInfo]:
    """Edge-sharded twin of
    :func:`repro_torch.core.incremental.insert_and_maintain_auto`; edge
    buckets are per rank."""
    g, bk, n_removed, nv, ne = _sharded_insert_phase_a(state, src, dst, c, valid, mesh, axis)
    return _dispatch_phase_b(state, g, bk, n_removed, src, dst, c, valid, nv, ne, eps,
                             max_rounds, min_bucket, with_drops=False,
                             peels=_peels(mesh, axis, g))


def sharded_slide_and_maintain_auto(
    state: DeviceSpadeState, drop, src, dst, c, valid, mesh, axis: Axis = "data",
    eps: float = 0.1, max_rounds: int = 0, min_bucket: int = 64,
) -> tuple[DeviceSpadeState, WorksetTickInfo]:
    """Edge-sharded twin of
    :func:`repro_torch.core.incremental.slide_and_maintain_auto`."""
    g, bk, n_removed, nv, ne = _sharded_slide_phase_a_sized(
        state, drop, src, dst, c, valid, mesh, axis)
    return _dispatch_phase_b(state, g, bk, n_removed, src, dst, c, valid, nv, ne, eps,
                             max_rounds, min_bucket, peels=_peels(mesh, axis, g))


def sharded_insert_and_maintain_predictive(
    state: DeviceSpadeState, src, dst, c, valid, predictor: BucketPredictor, mesh,
    axis: Axis = "data", eps: float = 0.1, max_rounds: int = 0,
) -> tuple[DeviceSpadeState, WorksetTickInfo]:
    """Edge-sharded twin of
    :func:`repro_torch.core.incremental.insert_and_maintain_predictive`;
    ``predictor.e_capacity`` must be the per-rank capacity."""
    g, bk, n_removed, nv, ne = _sharded_insert_phase_a(state, src, dst, c, valid, mesh, axis)
    return _predictive_dispatch(state, g, bk, n_removed, src, dst, c, valid, nv, ne,
                                predictor, eps, max_rounds, with_drops=False, n_dropped=0,
                                peels=_peels(mesh, axis, g))


def sharded_slide_and_maintain_predictive(
    state: DeviceSpadeState, drop, src, dst, c, valid, predictor: BucketPredictor, mesh,
    axis: Axis = "data", n_dropped: int | None = None, eps: float = 0.1,
    max_rounds: int = 0,
) -> tuple[DeviceSpadeState, WorksetTickInfo]:
    """Edge-sharded twin of
    :func:`repro_torch.core.incremental.slide_and_maintain_predictive`."""
    g, bk, n_removed, nv, ne = _sharded_slide_phase_a_sized(
        state, drop, src, dst, c, valid, mesh, axis)
    return _predictive_dispatch(state, g, bk, n_removed, src, dst, c, valid, nv, ne,
                                predictor, eps, max_rounds, n_dropped=n_dropped,
                                peels=_peels(mesh, axis, g))
