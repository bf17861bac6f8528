"""The plain reference of the Spade cells, in plain PyTorch.

It works out again, from the raw stream the harness hands to both sides,
what the program's timed path produces: the semantics' weights (the base
graph's, snapped to the dyadic grid, and each tick's at the
destination's arrival-time in-degree), the window's live edges, the
start-up peel, and one maintenance tick from a given state.  It follows
the paper's algorithms as the port documents them (the threshold bulk
peel of Bahmani et al. with the min-weight force-peel; the warm re-peel
of the affected suffix, paper §4 and App. C.3) and imports nothing of the
program.

Precision: edge and vertex weights are float32 values; every sum of
weights at a vertex is taken in float64 and rounded to float32 once, and
the set's total weight and the densities are float64.  ``lower`` (a
``torch.dtype`` or ``None``) rounds every weight, vertex weight, total
and density to that type after each step: the control, the reference put
in the program's place one precision below the configuration's float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QUANTUM", "seed_weights", "arrival_degrees", "tick_weights", "Graph", "Peel",
           "weights", "bulk_peel", "State", "start", "step", "benign_count", "window_graph"]

QUANTUM = 2.0 ** -30  # the semantics' dyadic grid
R0_CAP = 2 ** 30
_INF = float("inf")


def _lower(x: torch.Tensor, lower) -> torch.Tensor:
    return x if lower is None else x.to(lower).to(x.dtype)


def _lower_f(x: float, lower) -> float:
    return x if lower is None else float(torch.tensor(x, dtype=torch.float64).to(lower))


def seed_weights(sem, src, dst, raw, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The base graph's weights (float32, on the grid, at least one
    quantum) and its in-degree vector (int64 [n]): every base edge sees
    the destination's in-degree in the whole base graph."""
    deg = torch.bincount(dst.long(), minlength=n)
    x = sem.esusp(raw.double(), deg[dst.long()].double())
    snapped = torch.round(x * 2.0 ** 30) / 2.0 ** 30  # exact in float64; half to even
    return torch.clamp(snapped, min=QUANTUM).float(), deg


def arrival_degrees(dst, base_deg) -> torch.Tensor:
    """For streamed edges in arrival order, the destination's in-degree when
    each arrives: its base in-degree plus the earlier streamed edges with
    the same destination (a stable sort, then the rank within the run)."""
    dst = dst.long()
    order = torch.argsort(dst, stable=True)
    sd = dst[order]
    first = torch.searchsorted(sd, sd)  # the start of each destination's run
    earlier = torch.empty_like(dst)
    earlier[order] = torch.arange(dst.shape[0], device=dst.device) - first
    return base_deg[dst] + earlier


def tick_weights(sem, raw, deg) -> torch.Tensor:
    """Streamed edges' weights in float64 (the program keeps them float32,
    raw, not snapped)."""
    return sem.esusp(raw.float().double(), deg.double())


class Graph(NamedTuple):
    """Edge slots (``src``, ``dst`` int64, ``c`` float32, ``mask``) and
    vertices (``a`` float32, ``vmask``)."""

    src: torch.Tensor
    dst: torch.Tensor
    c: torch.Tensor
    mask: torch.Tensor
    a: torch.Tensor
    vmask: torch.Tensor


class Peel(NamedTuple):
    level: torch.Tensor  # int64, -1 where never peeled
    best_g: float
    best_level: int
    w: torch.Tensor  # float32 weights after the last round


def _vertex_sums(V: int, src, dst, values) -> torch.Tensor:
    acc = torch.zeros(V, dtype=torch.float64, device=values.device)
    return acc.index_add_(0, src, values).index_add_(0, dst, values)


def weights(g: Graph, live, lower=None) -> tuple[torch.Tensor, float, torch.Tensor]:
    """The vertex set ``live``'s weights (``a`` plus the weight of its live
    edges with both ends in the set, float32, 0 off the set), its total
    weight (float64) and those edges."""
    V = live.shape[0]
    a = torch.where(live, _lower(g.a, lower), 0.0)
    alive = live[g.src] & live[g.dst] & g.mask
    cm = torch.where(alive, _lower(g.c, lower), 0.0).double()
    w = torch.where(live, (a.double() + _vertex_sums(V, g.src, g.dst, cm)).float(), 0.0)
    return _lower(w, lower), _lower_f(a.double().sum().item() + cm.sum().item(), lower), alive


def bulk_peel(g: Graph, live, prior_g: float, eps: float, max_rounds: int,
              lower=None) -> Peel:
    """The threshold bulk peel of the vertices ``live``: each round peels
    every active vertex whose weight is at most ``2 (1 + eps)`` times the
    set's density (the least-weight vertices, where none is), and the best
    density seen seeds from ``prior_g``.  ``max_rounds = 0`` peels until no
    vertex is left; otherwise exactly that many rounds run (rounds after
    the last vertex change nothing)."""
    V = live.shape[0]
    c = _lower(g.c, lower)
    a = torch.where(live, _lower(g.a, lower), 0.0)
    w, f, alive = weights(g, live, lower)
    active = live.clone()
    n_act = int(active.sum())
    level = torch.full((V,), -1, dtype=torch.int64, device=live.device)
    best_g, best_level, r = prior_g, 0, 0
    scale = 2.0 * (1.0 + eps)
    while n_act > 0 and (max_rounds == 0 or r < max_rounds):
        g_cur = _lower_f(f / n_act, lower)
        if g_cur > best_g:
            best_g, best_level = g_cur, r
        under = active & (w.double() <= _lower_f(scale * g_cur, lower))
        peel = under if bool(under.any()) else active & (w == torch.where(active, w, _INF).min())
        ps, pd = peel[g.src], peel[g.dst]
        hit = alive & (ps | pd)
        cm = torch.where(alive, c, 0.0).double()
        dropped = _lower_f(torch.where(hit, cm, 0.0).sum().item(), lower)
        dw = torch.zeros(V, dtype=torch.float64, device=live.device)
        dw.index_add_(0, g.dst, torch.where(ps & ~pd, cm, 0.0))
        dw.index_add_(0, g.src, torch.where(pd & ~ps, cm, 0.0))
        f = _lower_f(f - _lower_f(torch.where(peel, a, 0.0).double().sum().item(), lower)
                     - dropped, lower)
        w = _lower(w - _lower(dw.float(), lower), lower)
        alive &= ~hit
        level[peel] = r
        active &= ~peel
        n_act -= int(peel.sum())
        r += 1
    return Peel(level=level, best_g=best_g, best_level=best_level, w=w)


class State(NamedTuple):
    """The maintained state: the graph, each vertex's peel level, the best
    density and its community, ``w0`` (every vertex's weight in the whole
    graph) and the next free edge slot."""

    graph: Graph
    level: torch.Tensor  # int64
    best_g: float
    community: torch.Tensor
    w0: torch.Tensor  # float32
    edge_count: int


def start(g: Graph, eps: float, lower=None) -> State:
    """The start-up state: the bulk peel of the whole graph to the end."""
    res = bulk_peel(g, g.vmask, -_INF, eps, 0, lower)
    everyone = torch.ones_like(g.vmask)
    return State(graph=g, level=res.level, best_g=res.best_g,
                 community=(res.level >= res.best_level) & g.vmask,
                 w0=weights(g, everyone, lower)[0], edge_count=int(g.mask.sum()))


def step(s: State, drop_lo: int, drop_hi: int, bs, bd, bc, eps: float, max_rounds: int,
         lower=None) -> State:
    """One maintenance tick: the live slots in ``[drop_lo, drop_hi)`` leave
    the window, the survivors close up in slot order, the batch (every lane
    valid; weights ``bc``) is appended after them, and the suffix of
    vertices at or above the least level of an end of a dropped or inserted
    edge is peeled again, warm, for ``max_rounds`` rounds."""
    g = s.graph
    E, V = g.src.shape[0], s.level.shape[0]
    dev = g.src.device
    bs, bd = bs.long(), bd.long()
    bc = _lower(bc.float(), lower)
    slot = torch.arange(E, device=dev)
    dropped = g.mask & (slot >= drop_lo) & (slot < drop_hi)
    ends = [s.level[bs].min(), s.level[bd].min()]
    if bool(dropped.any()):
        ends += [s.level[g.src[dropped]].min(), s.level[g.dst[dropped]].min()]
    r0 = min(int(torch.stack(ends).min()), R0_CAP) if bs.shape[0] or bool(dropped.any()) \
        else R0_CAP
    keep = s.level >= r0
    n_comm = int(s.community.sum())
    in_comm = s.community[g.src] & s.community[g.dst]
    loss = torch.where(dropped & in_comm, _lower(g.c, lower), 0.0).double().sum().item()
    prior_g = _lower_f(s.best_g - _lower_f(loss, lower) / n_comm, lower) if n_comm > 0 \
        else -_INF

    survive = torch.nonzero(g.mask & ~dropped).flatten()
    n_s, B = survive.shape[0], bs.shape[0]
    pad = V - 1
    src = torch.full((E,), pad, dtype=torch.int64, device=dev)
    dst = torch.full((E,), pad, dtype=torch.int64, device=dev)
    c = torch.zeros(E, dtype=torch.float32, device=dev)
    src[:n_s], dst[:n_s], c[:n_s] = g.src[survive], g.dst[survive], g.c[survive]
    src[n_s:n_s + B], dst[n_s:n_s + B], c[n_s:n_s + B] = bs, bd, bc
    mask = torch.arange(E, device=dev) < n_s + B
    new = Graph(src=src, dst=dst, c=c, mask=mask, a=g.a, vmask=g.vmask)

    res = bulk_peel(new, keep & g.vmask, prior_g, eps, max_rounds, lower)
    reached = torch.where(res.level >= 0, res.level, max_rounds)
    level = torch.where(keep, r0 + reached, s.level)
    community = ((res.level >= res.best_level) & keep & g.vmask
                 if res.best_g > prior_g else s.community)
    # w0: the dropped weight leaves both ends, the batch's arrives at both
    lanes_s = torch.cat([g.src[dropped], bs])
    lanes_d = torch.cat([g.dst[dropped], bd])
    lanes_c = torch.cat([-_lower(g.c, lower)[dropped], bc]).double()
    w0 = _lower((s.w0.double() + _vertex_sums(V, lanes_s, lanes_d, lanes_c)).float(), lower)
    return State(graph=new, level=level, best_g=max(res.best_g, prior_g), community=community,
                 w0=w0, edge_count=s.edge_count - int(dropped.sum()) + B)


def benign_count(w0, best_g, bs, bd, bc) -> int:
    """Def. 4.1 on a batch against a state: an edge is benign when neither
    end's weight in the whole graph plus the edge's reaches the best
    density (float32, as the test is stated)."""
    c = bc.float()
    g = torch.tensor(best_g, dtype=torch.float32, device=c.device)
    urgent = (w0[bs.long()] + c >= g) | (w0[bd.long()] + c >= g)
    return int((~urgent).sum())


def window_graph(base: tuple, ticks: tuple, e_cap: int, n_cap: int) -> tuple:
    """The slots the window should hold: the base edges, then the resident
    ticks' edges in arrival order, then padding (ends ``n_cap - 1``,
    weight 0, not live).  ``base`` and ``ticks`` are ``(src, dst, c)``."""
    dev = base[0].device
    n = base[0].shape[0] + ticks[0].shape[0]
    out = []
    for i, fill in enumerate((n_cap - 1, n_cap - 1, 0.0)):
        x = torch.full((e_cap,), fill, dtype=torch.float64 if i == 2 else torch.int64,
                       device=dev)
        x[:n] = torch.cat([base[i].to(x.dtype), ticks[i].to(x.dtype)])
        out.append(x)
    return (*out, torch.arange(e_cap, device=dev) < n)
