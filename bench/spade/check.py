"""The comparison that decides ``correct`` for the Spade cells.

Every number compares what the program's timed path produced with the
plain reference (``reference.py``), which works it out again from the raw
stream; the one exception is a tick's maintenance, which the reference
can only follow from the program's own state before the tick (the state
is path-dependent): it repeats sampled ticks from those states, and the
start (the start-up peel) and what the sampled ticks skip (every tick's
weights, the window's live edges and the degree vector after all of
them) are checked on their own.

Numbers (``<name>``: what it is; each has its limit in
``limits/<workload>.json``):

* ``seed_w``, ``tick_w``, ``live_c``: the largest relative error of a
  weight (the base graph's, every tick's, every live slot's);
* ``live_ids``: live slots whose ends or liveness differ after the last
  tick; ``degree``: vertices whose in-degree state differs;
  ``step_ids``: the same of the sampled ticks' slots (exact: limit 0);
* ``init_level``, ``step_level``: the share of vertices whose peel level
  differs; ``comm``: the most that the program's community's density, at
  start-up and after a sampled tick, falls short of (or exceeds) the
  reference community's, both taken exactly on the reference's graph,
  relative (a community one near-tied peel round away has about the
  same density);
  ``init_g``, ``step_g``: the relative error of the best density;
  ``init_w0``, ``step_w0``, ``final_w0``: the largest relative error of a
  vertex's whole-graph weight (``final_w0``: the program's after the last
  tick against the reference's weights of the window it should hold, so
  a drift that builds up over the ticks shows); ``benign``: sampled
  ticks' edges whose Def. 4.1 test differs;
* ``final_comm``: how far the density of the program's community after
  the last tick falls short of a cold start-up peel's on the window it
  should hold (``1 - d / d_cold``, 0 where it is as dense or denser), so
  a wrong level carried in from an unsampled tick shows.  Its limit is
  the configuration's guarantee, ``1 - 1 / (2 (1 + eps))``: a bfloat16
  cold peel still finds the planted ring on most seeds, so the control
  gives it no upper reading of its own.
"""

from __future__ import annotations

import dataclasses

import torch

from spade import reference as ref

__all__ = ["Program", "hold", "run", "judge"]


@dataclasses.dataclass
class Program:
    """What the program's run produced, as the driver kept it."""

    base_w: torch.Tensor  # float32 [m_base], seed_base's weights
    init: ref.State  # init_state's, held on the host
    final: object  # the program's state after the last tick
    final_deg: torch.Tensor  # the degree vector after the last tick
    weights: list  # every tick's batch weights, from the first stream tick
    benign: list  # every tick's benign count (device scalars)
    held: dict  # window tick -> (state before, state after), held on the host
    head: int  # stream ticks before the window
    window: int  # resident ticks
    m_base: int
    n: int  # vertices


def rel_err(got, want) -> float:
    """Largest ``|got - want|`` over ``max(|want|, m)``, ``m`` the median of
    the nonzero ``|want|``: a weight that cancels to about 0 is measured
    on the scale of its kind, not against its own rounding."""
    got, want = got.double(), want.double().to(got.device)
    if not want.numel():
        return 0.0
    scale = want.abs()
    nonzero = scale[scale > 0]
    floor = float(nonzero.median()) if nonzero.numel() else 1.0
    return float(((got - want).abs() / scale.clamp(min=floor)).max())


def _share(a, b, over: int) -> float:
    return int((a.to(b.device) != b).sum()) / max(over, 1)


def _density(g, members) -> float:
    """The exact (float64) density of the vertex set ``members`` in the
    reference graph ``g``."""
    n = int(members.sum())
    inside = g.mask & members[g.src] & members[g.dst]
    mass = (torch.where(members, g.a, 0.0).double().sum()
            + torch.where(inside, g.c, 0.0).double().sum())
    return float(mass) / n if n else 0.0


def _comm(g, got, want) -> float:
    d = _density(g, want)
    return abs(_density(g, got.to(want.device)) - d) / d


def _shortfall(g, got, want) -> float:
    """How far the density of ``got`` falls short of ``want``'s, relative."""
    return max(0.0, 1.0 - _density(g, got.to(want.device)) / _density(g, want))


def hold(s) -> ref.State:
    """The check's copy of a program state, on the host: the reference's
    view of it (the tensors are read, not changed)."""
    g = s.graph
    graph = ref.Graph(src=g.src.cpu(), dst=g.dst.cpu(), c=g.c.cpu(), mask=g.edge_mask.cpu(),
                      a=g.a.cpu(), vmask=g.vertex_mask.cpu())
    return ref.State(graph=graph, level=s.level.cpu(), best_g=float(s.best_g),
                     community=s.community.cpu(), w0=s.w0.cpu(), edge_count=int(s.edge_count))


def _on(s: ref.State, dev) -> ref.State:
    """A held state on ``dev``, ends and levels as int64."""
    g = s.graph
    graph = ref.Graph(src=g.src.to(dev).long(), dst=g.dst.to(dev).long(), c=g.c.to(dev),
                      mask=g.mask.to(dev), a=g.a.to(dev), vmask=g.vmask.to(dev))
    return s._replace(graph=graph, level=s.level.to(dev).long(),
                      community=s.community.to(dev), w0=s.w0.to(dev))


def _compare_state(got, want, n: int, prefix: str) -> dict:
    """``got``'s level, best density, community and w0 against ``want``'s
    (both reference states; the communities weighed on ``want``'s graph)."""
    return {f"{prefix}_level": _share(got.level, want.level, n),
            f"{prefix}_g": abs(got.best_g - want.best_g) / abs(want.best_g),
            f"{prefix}_comm": _comm(want.graph, got.community, want.community),
            f"{prefix}_w0": rel_err(got.w0, want.w0)}


def run(p: Program, stream, ref_sem, spec, control: bool = False):
    """The numbers of the program (and, with ``control``, of the control:
    the reference in bfloat16 weights in the program's place, on the same
    inputs and states).  Returns ``(numbers, notes, control_numbers)``."""
    dev = stream.base_src.device
    eps, rounds, batch = spec.eps, spec.max_rounds, spec.batch_edges
    lower = torch.bfloat16
    out, notes = {}, []
    ctrl = {} if control else None

    # the base graph's weights, and the start-up peel on the reference's own
    base_w, base_deg = ref.seed_weights(ref_sem, stream.base_src, stream.base_dst,
                                        stream.base_amt, p.n)
    out["seed_w"] = rel_err(p.base_w.to(dev), base_w)
    n_cap = p.init.level.shape[0]
    vmask = torch.arange(n_cap, device=dev) < p.n
    a = torch.zeros(n_cap, dtype=torch.float32, device=dev)
    e_cap = p.final.graph.e_capacity
    pad = torch.full((e_cap - p.m_base,), n_cap - 1, dtype=torch.int64, device=dev)
    graph0 = ref.Graph(src=torch.cat([stream.base_src.long(), pad]),
                       dst=torch.cat([stream.base_dst.long(), pad]),
                       c=torch.cat([base_w, torch.zeros(pad.shape, device=dev)]),
                       mask=torch.arange(e_cap, device=dev) < p.m_base, a=a, vmask=vmask)
    want0 = ref.start(graph0, eps)
    init = p.init
    got0 = ref.State(graph=graph0, level=init.level.to(dev).long(), best_g=init.best_g,
                     community=init.community.to(dev), w0=init.w0.to(dev), edge_count=0)
    out.update(_compare_state(got0, want0, p.n, "init"))
    if control:
        ctrl["seed_w"] = rel_err(base_w.to(lower), base_w)
        ctrl.update(_compare_state(ref.start(graph0, eps, lower), want0, p.n, "init"))
    del graph0

    # every tick's weights, at arrival-time degrees
    n_ticks = len(p.weights)
    src, dst, amt = stream.ticks(0, n_ticks)
    deg = (ref.arrival_degrees(dst, base_deg) if ref_sem.USES_DEGREE
           else base_deg[dst.long()])
    tick_w = ref.tick_weights(ref_sem, amt, deg)
    out["tick_w"] = rel_err(torch.cat(p.weights), tick_w)
    if control:
        ctrl["tick_w"] = rel_err(tick_w.to(lower), tick_w)
    want_deg = base_deg.clone()
    if ref_sem.USES_DEGREE:
        want_deg += torch.bincount(dst.long(), minlength=p.n)
    out["degree"] = _share(p.final_deg[:p.n].long(), want_deg, 1) + int(
        p.final_deg[p.n:].count_nonzero())

    # the window's live slots after the last tick
    lo = (n_ticks - p.window) * batch
    w_src, w_dst, w_c, w_mask = ref.window_graph(
        (stream.base_src, stream.base_dst, base_w),
        (src[lo:], dst[lo:], tick_w[lo:]), e_cap, n_cap)
    g = p.final.graph
    out["live_ids"] = int(((g.src.long() != w_src) | (g.dst.long() != w_dst)
                           | (g.edge_mask != w_mask)).sum())
    out["live_c"] = rel_err(g.c[w_mask], w_c[w_mask])
    if control:
        ctrl["live_c"] = rel_err(w_c[w_mask].to(lower), w_c[w_mask])

    # the end state against the window it should hold, worked out cold
    gw = ref.Graph(src=w_src, dst=w_dst, c=w_c.float(), mask=w_mask, a=a, vmask=vmask)
    everyone = torch.ones_like(vmask)
    want_w0 = ref.weights(gw, everyone)[0]
    out["final_w0"] = rel_err(p.final.w0, want_w0)
    cold = ref.start(gw, eps)
    out["final_comm"] = _shortfall(gw, p.final.community, cold.community)
    notes.append(f"after the last tick: community {int(p.final.community.sum())} of density "
                 f"{_density(gw, p.final.community.to(dev))!r}; a cold peel's "
                 f"{int(cold.community.sum())} of {_density(gw, cold.community)!r}")
    if control:
        ctrl["final_w0"] = rel_err(ref.weights(gw, everyone, lower)[0], want_w0)
        ctrl["final_comm"] = _shortfall(gw, ref.start(gw, eps, lower).community,
                                        cold.community)
    del gw, cold

    # sampled ticks, each from the program's state before it
    steps, csteps, ids, benign = [], [], 0, 0
    for k in sorted(p.held):
        before, after = p.held[k]
        t = p.head + k
        sl = slice(t * batch, (t + 1) * batch)
        bs, bd, bc = src[sl], dst[sl], tick_w[sl]
        pre = _on(before, dev)
        want = ref.step(pre, p.m_base, p.m_base + batch, bs, bd, bc, eps, rounds)
        got = _on(after, dev)
        steps.append(_compare_state(got, want, p.n, "step"))
        ids += int(((got.graph.src != want.graph.src) | (got.graph.dst != want.graph.dst)
                    | (got.graph.mask != want.graph.mask)).sum())
        benign += abs(int(p.benign[t]) - ref.benign_count(pre.w0, pre.best_g, bs, bd, bc))
        if control:
            csteps.append(_compare_state(
                ref.step(pre, p.m_base, p.m_base + batch, bs, bd, bc, eps, rounds, lower),
                want, p.n, "step"))
        notes.append(f"window tick {k}: best_g {got.best_g!r} (reference {want.best_g!r}), "
                     f"community {int(got.community.sum())} ({int(want.community.sum())})")
    for name in ("step_level", "step_g", "step_comm", "step_w0"):
        out[name] = max(s[name] for s in steps)
        if control:
            ctrl[name] = max(s[name] for s in csteps)
    for numbers in (out, ctrl) if control else (out,):
        numbers["comm"] = max(numbers.pop("init_comm"), numbers.pop("step_comm"))
    out["step_ids"] = ids
    out["benign"] = benign
    return out, notes, ctrl


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` (every number at or under its limit; a number without a
    limit, or a limit without a number, fails) and each number beside its
    limit."""
    checks, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        passed = value is not None and limit is not None and value <= limit
        ok &= passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def judge_control(control: dict, limits: dict) -> tuple[bool, dict]:
    """:func:`judge` of the control's numbers.  The control computes every
    number but the exact ones (slots, degrees, Def. 4.1 counts), which
    compare the reference's own bookkeeping with itself: those it reads
    as 0, and every limit still needs a number."""
    exact = {k: 0 for k in limits if k not in control}
    return judge({**exact, **control}, limits)
