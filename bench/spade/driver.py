"""The Spade cells' driver: the program's device-plane service, set up and
ticked by the harness, then checked against the plain reference.

The per-tick sequence is ``_run_device_service``'s
(``src/repro_torch/serve/spade_service.py``: set-up at lines 236-300, the
tick at lines 302-340) on one device, with two differences: the batch is
already on the device when it is handed over (views of the stream's
chunks), and the service's synchronise before maintenance (line 309),
which only starts its own timer, is left out: a tick's latency runs from
the hand-over to the synchronised end of its maintenance and takes in
``batch_weights`` and ``benign_mask``.  The loop is closed: one tick in
flight, ticks back to back.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import time
from functools import partial

import numpy as np
import torch

from devtrace import Tracer
from harness import Readings
from spade import check
from spade.stream import Stream, generator

__all__ = ["run", "Outcome"]


@dataclasses.dataclass
class Outcome:
    """What a run hands to the harness: the readings for the metrics, the
    check's numbers beside their limits, the window's ticks and the peak
    device memory; ``control``: the control's numbers, when asked for."""

    readings: object
    checks: dict
    correct: bool
    attempted: int
    failed: int
    memory_peak_bytes: int
    notes: list
    control: dict | None = None


class _Service:
    """The program's device-plane service state on one device, ticked one
    batch at a time as ``_run_device_service`` ticks it under the cells'
    engine: the affected-area engine with predicted buckets
    (``EngineSpec(workset=True, predictive=True)``), a sliding window and
    no refresh."""

    def __init__(self, sem, spec, state, deg, m_base: int, device):
        from repro_torch.core import incremental as inc

        self.sem, self.spec, self.state, self.deg = sem, spec, state, deg
        self.m_base, self.device = m_base, device
        g = state.graph
        self.predictor = inc.BucketPredictor(g.n_capacity, g.e_capacity,
                                             min_bucket=spec.min_bucket)
        self._bind()
        self.benign_mask = inc.benign_mask
        self.ring: list[int] = []
        self.benign_acc = torch.zeros((), dtype=torch.int64, device=device)
        self.ever_detected = torch.zeros(g.n_capacity, dtype=torch.bool, device=device)
        self.slot_ids = torch.arange(g.e_capacity, dtype=torch.int32, device=device)

    def _bind(self) -> None:
        from repro_torch.core import incremental as inc

        self.maintain = partial(inc.insert_and_maintain_predictive, predictor=self.predictor)
        self.slide = partial(inc.slide_and_maintain_predictive, predictor=self.predictor)

    def tick(self, bs, bd, amt, valid, tracer: Tracer, events=None):
        """One tick; returns ``(w, benign, info)``: the batch's weights, its
        benign count (a device scalar) and the engine's tick info."""
        eps, max_rounds = self.spec.eps, self.spec.max_rounds
        with tracer.span("weights"):
            if events is not None:
                events[0].record()
            w, self.deg = self.sem.batch_weights(self.deg, bs, bd, amt, valid, None)
            if events is not None:
                events[1].record()
        with tracer.span("benign"):
            benign = (self.benign_mask(self.state, bs, bd, w) & valid).sum()
            self.benign_acc += benign
        with tracer.span("maintain"):
            if len(self.ring) >= self.spec.window_ticks:
                cnt0 = self.ring.pop(0)
                drop = (self.slot_ids >= self.m_base) & (self.slot_ids < self.m_base + cnt0)
                self.state, info = self.slide(self.state, drop, bs, bd, w, valid,
                                              n_dropped=cnt0, eps=eps, max_rounds=max_rounds)
            else:
                self.state, info = self.maintain(self.state, bs, bd, w, valid, eps=eps,
                                                 max_rounds=max_rounds)
            self.ring.append(int(bs.shape[0]))
            self.ever_detected |= self.state.community
        with tracer.span("sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return w, benign, info

    def snapshot(self, device) -> "_Service":
        """A copy to tick again from here, its tensors on ``device``."""
        other = copy.copy(self)
        other.state = _move(self.state, device)
        other.deg = self.deg.to(device, copy=True)
        other.predictor = copy.deepcopy(self.predictor)
        other._bind()  # the partials hold the predictor they were made with
        other.ring = list(self.ring)
        other.benign_acc = self.benign_acc.to(device, copy=True)
        other.ever_detected = self.ever_detected.to(device, copy=True)
        other.slot_ids = self.slot_ids.to(device)
        other.device = torch.device(device)
        return other


def _move(x, device):
    """``x`` with every tensor in it, through the program's frozen
    dataclasses, copied to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _move(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x) if f.init})
    return x


def _counters():
    from repro_torch.core import peel as peel_mod
    from repro_torch.kernels.frontier_spmv import ops as k2
    from repro_torch.kernels.peel_round import ops as k1

    return {"host_reads": peel_mod.HOST_READS[0], "k1_launches": k1.launches,
            "k2_launches": k2.launches, "suffix_init_launches": k2.suffix_init_launches}


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


class _Counting:
    """Wrappers around the program's entries that the metrics count work
    in (a metric module's ``ENTRIES``, ``"module:attribute"``, and its
    ``work(*args)``, which returns the call's bytes and operations as
    device tensors).  Installed for the replay of the traced stretch only;
    nothing is read on the host until it ends."""

    def __init__(self, modules: dict):
        self.calls = {name: [] for name, mod in modules.items() if hasattr(mod, "ENTRIES")}
        self._patched = []
        for name, mod in modules.items():
            for entry in getattr(mod, "ENTRIES", ()):
                module_name, attr = entry.split(":")
                target = importlib.import_module(module_name)
                real = getattr(target, attr)
                self._patched.append((target, attr, real))
                setattr(target, attr, self._wrap(real, mod.work, self.calls[name]))

    @staticmethod
    def _wrap(real, work, calls):
        def counted(*args, **kwargs):
            calls.append(torch.stack([x.double() for x in work(*args, **kwargs)]))
            return real(*args, **kwargs)
        return counted

    def remove(self) -> dict:
        for target, attr, real in reversed(self._patched):
            setattr(target, attr, real)
        return {k: (torch.stack(v).cpu() if v else torch.zeros((0, 2), dtype=torch.float64))
                for k, v in self.calls.items()}


def _sample_ticks(seed: int, spec: dict, burst_tick: int) -> list[int]:
    """Window ticks whose maintenance the check repeats: ``sampled`` drawn
    from the seed below ``within``, and the burst's."""
    gen = generator("cpu", seed, "check")
    picks = torch.randperm(int(spec["within"]), generator=gen)[:int(spec["sampled"])]
    return sorted(set(picks.tolist()) | {burst_tick})


def run(cell, seed: int, seconds: float, trace: int, device: str, t_start: float,
        control: bool = False) -> Outcome:
    """Set the cell up, run its window, check it.  ``control`` also runs the
    control (the reference one precision lower in the program's place) on
    the same states, for its readings; the benchmark's runs never do."""
    from repro_torch.core import incremental as inc
    from repro_torch.core.semantics import resolve
    from repro_torch.graphstore.structs import device_graph_from_coo
    from repro_torch.serve.spade_service import EngineSpec

    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    host = torch.device("cpu")
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    eng = cfg["engine"]
    window, batch = int(traffic["window_ticks"]), int(traffic["batch_edges"])
    warmup = int(traffic["warmup_slides"])
    burst_tick = int(traffic["burst"]["window_tick"])
    head = window + warmup  # stream ticks before the window
    spec = EngineSpec(plane="device", batch_edges=batch, eps=float(eng["eps"]),
                      max_rounds=int(eng["max_rounds"]), window_ticks=window, workset=True,
                      predictive=True, device=device)
    sem = resolve(cfg["semantics"])

    # -- set-up: the stream on the device, the service's set-up (lines 236-300)
    stream = Stream(cfg, traffic, seed, dev, burst_at=head + burst_tick)
    n = stream.n_vertices
    m_base = stream.base_edges
    base_src = stream.base_src.cpu().numpy()
    base_dst = stream.base_dst.cpu().numpy()
    base_amt = stream.base_amt.cpu().numpy().astype(np.float64)
    e_cap = m_base + (window + 1) * batch
    base_aux = np.zeros(m_base) if sem.uses_aux else None
    base_w, in_deg = sem.seed_base(base_src, base_dst, base_amt, n, aux=base_aux)
    a0 = sem.seed_vertices(n, in_deg, aux=None)
    g = device_graph_from_coo(n, base_src, base_dst, base_w, a=a0,
                              n_capacity=-(-n // 512) * 512, e_capacity=-(-e_cap // 512) * 512,
                              device=dev)
    del base_src, base_dst, base_amt
    state0 = inc.init_state(g, eps=spec.eps)
    init = check.hold(state0)  # the check's copies live on the host
    deg = torch.zeros(g.n_capacity, dtype=torch.int32, device=dev)
    deg[:n] = torch.from_numpy(in_deg.astype(np.int32)).to(dev)
    svc = _Service(sem, spec, state0, deg, m_base, dev)
    del g, state0
    valid = torch.ones(batch, dtype=torch.bool, device=dev)
    off = Tracer()
    weights_out, benign_out = [], []
    for t in range(head):  # fill the window, then slide to warm up
        w, b, _ = svc.tick(*stream.tick(t), valid, off)
        weights_out.append(w)
        benign_out.append(b)
    stream.chunk(head // stream.chunk_ticks)
    sync()

    # -- the window.  Its clock stops while the check copies a state to the
    # host (between ticks, outside every latency): those copies are the
    # check's work, not the program's, and a copy kept on the card would
    # count in the run's peak memory.
    trace = bool(trace) and dev.type == "cuda"  # the profiler traces the card
    tracer = Tracer()
    sampled = _sample_ticks(seed, traffic["check"], burst_tick)
    trace_at = (int(traffic["trace"]["start_tick"]),
                int(traffic["trace"]["start_tick"]) + int(traffic["trace"]["ticks"]))
    # the check's copies are device work too: none may fall in the trace
    assert trace_at[0] >= int(traffic["check"]["within"]), "a sampled tick in the trace"
    least = max(sampled) + 1
    if trace:
        least = max(least, trace_at[1])
    held = {}  # window tick -> (state before, state after), on the host
    after = None  # (window tick, its state after) last held
    copied = set()  # ticks that follow a copy
    paused = 0.0

    def off_clock(fn, *args):
        nonlocal paused
        t = time.perf_counter()
        out = fn(*args)
        paused += time.perf_counter() - t
        return out

    lat, infos, ev = [], [], []
    replay_from = None
    c0 = _counters()
    setup_s = time.perf_counter() - t_start
    t_win = time.perf_counter()
    end, window_s = t_win, 0.0
    i = 0
    while i < least or end - paused < t_win + seconds:
        t = head + i
        if t % stream.chunk_ticks == 0 and t // stream.chunk_ticks not in stream.chunks:
            with tracer.span("draw"):
                stream.chunk(t // stream.chunk_ticks)
                sync()
        if trace and i == trace_at[0]:
            replay_from = off_clock(svc.snapshot, host)
            copied.add(i)
            tc0 = _counters()
            tracer.start(dev)
        if i in sampled:
            if not (after and after[0] == i - 1):
                after = (i - 1, off_clock(check.hold, svc.state))
            before = after[1]
            copied.add(i)
        prev = svc.state
        bs, bd, amt = stream.tick(t)
        events = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  if trace else None)
        t0 = time.perf_counter()
        with tracer.span("tick"):
            w, b, info = svc.tick(bs, bd, amt, valid, tracer, events)
        end = time.perf_counter()
        window_s = end - t_win - paused
        lat.append(end - t0)
        infos.append(info)
        weights_out.append(w)
        benign_out.append(b)
        if events is not None:
            ev.append(events)
        if i in sampled:
            after = (i, off_clock(check.hold, svc.state))
            held[i] = (before, after[1])
            copied.add(i + 1)
        if trace and i == trace_at[1] - 1:
            tracer.stop()
            traced = _delta(tc0, _counters())
        i += 1
    t_check = time.perf_counter()
    notes = []
    counters = _delta(c0, _counters())
    counters["window_ticks"] = i
    counters["fallback_ticks"] = sum(bool(x.fallback) for x in infos)
    counters["workset_ticks"] = len(infos)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if i - 1 not in held:  # the last tick, once the peak is read
        held[i - 1] = (check.hold(prev), check.hold(svc.state))
    del prev

    readings = Readings(ticks=lat, tick_edges=[batch] * i, window_s=window_s, setup_s=setup_s,
                        counters=counters)
    if ev:  # the profiler slows the host: only the ticks it did not trace
        readings.events_ms["weights"] = [a.elapsed_time(b) for k, (a, b) in enumerate(ev)
                                         if not trace_at[0] <= k < trace_at[1]]
    if trace:
        readings.trace = tracer.read()
        readings.counters["traced"] = traced
        modules = {m["name"]: cell.metric(m["name"]) for m in cell.per_layer}
        replay = replay_from.snapshot(dev)
        del replay_from
        counting = _Counting(modules)
        try:
            for k in range(*trace_at):
                replay.tick(*stream.tick(head + k), valid, off)
        finally:
            readings.work = counting.remove()
        del replay

    # -- the check, once the window has closed and the peak is read
    final = svc.state
    final_deg = svc.deg
    del svc
    ref = cell.reference()
    program = check.Program(
        base_w=torch.from_numpy(base_w), init=init, final=final, final_deg=final_deg,
        weights=weights_out, benign=benign_out, held=held, head=head, window=window,
        m_base=m_base, n=n)
    mid = lambda xs: sorted(xs)[len(xs) // 2] * 1e3 if xs else None
    notes.append(f"tick median ms: {mid([lat[k] for k in sorted(copied) if k < i])!r} "
                 f"after a copy to the host, {mid(lat)!r} over the window")
    if trace:
        notes.append(f"tick median ms: {mid(lat[trace_at[0]:trace_at[1]])!r} in the traced "
                     f"stretch, {mid(lat[:trace_at[0]] + lat[trace_at[1]:])!r} outside it")
    t_ref = time.perf_counter()
    numbers, check_notes, ctrl = check.run(program, stream, ref, spec, control=control)
    notes += check_notes
    notes.append(f"seconds: set-up {setup_s!r}, window {window_s!r}, copies to the host "
                 f"with the clock stopped {paused!r}, trace and replay {t_ref - t_check!r}, "
                 f"check {time.perf_counter() - t_ref!r}")
    correct, checks = check.judge(numbers, cell.limits)
    return Outcome(readings=readings, checks=checks, correct=correct, attempted=i, failed=0,
                   memory_peak_bytes=int(memory_peak), notes=notes, control=ctrl)
