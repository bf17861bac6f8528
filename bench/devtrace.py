"""The device trace of a stretch of the window, and what is read from it.

The profiler part follows ``chip_smoke.py``'s ``trace()`` (lines
1224-1267): ``torch.profiler`` around the ticks, device time taken from
its CUDA events.  Added here: the host spans of the benchmark's own
files, the union of the device's busy intervals, and the idle gaps named
after the span the host was in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

__all__ = ["Tracer", "Trace", "merge", "attribute_gaps"]


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def attribute_gaps(busy: list[tuple[float, float]], spans: list[tuple[float, float, str]],
                   lo: float, hi: float) -> dict[str, float]:
    """Idle time in ``[lo, hi)`` (outside the disjoint ``busy`` intervals),
    by the name of the host span it overlaps (``spans``: disjoint
    ``(start, end, name)``); idle time under no span counts as ``other``."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    out: dict[str, float] = {}
    spans = sorted(spans)
    j = 0
    for gs, ge in gaps:
        if ge <= gs:
            continue
        covered = 0.0
        while j < len(spans) and spans[j][1] <= gs:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < ge:
            s, e, name = spans[k]
            part = min(e, ge) - max(s, gs)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
                covered += part
            k += 1
        if ge - gs - covered > 0:
            out["other"] = out.get("other", 0.0) + (ge - gs - covered)
    return out


@dataclasses.dataclass
class Trace:
    """A profiled stretch: device operations ``(name, start_us, end_us)``,
    the harness's leaf spans ``(start_us, end_us, name)``, and the stretch
    ``[lo_us, hi_us]`` (first span start to last span end)."""

    ops: list
    spans: list
    lo_us: float
    hi_us: float

    @property
    def window_s(self) -> float:
        return (self.hi_us - self.lo_us) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the operations' intervals inside the stretch)."""
        inside = [(max(s, self.lo_us), min(e, self.hi_us)) for _, s, e in self.ops]
        return sum(e - s for s, e in merge([x for x in inside if x[1] > x[0]])) / 1e6

    def kernel_seconds(self, kernels: tuple, calls: int) -> float | None:
        """Device seconds of ``calls`` calls of an entry whose launch runs
        each kernel named by ``kernels`` (substrings) once.  The profiler
        drops a few kernels from a trace; a kernel recorded fewer than
        ``calls`` times is counted at its mean recorded time for the
        missing ones.  ``None`` if a kernel was never recorded."""
        total = 0.0
        for k in kernels:
            ts = [e - s for name, s, e in self.ops if k in name]
            if not ts:
                return None
            total += sum(ts) / len(ts) * max(calls, len(ts))
        return total / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The ``breakdown`` of the result line: the device operations that
        took most time, and the idle time by what the host was doing."""
        by_name: dict[str, float] = {}
        for name, s, e in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        busy = merge([(s, e) for _, s, e in self.ops])
        idle = attribute_gaps(busy, self.spans, self.lo_us, self.hi_us)
        rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in rank(by_name)],
                "idle_gaps": [[n, v / 1e6] for n, v in rank(idle)]}


class Tracer:
    """Host spans around the calls into the program, and the profiler over a
    stretch of ticks.  Outside the stretch a span costs nothing.

    The profiler records device activity only: recording every host-side
    op as well doubled a Grab4 tick on the H100 and so the idle share.  The
    spans are taken on the host clock and placed on the trace's clock by a
    marker: an empty kernel launched right after the profiler starts,
    whose device start is taken as its launch time (off by the launch
    latency, some microseconds)."""

    def __init__(self):
        self._prof = None
        self._recording = False
        self._spans: list = []  # (start_ns, end_ns, name) on the host clock
        self._marker_ns = 0
        self.trace: Trace | None = None

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self._spans.append((t0, time.perf_counter_ns(), name))

    def span(self, name: str):
        return self._span(name) if self._recording else contextlib.nullcontext()

    def start(self, device) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._recording = True
        self._marker_ns = time.perf_counter_ns()
        torch.cuda._sleep(1)
        torch.cuda.synchronize(device)

    def stop(self) -> None:
        """Stop the profiler and the spans (the caller has synchronised)."""
        self._recording = False
        self._prof.stop()

    def read(self) -> Trace:
        """Read the stopped profiler's events (slow: after the window)."""
        events = [e for e in self._prof.events() if str(e.device_type).endswith("CUDA")]
        self._prof = None
        events.sort(key=lambda e: e.time_range.start)
        offset = events[0].time_range.start - self._marker_ns / 1e3  # the marker
        ops = [(e.name, e.time_range.start, e.time_range.end) for e in events[1:]]
        spans = [(s / 1e3 + offset, e / 1e3 + offset, name) for s, e, name in self._spans
                 if name != "tick"]
        ticks = [(s / 1e3 + offset, e / 1e3 + offset) for s, e, name in self._spans
                 if name == "tick"]
        self.trace = Trace(ops=ops, spans=spans, lo_us=min(s for s, _ in ticks),
                           hi_us=max(e for _, e in ticks))
        return self.trace
