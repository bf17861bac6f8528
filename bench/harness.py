"""What every cell shares: finding a cell's files by name, the readings a
run leaves for the metric readers, and the result line.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``.  Its files are
found by name, so a later cell, mix, configuration or metric is added as
files alone:

* ``configs/<config>.json`` (sizes, settings, guarantees) and, beside it,
  ``configs/<config>.py`` (its plain reference: the semantics' formulas);
* ``traffic/<traffic>.json``, the mix's parameters;
* ``limits/<workload>.json``, the limit of each number the check compares;
* ``metrics/<metric>.py``, one reader a metric, end to end or per layer;
* ``<system>/driver.py``, the driver of the system the configuration
  names (``system``).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

__all__ = ["BENCH", "Cell", "Readings", "load_cell", "load_module", "forbidden_modules",
           "result_line", "FORBIDDEN"]

BENCH = Path(__file__).resolve().parent
# top-level module names that may not be loaded by a run: JAX and the JAX
# package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str | None = None):
    """Import the file ``path`` as a module of its own."""
    name = name or "bench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    name = "".join(ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries the cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    bench: Path

    def reference(self):
        """The configuration's plain reference (``configs/<config>.py``)."""
        return load_module(self.bench / "configs" / f"{self.config['name']}.py")

    def driver(self):
        """The system's driver, ``<system>/driver.py`` (``bench`` is on
        ``sys.path``)."""
        return importlib.import_module(f"{self.config['system']}.driver")

    def metric(self, name: str):
        return load_module(self.bench / "metrics" / f"{name}.py")


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(root: Path, workload: str, bench: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files from
    ``bench``; raises ``KeyError`` for a name the benchmark does not hold."""
    spec = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark holds {sorted(cells)}")
    w = cells[workload]
    config = json.loads((bench / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
        bench=bench,
    )


@dataclasses.dataclass
class Readings:
    """What a run leaves for the metric readers (``metrics/<name>.py``,
    each ``read(readings) -> float | None``).

    ``ticks``: the window's tick latencies in seconds, in order;
    ``tick_edges``: stream edges each tick applied; ``window_s``: the
    window's length; ``setup_s``: process start to the first timed tick;
    ``counters``: counts the driver read from the program over the window
    (``window_ticks``, ``host_reads``, ``k1_launches``, ``fallback_ticks``,
    ...); ``events_ms``: CUDA-event times by span, one a tick (traced
    run); ``trace``: the profiled stretch (:class:`devtrace.Trace`,
    traced run); ``work``: per metric that counts a kernel's work, the
    stacked ``(bytes, ops)`` of each of its calls in the traced stretch;
    ``peaks``: the device's published rates.
    """

    ticks: list
    tick_edges: list
    window_s: float
    setup_s: float
    counters: dict
    events_ms: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    work: dict = dataclasses.field(default_factory=dict)
    peaks: dict | None = None

    def roofline(self, metric: str, kernels: tuple) -> float | None:
        """Percent of the least time the ``metric``'s calls could take (the
        larger of bytes over the memory rate and operations over the
        compute rate, a call at a time, summed) in their device time, the
        kernels whose names hold one of ``kernels``.  ``None`` where
        nothing was traced or counted."""
        if self.trace is None or self.peaks is None or metric not in self.work:
            return None
        per_call = self.work[metric]  # [calls, 2]: bytes, ops
        if per_call.shape[0] == 0:
            return None
        least = (per_call[:, 0] / self.peaks["hbm_bytes_per_s"]).maximum(
            per_call[:, 1] / self.peaks["fp32_flops_per_s"]).sum().item()
        spent = self.trace.kernel_seconds(kernels, calls=per_call.shape[0])
        if not spent or spent <= 0:
            return None
        return 100.0 * least / spent


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _number(x) -> float:
    x = float(x)
    if not math.isfinite(x):
        raise ValueError(f"metric value {x!r} is not finite")
    return x


def result_line(cell: Cell, readings: Readings, trace: int, correct: bool, attempted: int,
                failed: int, device: dict, checks: dict, breakdown: dict | None) -> str:
    """The run's last line: the cell's end-to-end metrics (``trace`` 0) or
    per-layer metrics (``trace`` 1) from their readers, a metric whose
    reader finds nothing left out; ``checks`` last."""
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = cell.metric(m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def peaks(kind: str) -> dict | None:
    """The published rates of the device named ``kind`` (``peaks.json``,
    matched by a key the name contains), or ``None``."""
    table = json.loads((BENCH / "peaks.json").read_text())
    return next((v for k, v in table.items() if k in kind), None)


def run_cell(cell: Cell, seed: int, seconds: float, trace: int, device: str, t_start: float,
             control: bool = False):
    """Run ``cell`` through its system's driver; returns ``(result line,
    outcome)``."""
    import torch

    on_gpu = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(torch.device(device)) if on_gpu else "cpu"
    outcome = cell.driver().run(cell, seed, seconds, trace, device, t_start, control=control)
    r = outcome.readings
    r.peaks = peaks(kind) if on_gpu else None
    dev = {"platform": "gpu" if on_gpu else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": outcome.memory_peak_bytes}
    breakdown = None
    if trace and r.trace is not None:
        dev["busy_s"], dev["window_s"] = r.trace.busy_s, r.trace.window_s
        breakdown = r.trace.breakdown()
    line = result_line(cell, r, trace, outcome.correct, outcome.attempted, outcome.failed,
                       dev, outcome.checks, breakdown)
    return line, outcome
