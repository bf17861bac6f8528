#!/usr/bin/env python3
"""The benchmark of the port (``repro_torch``) on one cell:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout, on the machine it is started on, and
needs as many CUDA devices as the cell asks for: without them it exits
with 2 and prints no result.  It sets the cell up (the set-up is timed
from the first line of this file), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints
the result as one JSON object on the last line of standard output; each
number the check compared, beside its limit, ends standard error.
``--trace 1`` reports the cell's per-layer metrics from a traced run
instead of its end-to-end metrics.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a workload name of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="inputs and weights are drawn from it")
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: a traced run reporting the per-layer metrics")
    return ap.parse_args(argv)


def setup_paths() -> None:
    """The harness's modules and the program's package importable, and the
    CUDA driver's cache kept inside the checkout."""
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def print_checks(checks: dict, notes: list) -> None:
    for note in notes:
        print(note, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)


def main(argv=None) -> int:
    args = parse(argv)
    setup_paths()
    import torch

    import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    line, outcome = harness.run_cell(cell, args.seed, args.seconds, args.trace, "cuda:0",
                                     T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"bench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"ticks: {outcome.attempted} in {outcome.readings.window_s!r} s of window")
    print_checks(outcome.checks, outcome.notes)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
