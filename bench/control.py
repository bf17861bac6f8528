#!/usr/bin/env python3
"""The control of a cell's check, on the chip at the cell's own size:

    python3 bench/control.py --workload <cell> --seed <n> [--seconds <s>]

Runs the cell as ``bench/run.py`` does (a short window is enough: the
check compares the same ticks), then puts the reference, computed in
bfloat16, in the program's place on the same inputs and states.  Prints
one JSON line: each number of the check for the program and for the
control, beside the cell's limit, and ``correct`` of each as the
harness's own comparison (``check.judge``) decides it; the control's has
to come out false.  The limits are set between the program's readings
over a dozen seeds and the control's.  The benchmark's own runs never
run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, setup_paths  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    setup_paths()
    import torch

    import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    _, out = harness.run_cell(cell, args.seed, args.seconds, 0, "cuda:0", T_START,
                              control=True)
    for note in out.notes:
        print(note, file=sys.stderr)
    from spade import check

    control_correct, control_checks = check.judge_control(out.control, cell.limits)
    rows = {k: {"program": c["value"], "control": control_checks[k]["value"],
                "limit": c["limit"]} for k, c in out.checks.items()}
    print(json.dumps({"workload": args.workload, "seed": args.seed, "correct": out.correct,
                      "control_correct": control_correct, "numbers": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
