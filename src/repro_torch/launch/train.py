"""Training launcher of the port (port of ``repro/launch/train.py``):
resumable, checkpointed, watchdogged.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --smoke --steps 50 --ckpt-dir build/ckpt [--device cpu]

It builds the arch's training cell (``build_cell(..., concrete=True)``)
on ``--device`` (default ``cuda``, raising without a GPU), restores the
latest checkpoint of ``--ckpt-dir`` when there is one, and steps, timing
each step to a synchronize; ``CheckpointManager`` saves every
``--ckpt-every`` steps and at the end, and ``StepWatchdog`` flags a
straggling step.  ``--smoke`` takes the reduced config and shapes.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_FAMILY, ARCHS
from repro_torch.ft.checkpoint import CheckpointManager, latest_step, load_pytree
from repro_torch.ft.elastic import StepWatchdog
from repro_torch.launch.cells import build_cell

__all__ = ["main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None):
    """Run the launcher on ``argv`` (the command line when None); returns
    the final training state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    fam = ARCH_FAMILY[args.arch]
    shape = args.shape or {"lm": "train_4k", "gnn": "full_graph_sm",
                           "recsys": "train_batch", "spade": "grab4_stream"}[fam]
    cell = build_cell(args.arch, shape, concrete=True, smoke=args.smoke, seed=args.seed,
                      device=args.device)
    if cell.step_name != "train_step":
        raise SystemExit(f"{args.arch} x {shape} is a {cell.step_name} cell, not a train step")
    state, *rest = cell.args
    device = state.step.device

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3, every_steps=args.ckpt_every)
        if latest_step(args.ckpt_dir) is not None:
            state = load_pytree(state, args.ckpt_dir)
            print(f"resumed from step {int(state.step)}")

    dog = StepWatchdog(factor=5.0)
    start = int(state.step)
    try:
        for i in range(start, start + args.steps):
            t0 = time.perf_counter()
            state, metrics = cell.fn(state, *rest)
            _sync(device)
            dt = time.perf_counter() - t0
            straggler = dog.observe(i, dt)
            if mgr:
                mgr.maybe_save(state, i + 1)
                mgr.check()
            print(f"step {i + 1} loss={float(metrics['loss']):.4f} "
                  f"{dt * 1e3:.0f}ms{' STRAGGLER' if straggler else ''}", flush=True)
        if mgr:
            mgr.maybe_save(state, start + args.steps, force=True)
    finally:
        if mgr:
            mgr.close()
    if mgr:
        mgr.check()
    return state


if __name__ == "__main__":
    main()
