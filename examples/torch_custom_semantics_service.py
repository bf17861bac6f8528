"""A user-defined suspiciousness semantics on every engine of the PyTorch
port — the paper's §6 API promise, end to end (the torch twin of
``examples/custom_semantics_service.py``).

We define a HoloScope-flavored **time-decayed** semantics: a transaction's
suspiciousness is its amount discounted by how far it sits from the
stream's detection horizon (``2^-(age / half_life)``), so evidence
concentrated in a recent burst dominates stale background mass.  Spade
incrementalizes it for free: the same definition runs through

* the single-device sliding-window engine,
* the affected-area workset engine with the predictive bucket selector,
* the edge-sharded engine on a ``torch.distributed`` mesh of ``--mesh``
  ranks (one process a rank, ``gloo``, which also serves several ranks on
  one card),
* the host oracle's per-edge funnel,

with **zero engine-file edits** — the hooks are compiled at the protocol
boundary (``seed_base`` / ``batch_weights`` / ``host_metric``), never
dispatched by name inside an engine.

    PYTHONPATH=src python examples/torch_custom_semantics_service.py [--device cpu]

``--device`` (the device services') defaults to ``cuda`` and raises
without a GPU.  ``--mesh 0`` leaves the sharded row out.
"""

import argparse
import importlib
import sys
from pathlib import Path

from repro_torch.core import Spade
from repro_torch.core.semantics import SuspSemantics, register
from repro_torch.dist import spawn
from repro_torch.graphstore.generators import make_transaction_stream
from repro_torch.serve import EngineSpec, SpadeService


def register_tdw(stream) -> None:
    """Register "TDW": the amount x recency decay toward ``stream``'s
    horizon.  ``xp`` is numpy on the host/seeding paths (float64,
    dyadic-snapped at the protocol boundary) and the torch shim inside the
    tick — one definition, every plane.  ``aux`` is the per-edge
    transaction timestamp the bundled services feed (base-graph edges carry
    t = 0; the host funnel passes None)."""
    horizon = float(stream.inc_time.max())
    half_life = 0.25 * horizon

    def decayed_amount(xp, src, dst, raw, in_deg_dst, t):
        age = horizon - (0.0 if t is None else t)
        return xp.maximum(raw, 1e-12) * 2.0 ** (-age / half_life)

    register(SuspSemantics(name="TDW", esusp=decayed_amount, uses_aux=True),
             overwrite=True)


def mesh_rank(mesh, args, spec: EngineSpec):
    """A rank of the sharded row: the same stream and semantics, rebuilt
    here (a semantics' hooks do not cross processes), over ``mesh``."""
    import dataclasses

    stream = make_transaction_stream(n=args.vertices, m=args.edges, seed=args.seed)
    register_tdw(stream)
    return SpadeService("TDW", dataclasses.replace(spec, mesh=mesh)).run(stream)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the device services (default cuda)")
    ap.add_argument("--vertices", type=int, default=5000)
    ap.add_argument("--edges", type=int, default=25000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seed", type=int, default=12)
    ap.add_argument("--mesh", type=int, default=2,
                    help="gloo ranks of the sharded row (0 leaves it out)")
    args = ap.parse_args(argv)

    stream = make_transaction_stream(n=args.vertices, m=args.edges, seed=args.seed)
    register_tdw(stream)

    # the same semantics through three engines (and DW as the undecayed control)
    common = dict(batch_edges=args.batch, max_rounds=20, refresh_every=16,
                  window_ticks=4, device=args.device)
    configs = [
        ("DW window-4", "DW", EngineSpec(**common)),
        ("TDW window-4", "TDW", EngineSpec(**common)),
        ("TDW workset-4", "TDW", EngineSpec(workset=True, predictive=True, **common)),
    ]
    if args.mesh:
        configs.append((f"TDW mesh-{args.mesh}", "TDW", EngineSpec(**common)))

    print(f"{'engine':<14} {'recall':>7} {'final_g':>10} {'live':>7} "
          f"{'ms/tick':>8} {'ws/fb':>6} {'pred/miss':>10}")
    for label, sem, spec in configs:
        if "mesh" in label:
            rep = spawn(_this_module().mesh_rank, args.mesh, backend="gloo",
                        device=args.device or "cuda", args=(args, spec))[0]
        else:
            rep = SpadeService(sem, spec).run(stream)
        print(f"{label:<14} {rep.fraud_recall:>7.2f} {rep.final_g:>10.1f} "
              f"{rep.live_edges:>7} {1e3 * rep.mean_tick_seconds:>8.1f} "
              f"{rep.n_workset_ticks:>3}/{rep.n_fallback_ticks:<2} "
              f"{rep.n_predicted_ticks:>5}/{rep.n_bucket_miss_ticks:<4}")

    # the registry now knows the custom name everywhere a builtin works: the
    # host oracle compiles the same hooks through its per-edge funnel
    sp = Spade(metric="TDW")
    sp.LoadGraph(stream.base_src[:2000], stream.base_dst[:2000],
                 stream.base_amt[:2000], n_vertices=stream.n_vertices)
    comm, g_best = sp.Detect()
    print(f"\nhost oracle under TDW: g(S^P) = {g_best:.2f} "
          f"(community size {len(comm)})")


def _this_module():
    """This file as an importable module, so that its rank function reaches
    the spawned ranks by name (run as a script, it is ``__main__``)."""
    here = str(Path(__file__).resolve().parent)
    if here not in sys.path:
        sys.path.insert(0, here)
    return importlib.import_module(Path(__file__).stem)


if __name__ == "__main__":
    main()
