"""Streaming fraud-detection serving CLI on torch, routed through the
:class:`repro_torch.serve.SpadeService` facade:

    # host oracle (exact per-edge reorders, edge grouping; NumPy on the host)
    PYTHONPATH=src python -m repro_torch.launch.serve --plane host \
        --semantics FD --edges 5000 --batch 100 --grouping

    # device plane, sliding window + predictive workset engine
    PYTHONPATH=src python -m repro_torch.launch.serve --semantics DW \
        --batch 512 --window 8 --workset --refresh-every 32

    # edge-sharded engine on 2 ranks (torch.distributed, one process a rank)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mesh 2

``--device`` (device plane only) defaults to ``cuda``, raising without a
GPU; pass ``--device cpu`` for the plain PyTorch path.  ``--mesh N`` starts
N ranks on this host (:func:`repro_torch.dist.spawn`) over a ``FileStore``
and prints rank 0's report (every rank's is the same); ``--backend`` is
``nccl`` (one card a rank; the default on ``cuda``) or ``gloo`` (the CPU's
default, and the one for more ranks than cards).  ``nccl`` with more ranks
than cards raises; nothing switches the backend for you.
"""

from __future__ import annotations

import argparse

from repro_torch.core.semantics import available
from repro_torch.dist import spawn
from repro_torch.graphstore.generators import make_transaction_stream
from repro_torch.serve import EngineSpec, SpadeService


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--semantics", "--metric", dest="semantics",
                    choices=list(available()), default="DW",
                    help="registered suspiciousness semantics")
    ap.add_argument("--plane", choices=["device", "host"], default="device")
    ap.add_argument("--device", default=None,
                    help="torch device of the device plane (default cuda; "
                         "'cpu' for the CPU)")
    ap.add_argument("--vertices", type=int, default=20000)
    ap.add_argument("--edges", type=int, default=80000)
    ap.add_argument("--batch", type=int, default=0,
                    help="edges per tick (0: plane default — 1 on host, "
                         "1024 on device)")
    ap.add_argument("--grouping", action="store_true",
                    help="host plane: benign/urgent edge grouping")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding window depth in ticks (device plane)")
    ap.add_argument("--workset", action="store_true",
                    help="affected-area workset engine (device plane)")
    ap.add_argument("--no-predictive", action="store_true",
                    help="workset: synced bucket selection instead of the "
                         "predictive selector (device plane)")
    ap.add_argument("--refresh-every", type=int, default=0)
    ap.add_argument("--max-rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", type=int, default=0,
                    help="ranks of the edge-sharded engine (device plane; 0: one "
                         "device, no mesh)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="--mesh's torch.distributed backend (default nccl on "
                         "cuda, gloo on the CPU)")
    args = ap.parse_args(argv)

    if args.plane == "host":
        device_flags = [name for name, on in [
            ("--device", args.device is not None), ("--window", args.window),
            ("--workset", args.workset),
            ("--no-predictive", args.no_predictive),
            ("--refresh-every", args.refresh_every),
            ("--mesh", args.mesh), ("--backend", args.backend is not None),
        ] if on]
        if device_flags:
            ap.error(f"{', '.join(device_flags)} require --plane device")
        spec = EngineSpec(plane="host", grouping=args.grouping,
                          batch_edges=args.batch or None)
    else:
        if args.grouping:
            ap.error("--grouping requires --plane host")
        if args.backend and not args.mesh:
            ap.error("--backend requires --mesh")
        spec = EngineSpec(
            batch_edges=args.batch or None,
            window_ticks=args.window,
            workset=args.workset,
            predictive=not args.no_predictive,
            refresh_every=args.refresh_every,
            max_rounds=args.max_rounds,
            device=args.device,
        )
    if args.mesh:
        device = args.device or "cuda"
        backend = args.backend or ("nccl" if device.startswith("cuda") else "gloo")
        rep, device = spawn(_serve_rank, args.mesh, backend=backend, device=device,
                            args=(args.semantics, spec, args))[0]
        print(f"mesh={args.mesh} backend={backend}", end=" ")
        _print_device(device, rep)
        return
    service = SpadeService(semantics=args.semantics, spec=spec)
    stream = make_transaction_stream(n=args.vertices, m=args.edges,
                                     seed=args.seed)
    rep = service.run(stream)
    if args.plane == "host":
        print(f"plane=host edges={rep.n_edges} reorders={rep.n_reorders} "
              f"us/edge={rep.mean_us_per_edge:.1f} "
              f"recall={rep.fraud_recall:.2f} "
              f"prevention={rep.prevention_ratio} "
              f"latency_s={rep.detection_latency_s}")
    else:
        _print_device(service.device, rep)


def _print_device(device, rep) -> None:
    print(f"device={device} edges={rep.n_edges} ticks={rep.n_ticks} "
          f"us/edge={rep.mean_us_per_edge:.1f} "
          f"recall={rep.fraud_recall:.2f} g={rep.final_g:.1f} "
          f"live={rep.live_edges} "
          f"ws/fb={rep.n_workset_ticks}/{rep.n_fallback_ticks} "
          f"pred/miss={rep.n_predicted_ticks}/{rep.n_bucket_miss_ticks}")


def _serve_rank(mesh, semantics: str, spec: EngineSpec, args):
    """One rank of ``--mesh``: the service over ``mesh`` on its device."""
    import dataclasses

    import torch

    device = torch.device(mesh.device_type, torch.cuda.current_device()
                          if mesh.device_type == "cuda" else None)
    service = SpadeService(semantics, dataclasses.replace(spec, mesh=mesh, device=str(device)))
    stream = make_transaction_stream(n=args.vertices, m=args.edges, seed=args.seed)
    return service.run(stream), service.device


if __name__ == "__main__":
    main()
