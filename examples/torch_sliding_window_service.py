"""Sliding-window fraud detection on the PyTorch port (paper Appendix C.3;
the torch twin of ``examples/sliding_window_service.py``): the
bounded-memory deployment — only the base graph plus the last N ticks of
transactions stay resident; each tick expires the oldest batch and inserts
the newest in one fused warm re-peel.

Replays the same stream through the unbounded (insert-only) device
service and windowed services of several depths, reporting recall, tick
latency, and resident-edge footprint; then mirrors one window slide on
the host plane (Spade.InsertEdge + Spade.DeleteEdge — the exact oracle
the device plane is held against).

    PYTHONPATH=src python examples/torch_sliding_window_service.py [--device cpu]

``--device`` (the device services') defaults to ``cuda`` and raises
without a GPU.
"""

import argparse

from repro_torch.core import Spade
from repro_torch.graphstore.generators import make_transaction_stream
from repro_torch.serve import EngineSpec, SpadeService


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the device services (default cuda)")
    ap.add_argument("--vertices", type=int, default=5000)
    ap.add_argument("--edges", type=int, default=25000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seed", type=int, default=12)
    args = ap.parse_args(argv)

    stream = make_transaction_stream(n=args.vertices, m=args.edges, seed=args.seed)

    print(f"{'mode':<12} {'recall':>7} {'final_g':>10} {'live_edges':>11} "
          f"{'expired':>8} {'ms/tick':>8} {'ws/fb':>7}")
    for label, window, ws in [("unbounded", 0, False), ("window-16", 16, False),
                              ("window-4", 4, False), ("workset-4", 4, True)]:
        spec = EngineSpec(batch_edges=args.batch, max_rounds=20, refresh_every=16,
                          window_ticks=window, workset=ws, device=args.device)
        rep = SpadeService("DW", spec).run(stream)
        print(f"{label:<12} {rep.fraud_recall:>7.2f} {rep.final_g:>10.1f} "
              f"{rep.live_edges:>11} {rep.n_expired_edges:>8} "
              f"{1e3 * rep.mean_tick_seconds:>8.1f} "
              f"{rep.n_workset_ticks:>3}/{rep.n_fallback_ticks:<3}")

    # host-plane mirror of one window slide: exact incremental delete (C.1)
    sp = Spade(metric="DW")
    sp.LoadGraph(stream.base_src[:2000], stream.base_dst[:2000],
                 stream.base_amt[:2000], n_vertices=stream.n_vertices)
    u, v = int(stream.inc_src[0]), int(stream.inc_dst[0])
    if u != v:
        sp.InsertEdge(u, v, float(stream.inc_amt[0]))   # tick in ...
        res = sp.DeleteEdge(u, v)                       # ... and expired
        print(f"\nhost slide: g(S^P) after insert+expire = {res.g_best:.2f} "
              f"(community size {len(res.fraudsters)})")


if __name__ == "__main__":
    main()
