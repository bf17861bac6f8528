"""End-to-end example on the PyTorch port (the torch twin of
``examples/streaming_fraud_service.py``): a streaming fraud-detection
service replaying a timestamped transaction stream through the host plane
with edge grouping, reporting the paper's latency / prevention-ratio /
recall metrics for every metric and batching policy.

    PYTHONPATH=src python examples/torch_streaming_fraud_service.py

The host plane is NumPy on the host CPU, so this example has no device.
"""

import argparse

from repro_torch.graphstore.generators import make_transaction_stream
from repro_torch.serve import EngineSpec, SpadeService


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=8000)
    ap.add_argument("--edges", type=int, default=40000)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)

    print(f"{'metric':<6} {'policy':<12} {'us/edge':>9} {'reorders':>9} "
          f"{'recall':>7} {'prevention':>11} {'latency_s':>10}")
    for metric in ("DG", "DW", "FD"):
        for policy, kwargs in [
            ("batch-1", dict(grouping=False, batch_edges=1)),
            ("batch-100", dict(grouping=False, batch_edges=100)),
            ("grouping", dict(grouping=True, batch_edges=1, flush_every=0.5)),
        ]:
            stream = make_transaction_stream(n=args.vertices, m=args.edges,
                                             seed=args.seed)
            rep = SpadeService(metric, EngineSpec(plane="host", **kwargs)).run(stream)
            print(f"{metric:<6} {policy:<12} {rep.mean_us_per_edge:>9.1f} "
                  f"{rep.n_reorders:>9} {rep.fraud_recall:>7.2f} "
                  f"{str(rep.prevention_ratio and round(rep.prevention_ratio, 3)):>11} "
                  f"{str(rep.detection_latency_s and round(rep.detection_latency_s, 4)):>10}")


if __name__ == "__main__":
    main()
