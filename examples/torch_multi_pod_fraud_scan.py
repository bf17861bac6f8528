"""Device-plane example on the PyTorch port (the torch twin of
``examples/multi_pod_fraud_scan.py``): bulk peeling + incremental
maintenance of a million-edge evolving graph with the device engine, on
one device.  The edge-sharded engine over several ranks is
``repro_torch.dist`` (``python -m repro_torch.launch.serve --mesh N``).

    PYTHONPATH=src python examples/torch_multi_pod_fraud_scan.py [--device cpu]

``--device`` defaults to ``cuda`` and raises without a GPU.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.incremental import benign_mask, init_state, insert_and_maintain
from repro_torch.device import resolve_device
from repro_torch.graphstore.generators import make_power_law_graph
from repro_torch.graphstore.structs import device_graph_from_coo


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    ap.add_argument("--vertices", type=int, default=200_000)
    ap.add_argument("--edges", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n, m = args.vertices, args.edges
    src, dst, amt = make_power_law_graph(n, m, seed=0, alpha=0.5)
    # plant a fraud ring
    ring = np.arange(50)
    rs = np.repeat(ring, 20)
    rd = ring[(np.arange(rs.shape[0]) * 7) % 50]
    keep = rs != rd
    src = np.concatenate([src, rs[keep]])
    dst = np.concatenate([dst, rd[keep]])
    amt = np.concatenate([amt, np.full(keep.sum(), 100.0)])

    B = args.batch
    g = device_graph_from_coo(n, src, dst, amt.astype(np.float32),
                              e_capacity=src.shape[0] + 3 * B, device=dev)
    t0 = time.perf_counter()
    state = init_state(g, eps=0.1)
    sync()
    print(f"bulk peel over {src.shape[0]:,} edges on {dev}: "
          f"{time.perf_counter()-t0:.2f}s, g_best={float(state.best_g):.1f}, "
          f"community={int(state.community.sum())} vertices")

    rng = np.random.default_rng(1)
    for tick in range(3):
        bs = torch.from_numpy(rng.integers(0, n, B).astype(np.int32)).to(dev)
        bd = torch.from_numpy(rng.integers(0, n, B).astype(np.int32)).to(dev)
        bc = torch.ones(B, dtype=torch.float32, device=dev)
        valid = bs != bd
        bm = benign_mask(state, bs, bd, bc)
        t0 = time.perf_counter()
        state = insert_and_maintain(state, bs, bd, bc, valid, eps=0.1)
        sync()
        print(f"tick {tick}: {int(valid.sum())} edges ({int(bm.sum())} benign) "
              f"maintained in {time.perf_counter()-t0:.3f}s, "
              f"g_best={float(state.best_g):.1f}")


if __name__ == "__main__":
    main()
