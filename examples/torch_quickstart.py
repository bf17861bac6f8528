"""Quickstart on the PyTorch port: detect an emerging fraud community on an
evolving graph (the torch twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py

Mirrors the paper's Listing 2: plug in suspiciousness functions, load a
graph, stream transactions, watch the community update in real time.  The
host API is NumPy on the host CPU, so this example has no device.
"""

import argparse

from repro_torch.core import Spade
from repro_torch.graphstore.generators import make_transaction_stream


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=5000)
    ap.add_argument("--edges", type=int, default=25000)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    # 1. a transaction stream with a planted fraud ring + a new colluding actor
    stream = make_transaction_stream(n=args.vertices, m=args.edges, seed=args.seed)

    # 2. build Spade with the Fraudar (FD) semantics — or plug your own:
    sp = Spade(metric="FD", edge_grouping=True)
    # custom semantics are two lambdas away (paper Listing 1/2):
    #   sp.VSusp(lambda u, g: my_account_prior(u))
    #   sp.ESusp(lambda u, v, amount, g: my_tx_suspiciousness(u, v, amount))
    sp.LoadGraph(stream.base_src, stream.base_dst, stream.base_amt,
                 n_vertices=stream.n_vertices)

    community, density = sp.Detect()
    print(f"standing community: {len(community)} accounts, g(S^P) = {density:.2f}")

    # 3. replay the stream; urgent transactions trigger immediate reordering
    new_fraudsters = set()
    for u, v, amt in zip(stream.inc_src, stream.inc_dst, stream.inc_amt):
        res = sp.InsertEdge(int(u), int(v), float(amt))
        if res.triggered and len(res.new_fraudsters):
            new_fraudsters.update(res.new_fraudsters.tolist())

    sp.FlushBuffer()
    community, density = sp.Detect()
    actor = int(stream.fraud_block[0])
    print(f"after stream: {len(community)} accounts, g(S^P) = {density:.2f}")
    print(f"new fraudsters flagged during stream: {sorted(new_fraudsters)[:10]}")
    print(f"planted colluding actor {actor} detected: "
          f"{actor in set(community.tolist())}")


if __name__ == "__main__":
    main()
