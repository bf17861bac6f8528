"""Paper-integration example on the PyTorch port (the torch twin of
``examples/fraud_aware_recsys.py``): Spade guards the retrieval model's
training pipeline.  The transaction stream that would train the two-tower
model first goes through the benign/urgent classifier; transactions
incident to the maintained fraud community are quarantined, and the smoke
two-tower trains on the clean ones.

    PYTHONPATH=src python examples/torch_fraud_aware_recsys.py [--device cpu]

The fraud plane is the host ``Spade`` (NumPy on the host CPU); the
training plane runs on ``--device`` (default ``cuda``, raising without a
GPU).
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import Spade
from repro_torch.graphstore.generators import make_transaction_stream
from repro_torch.models.two_tower import RecsysBatch, init_two_tower_params, two_tower_loss
from repro_torch.train import AdamConfig, init_train_state, make_train_step


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=4000)
    ap.add_argument("--edges", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. training plane first: fail before the stream if there is no device
    cfg = get_smoke_config("two-tower-retrieval")
    params = init_two_tower_params(cfg, device=args.device)
    dev = params["temp"].device

    # 2. fraud plane: maintain the community over the evolving transaction graph
    stream = make_transaction_stream(n=args.vertices, m=args.edges, seed=args.seed)
    sp = Spade(metric="DW", edge_grouping=True)
    sp.LoadGraph(stream.base_src, stream.base_dst, stream.base_amt,
                 n_vertices=stream.n_vertices)

    quarantined, clean = [], []
    for u, v, amt in zip(stream.inc_src, stream.inc_dst, stream.inc_amt):
        res = sp.InsertEdge(int(u), int(v), float(amt))
        comm = set(res.fraudsters.tolist()) if res.triggered else set()
        if int(u) in comm or int(v) in comm:
            quarantined.append((int(u), int(v)))
        else:
            clean.append((int(u), int(v), float(amt)))
    frauds = set(sp.Detect()[0].tolist())
    quarantined += [(u, v) for (u, v, a) in clean if u in frauds or v in frauds]
    clean = [(u, v, a) for (u, v, a) in clean if u not in frauds and v not in frauds]
    print(f"stream: {len(clean)} clean / {len(quarantined)} quarantined transactions")

    # 3. two-tower retrieval on the CLEAN transactions only
    state = init_train_state(params)
    step = make_train_step(lambda p, b: two_tower_loss(p, b, cfg),
                           AdamConfig(lr=1e-3, warmup_steps=1, weight_decay=0.0))
    rng = np.random.default_rng(0)
    B, M = 32, cfg.multi_hot

    def bag(ids, n_fields):
        x = np.tile(ids[:, None, None], (1, n_fields, M)).astype(np.int32)
        return torch.from_numpy(x).to(dev), torch.ones((B, n_fields, M), device=dev)

    for _ in range(args.steps):
        take = rng.integers(0, len(clean), B)
        users = np.array([clean[i][0] for i in take]) % cfg.user_vocab
        items = np.array([clean[i][1] for i in take]) % cfg.item_vocab
        (ui, uw), (ii, iw) = bag(users, cfg.n_user_fields), bag(items, cfg.n_item_fields)
        batch = RecsysBatch(user_idx=ui, user_wt=uw, item_idx=ii, item_wt=iw,
                            log_q=torch.zeros(B, device=dev))
        state, metrics = step(state, batch)
    print(f"retrieval training on clean stream ({dev.type}): "
          f"loss={float(metrics['loss']):.3f} acc={float(metrics['in_batch_acc']):.2f}")


if __name__ == "__main__":
    main()
