"""Two-tower retrieval (YouTube, RecSys'19; port of
``repro/models/two_tower.py``): large sparse embedding tables -> a bag
per field (gather, weight, sum) -> a tower MLP per side (1024-512-256 at
full size) -> dot product, trained with an in-batch sampled softmax and a
logQ correction.

The reference computes the bags, the MLPs and the top-k outside any
Pallas kernel, so they are plain PyTorch here (``torch.matmul``,
``torch.topk``); its ``constrain`` sharding hints are dropped, as they
were from the GNN and the LM.

A field's bag is the reference's ``embedding_bag`` with bag ids
``repeat(arange(B * F), M)``: each bag's ``M`` lookups are contiguous, so
it is a sum over the lookup axis of the ``[B * F, M, D]`` gather, which
adds in a fixed order (``index_add_`` adds float32 by atomics on CUDA, in
no fixed order).  A tower runs over chunks of batch rows
(:func:`bag_rows`): the gather of a whole ``serve_bulk`` batch (262,144
rows x 8 fields x 16 lookups x 256 floats, 34 GB) does not fit beside the
61 GB of full-size tables on one card.  A row's output depends on that
row alone, so the chunks change the function nowhere.

This model is also the paper-integration point: the transaction stream
that feeds training is filtered by Spade's benign/urgent classifier
(``examples/torch_fraud_aware_recsys.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import normal_init

__all__ = ["RecsysBatch", "BAG_BYTES", "bag_rows", "init_two_tower_params", "user_tower",
           "item_tower", "two_tower_loss", "score_pairs", "retrieval_scores"]

BAG_BYTES = 1 << 32  # the gathered lookups of one chunk of batch rows (4 GiB)


class RecsysBatch(NamedTuple):
    """One batch: multi-hot categorical fields per tower.

    ``user_idx``: [B, Fu, M] int32 lookups (M = multi-hot width);
    ``user_wt``: [B, Fu, M] f32 per-lookup weights (0 = padding).
    """

    user_idx: torch.Tensor
    user_wt: torch.Tensor
    item_idx: torch.Tensor
    item_wt: torch.Tensor
    log_q: torch.Tensor  # [B] sampling log-probability of each in-batch item


def init_two_tower_params(cfg: RecsysConfig, *, device: str | torch.device | None = None,
                          generator: torch.Generator | None = None,
                          init: bool = True) -> dict:
    """The reference's tree: ``user_table`` [user_vocab, D] and
    ``item_table`` [item_vocab, D] (fan-in-scaled normals times 0.05),
    ``user_mlp`` / ``item_mlp`` (``w{i}`` fan-in-scaled normals, ``b{i}``
    zeros) and ``temp`` (20).  Drawn in that order from ``generator`` (on
    ``device``, default ``cuda``; seeded with 0 when None), in place, so a
    table takes its own bytes and no more; ``init=False`` leaves them
    uninitialised (for loading, or on ``meta``)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    if init and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def make(shape, fan_in, scale=None):
        if not init:
            return torch.empty(shape, dtype=dtype, device=dev)
        w = normal_init(shape, fan_in, dtype, dev, generator)
        return w.mul_(scale) if scale is not None else w

    def tower(dims):
        pairs = list(zip(dims[:-1], dims[1:]))
        return ({f"w{i}": make((a, b), a) for i, (a, b) in enumerate(pairs)}
                | {f"b{i}": torch.zeros(b, dtype=dtype, device=dev)
                   for i, (_, b) in enumerate(pairs)})

    D = cfg.embed_dim
    return {
        "user_table": make((cfg.user_vocab, D), D, 0.05),
        "item_table": make((cfg.item_vocab, D), D, 0.05),
        "user_mlp": tower([cfg.n_user_fields * D, *cfg.tower_mlp]),
        "item_mlp": tower([cfg.n_item_fields * D, *cfg.tower_mlp]),
        "temp": torch.tensor(20.0, dtype=dtype, device=dev),
    }


def bag_rows(n_fields: int, multi_hot: int, embed_dim: int, itemsize: int = 4) -> int:
    """Batch rows a tower takes at once: as many as keep their gathered
    lookups within :data:`BAG_BYTES` (32,768 rows of the full config's
    user tower)."""
    return max(1, BAG_BYTES // (n_fields * multi_hot * embed_dim * itemsize))


def _bag(table, idx, wt):
    """[b, F, M] lookups -> [b, F * D] concatenated bag embeddings."""
    b, F, M = idx.shape
    rows = table[idx.reshape(b * F, M).to(table.device, torch.int64)]  # [b F, M, D]
    w = wt.reshape(b * F, M, 1).to(table.device)
    # in place when no gradient is taken: the gather is the working set
    rows = rows * w if torch.is_grad_enabled() else rows.mul_(w)
    return rows.sum(dim=1).reshape(b, -1)


def _tower(p, x, n_layers):
    for i in range(n_layers):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    # L2-normalised embeddings (standard for dot-product retrieval)
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-9)


def _run_tower(table, mlp, idx, wt, cfg: RecsysConfig):
    """The tower over chunks of :func:`bag_rows` batch rows."""
    n = bag_rows(idx.shape[1], idx.shape[2], cfg.embed_dim, table.element_size())
    out = [_tower(mlp, _bag(table, idx[i:i + n], wt[i:i + n]), len(cfg.tower_mlp))
           for i in range(0, idx.shape[0], n)]
    return out[0] if len(out) == 1 else torch.cat(out)


def user_tower(params, idx, wt, cfg: RecsysConfig):
    """[B, Fu, M] lookups -> [B, tower_mlp[-1]] unit vectors."""
    return _run_tower(params["user_table"], params["user_mlp"], idx, wt, cfg)


def item_tower(params, idx, wt, cfg: RecsysConfig):
    """[B, Fi, M] lookups -> [B, tower_mlp[-1]] unit vectors."""
    return _run_tower(params["item_table"], params["item_mlp"], idx, wt, cfg)


def two_tower_loss(params, batch: RecsysBatch, cfg: RecsysConfig):
    """In-batch sampled softmax with logQ correction: ``(loss,
    {"in_batch_acc"})``, differentiable when grad mode is on."""
    u = user_tower(params, batch.user_idx, batch.user_wt, cfg)  # [B, D]
    it = item_tower(params, batch.item_idx, batch.item_wt, cfg)  # [B, D]
    logits = (u @ it.T) * params["temp"]  # [B, B]
    logits = logits - batch.log_q.to(logits.device)[None, :]  # correct for sampling bias
    labels = torch.arange(u.shape[0], device=u.device)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.diagonal()
    loss = (lse - ll).mean()
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"in_batch_acc": acc}


def score_pairs(params, batch: RecsysBatch, cfg: RecsysConfig):
    """Online/offline scoring: one score per (user, item) row, [B]."""
    u = user_tower(params, batch.user_idx, batch.user_wt, cfg)
    it = item_tower(params, batch.item_idx, batch.item_wt, cfg)
    return torch.sum(u * it, dim=-1) * params["temp"]


def retrieval_scores(params, user_idx, user_wt, cand_emb, cfg: RecsysConfig, top_k=100):
    """One query against N precomputed candidate embeddings [N, D] (one
    matrix-vector product): ``(top-k scores, their indices)``, best first."""
    u = user_tower(params, user_idx, user_wt, cfg)  # [1, D]
    scores = (cand_emb @ u[0]) * params["temp"]  # [N]
    return torch.topk(scores, top_k)
