"""Two-tower retrieval (YouTube, RecSys'19; port of
``repro/models/two_tower.py``): large sparse embedding tables -> a bag
per field (gather, weight, sum) -> a tower MLP per side (1024-512-256 at
full size) -> dot product, trained with an in-batch sampled softmax and a
logQ correction.

The reference computes the bags, the MLPs and the top-k outside any
Pallas kernel, so they are plain PyTorch here (``torch.matmul``,
``torch.topk``).

A field's bag is the reference's ``embedding_bag`` with bag ids
``repeat(arange(B * F), M)``: each bag's ``M`` lookups are contiguous, so
it is a sum over the lookup axis of the ``[B * F, M, D]`` gather, which
adds in a fixed order (``index_add_`` adds float32 by atomics on CUDA, in
no fixed order).  A tower runs over chunks of batch rows
(:func:`bag_rows`): the gather of a whole ``serve_bulk`` batch (262,144
rows x 8 fields x 16 lookups x 256 floats, 34 GB) does not fit beside the
61 GB of full-size tables on one card.  A row's output depends on that
row alone, so the chunks change the function nowhere.

The tables are drawn in blocks of :data:`TABLE_BLOCK` rows, each from a
generator seeded by (seed, table, block) (:func:`table_rows`), so any
rows of a table can be drawn without the rest: a rank of a mesh draws
only its own (``init_two_tower_params(env=)``), and they are the whole
table's rows.

Sharded (the tree's leaves DTensors, ``launch.cells.shard_cell``: the
tables on ``("rows", None)``, the MLPs and ``temp`` replicated, the batch
on ``batch`` and retrieval's candidates on ``("rows", None)``), each rank
works on local tensors, TorchRec's row-wise pattern: it gathers the
lookups and weights of its batch rows over the mesh dims that split both
the batch and the table (small: 393 KB a ``serve_p99`` call), sums in
each bag, in the unsharded order over ``M``, the lookups that fall in its
own table rows (the rest count zero), and the partial bags ``[B, F D]``
are reduce-scattered over those dims, back to the rank's batch rows, and
all-reduced over the table's other dims (:class:`_RowBag`, whose backward
gathers the bags' gradient and adds it into the rank's own rows).  The
towers' MLPs run on the rank's batch rows, their parameters taken with
partial gradients over the batch dims.  The loss gathers the item
embeddings over the batch dims (:class:`_Whole`, whose backward
reduce-scatters) and sums its rows' terms over them (:class:`_BatchSum`).
Retrieval scores each rank's candidate rows, takes a local top-k and
gathers the ranks' (score, global index) pairs, ordered by score and
then by index as ``lax.top_k`` orders ties.  Every collective is a named
:func:`~repro_torch.dist.sharding.redistribute`.  A mesh with no dim of
more than one rank runs the unsharded functions on the local tensors:
the unsharded bits.

This model is also the paper-integration point: the transaction stream
that feeds training is filtered by Spade's benign/urgent classifier
(``examples/torch_fraud_aware_recsys.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.models.layers import normal_init

__all__ = ["RecsysBatch", "BAG_BYTES", "TABLE_BLOCK", "bag_rows", "table_rows",
           "init_two_tower_params", "user_tower", "item_tower", "two_tower_loss",
           "score_pairs", "retrieval_scores"]

BAG_BYTES = 1 << 32  # the gathered lookups of one chunk of batch rows (4 GiB)
TABLE_BLOCK = 1 << 16  # table rows drawn from one generator (64 MB of the full config's)
_TABLES = ("user_table", "item_table")


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


def _seed(seed: int, *path: int) -> int:
    """A generator seed for ``path`` under ``seed`` (numpy's SeedSequence)."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0])


def table_rows(cfg: RecsysConfig, name: str, lo: int, n: int, *, seed: int = 0,
               device: str | torch.device | None = None) -> torch.Tensor:
    """Rows ``[lo, lo + n)`` of table ``name`` (``user_table`` or
    ``item_table``) of the seeded init, on ``device`` (default ``cuda``):
    fan-in-scaled normals times 0.05.  Every block of :data:`TABLE_BLOCK`
    rows that they touch is drawn whole from its own generator, seeded by
    (seed, table, block), so they are the same rows whoever draws them."""
    dev = resolve_device(device)
    V = cfg.user_vocab if name == "user_table" else cfg.item_vocab
    if not 0 <= lo <= lo + n <= V:
        raise ValueError(f"table_rows: rows [{lo}, {lo + n}) of a {V}-row table")
    D, dtype = cfg.embed_dim, getattr(torch, cfg.dtype)
    out = torch.empty((n, D), dtype=dtype, device=dev)
    for b in range(lo // TABLE_BLOCK, -(-(lo + n) // TABLE_BLOCK)):
        start = b * TABLE_BLOCK
        rows = min(TABLE_BLOCK, V - start)
        gen = torch.Generator(device=dev).manual_seed(_seed(seed, _TABLES.index(name), b))
        a, z = max(lo, start), min(lo + n, start + rows)
        if (a, z) == (start, start + rows) and dtype == torch.float32:
            # the whole block is wanted: drawn in place, as normal_init draws it
            torch.randn((rows, D), generator=gen, out=out[a - lo:z - lo])
            out[a - lo:z - lo].div_(math.sqrt(D)).mul_(0.05)
        else:
            w = normal_init((rows, D), D, dtype, dev, gen).mul_(0.05)
            out[a - lo:z - lo] = w[a - start:z - start]
    return out


def init_two_tower_params(cfg: RecsysConfig, *, device: str | torch.device | None = None,
                          seed: int = 0, init: bool = True,
                          env: sharding.AxisEnv | None = None) -> dict:
    """The reference's tree: ``user_table`` [user_vocab, D] and
    ``item_table`` [item_vocab, D] (fan-in-scaled normals times 0.05,
    :func:`table_rows`), ``user_mlp`` / ``item_mlp`` (``w{i}`` fan-in-
    scaled normals from one generator seeded by ``seed``, the user tower's
    first; ``b{i}`` zeros) and ``temp`` (20), on ``device`` (default
    ``cuda``); ``init=False`` leaves them uninitialised (for loading, or
    on ``meta``).  With ``env``, the tree on its mesh as
    ``launch.cells.shard_cell`` places it: each table on ``("rows",
    None)``, this rank drawing only its own rows, the rest replicated."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(_seed(seed, len(_TABLES))) if init else None

    def tower(dims):
        pairs = list(zip(dims[:-1], dims[1:]))
        w = {f"w{i}": normal_init((a, b), a, dtype, dev, gen) if init
             else torch.empty((a, b), dtype=dtype, device=dev) for i, (a, b) in enumerate(pairs)}
        return w | {f"b{i}": torch.zeros(b, dtype=dtype, device=dev)
                    for i, (_, b) in enumerate(pairs)}

    def table(name, V):
        shape = (V, cfg.embed_dim)
        lo, n = 0, V
        if env is not None:
            with sharding.use_axis_env(env):
                sl = sharding.local_slices(shape, "rows", None)[0]
            lo, n = sl.start, sl.stop - sl.start
        t = (table_rows(cfg, name, lo, n, seed=seed, device=dev) if init
             else torch.empty((n, cfg.embed_dim), dtype=dtype, device=dev))
        if env is None:
            return t
        with sharding.use_axis_env(env):
            return sharding.place(t, "rows", None, local=True, shape=shape)

    D = cfg.embed_dim
    params = {
        "user_table": table("user_table", cfg.user_vocab),
        "item_table": table("item_table", cfg.item_vocab),
        "user_mlp": tower([cfg.n_user_fields * D, *cfg.tower_mlp]),
        "item_mlp": tower([cfg.n_item_fields * D, *cfg.tower_mlp]),
        "temp": torch.tensor(20.0, dtype=dtype, device=dev),
    }
    if env is None:
        return params
    with sharding.use_axis_env(env):
        rep = lambda t: sharding.place(t, *(None,) * t.dim())
        return params | {k: {n: rep(t) for n, t in params[k].items()}
                         for k in ("user_mlp", "item_mlp")} | {"temp": rep(params["temp"])}


def bag_rows(n_fields: int, multi_hot: int, embed_dim: int, itemsize: int = 4) -> int:
    """Batch rows a tower takes at once: as many as keep their gathered
    lookups within :data:`BAG_BYTES` (32,768 rows of the full config's
    user tower).  On a mesh, a rank takes that many rows of the batch it
    gathers at once."""
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


# ---------------------------------------------------------------------------
# the sharded path: a rank's local tensors
# ---------------------------------------------------------------------------


def _split(t) -> tuple[int, ...]:
    """The mesh dims of more than one rank that split ``t``'s dim 0."""
    if not isinstance(t, DTensor):
        return ()
    return tuple(i for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim == 0 and t.device_mesh.size(i) > 1)


class _Share(NamedTuple):
    """A rank's share of a tower on a mesh: the mesh dims (of more than
    one rank) that split the table's rows and those that split the batch,
    and the rank's table rows ``[lo, lo + n)``."""

    mesh: object
    rows: tuple[int, ...]
    batch: tuple[int, ...]
    lo: int
    n: int

    @property
    def gather(self) -> tuple[int, ...]:
        """The dims that split both: a rank gathers its batch rows' lookups
        over them and reduce-scatters the partial bags back."""
        return tuple(d for d in self.batch if d in self.rows)


def _mesh_over(mesh, dims: tuple[int, ...]):
    """The 1-D mesh of ``mesh``'s ranks along ``dims`` (several dims
    flattened, in mesh order, as nested ``Shard(0)`` splits a dim), so
    that a move over them is one collective."""
    if len(dims) == 1:
        return mesh[mesh.mesh_dim_names[dims[0]]]
    return sharding.mesh_group(mesh, dims)


def _on(x: torch.Tensor, mesh1, placement, n0: int) -> DTensor:
    shape = (n0,) + tuple(x.shape[1:])
    return DTensor.from_local(x.contiguous(), mesh1, [placement], run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _whole(x: torch.Tensor, mesh, dims: tuple[int, ...]) -> torch.Tensor:
    """A rank's rows ``x`` of a tensor split over ``dims`` (dim 0), gathered
    whole by one named redistribute; ``x`` without dims."""
    if not dims:
        return x
    m = _mesh_over(mesh, dims)
    return sharding.redistribute(_on(x, m, Shard(0), x.shape[0] * m.size()),
                                 [Replicate()]).to_local()


def _summed(x: torch.Tensor, mesh, dims: tuple[int, ...], scatter: bool) -> torch.Tensor:
    """The ranks' partial sums ``x`` over ``dims`` added by one named
    redistribute: reduce-scattered to the rank's rows of dim 0 when
    ``scatter``, else all-reduced; ``x`` without dims."""
    if not dims:
        return x
    m = _mesh_over(mesh, dims)
    return sharding.redistribute(_on(x, m, Partial(), x.shape[0]),
                                 [Shard(0) if scatter else Replicate()]).to_local()


class _RowBag(torch.autograd.Function):
    """``_RowBag.apply(table, idx, wt, sh)``: the rank's local ``table``
    rows, and the lookups ``idx`` and weights ``wt`` [Bg, F, M] of the
    batch rows it gathered, to its own batch rows' bags [b, F D]: each bag
    sums, in order over ``M``, the lookups that fall in the rank's rows
    ``[lo, lo + n)`` (the rest count zero), then the partial bags are
    reduce-scattered over the gather dims and all-reduced over the
    table's other dims.  Backward: the bags' gradient gathered over the
    gather dims and added into the rank's own rows (of its lookups that
    hit them; on ``meta``, every lookup: shapes only)."""

    @staticmethod
    def forward(ctx, table, idx, wt, sh: _Share):
        Bg, F, M = idx.shape
        idx = idx.to(torch.int64)
        hit = (idx >= sh.lo) & (idx < sh.lo + sh.n)
        li = torch.where(hit, idx - sh.lo, 0).reshape(Bg * F, M)
        w = torch.where(hit, wt.to(table.dtype), 0).reshape(Bg * F, M)
        acc = None
        for j in range(M):
            r = table.index_select(0, li[:, j]).mul_(w[:, j, None])
            acc = r if acc is None else acc.add_(r)
        part = acc.reshape(Bg, F * table.shape[1])
        ctx.save_for_backward(li, w, hit)
        ctx.sh, ctx.n_rows = sh, table.shape[0]
        out = _summed(part, sh.mesh, sh.gather, scatter=True)
        rest = tuple(d for d in sh.rows if d not in sh.gather)
        return _summed(out, sh.mesh, rest, scatter=False)

    @staticmethod
    def backward(ctx, g):
        li, w, hit = ctx.saved_tensors
        sh = ctx.sh
        g = _whole(g.contiguous(), sh.mesh, sh.gather)  # [Bg, F D]
        M = li.shape[1]
        rows = g.reshape(li.shape[0], -1)  # [Bg F, D]
        hits = (torch.arange(li.numel(), device=li.device) if hit.is_meta
                else hit.reshape(-1).nonzero().squeeze(1))
        contrib = rows.index_select(0, hits // M) * w.reshape(-1)[hits, None]
        grad = torch.zeros((ctx.n_rows, rows.shape[1]), dtype=rows.dtype, device=rows.device)
        return grad.index_add_(0, li.reshape(-1)[hits], contrib), None, None, None


class _Whole(torch.autograd.Function):
    """``_Whole.apply(x, mesh, dims)``: the rank's rows ``x`` gathered whole
    over ``dims``.  Each rank reads the whole tensor for its own rows, so
    its gradient is a partial sum: the backward reduce-scatters it."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return _whole(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return _summed(g.contiguous(), ctx.mesh, ctx.dims, scatter=True), None, None


class _BatchSum(torch.autograd.Function):
    """A rank's partial sum over its batch rows added over ``dims`` by one
    all-reduce; each rank's part enters the sum once: the backward is the
    gradient as it comes."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return _summed(x.reshape(1), mesh, dims, scatter=False).reshape(())

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _grad_pl(t: DTensor, batch: tuple[int, ...]) -> list:
    """The placements of the local gradient of ``t`` (a parameter every
    rank of a batch dim reads for its own rows): a partial sum over the
    batch dims that do not split ``t``, ``t``'s placements elsewhere."""
    return [Partial() if i in batch and not isinstance(p, Shard) else p
            for i, p in enumerate(t.placements)]


def _local_params(tree, batch):
    if isinstance(tree, dict):
        return {k: _local_params(v, batch) for k, v in tree.items()}
    return tree.to_local(grad_placements=_grad_pl(tree, batch))


def _share(table: DTensor, idx) -> _Share:
    lo, n = sharding.shard_span(table, 0)
    return _Share(table.device_mesh, _split(table), _split(idx), lo, n)


def _tower_on_mesh(table: DTensor, mlp, idx, wt, cfg: RecsysConfig) -> torch.Tensor:
    """A tower on a mesh: the rank's batch rows' outputs [b, K], local.
    The local batch runs in chunks whose gathered rows stay within
    :func:`bag_rows`; with the table whole on the rank, the unsharded
    tower on its local tensors."""
    sh = _share(table, idx)
    t = table.to_local(grad_placements=_grad_pl(table, sh.batch))
    p = _local_params(mlp, sh.batch)
    il, wl = sharding.local(idx), sharding.local(wt)
    if not sh.rows:
        return _run_tower(t, p, il, wl, cfg)
    k = max(1, bag_rows(il.shape[1], il.shape[2], cfg.embed_dim, t.element_size())
            // math.prod(sh.mesh.size(d) for d in sh.gather))
    out = []
    for i in range(0, il.shape[0], k):
        ig, wg = (_whole(x[i:i + k], sh.mesh, sh.gather) for x in (il, wl))
        out.append(_tower(p, _RowBag.apply(t, ig, wg, sh), len(cfg.tower_mlp)))
    return out[0] if len(out) == 1 else torch.cat(out)


def _rows_out(x: torch.Tensor, like, n0: int) -> torch.Tensor:
    """The rank's batch rows ``x`` (local) as a DTensor on ``like``'s mesh,
    split over the dims that split ``like``'s batch."""
    mesh = like.device_mesh
    batch = _split(like)
    shape = (n0,) + tuple(x.shape[1:])
    return DTensor.from_local(x, mesh, [Shard(0) if i in batch else Replicate()
                                        for i in range(mesh.ndim)],
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _sharded(params) -> bool:
    return isinstance(params["user_table"], DTensor)


def user_tower(params, idx, wt, cfg: RecsysConfig):
    """[B, Fu, M] lookups -> [B, tower_mlp[-1]] unit vectors (on a mesh:
    the rank's batch rows, local)."""
    if _sharded(params):
        return _tower_on_mesh(params["user_table"], params["user_mlp"], idx, wt, cfg)
    return _run_tower(params["user_table"], params["user_mlp"], idx, wt, cfg)


def item_tower(params, idx, wt, cfg: RecsysConfig):
    """[B, Fi, M] lookups -> [B, tower_mlp[-1]] unit vectors (on a mesh:
    the rank's batch rows, local)."""
    if _sharded(params):
        return _tower_on_mesh(params["item_table"], params["item_mlp"], idx, wt, cfg)
    return _run_tower(params["item_table"], params["item_mlp"], idx, wt, cfg)


def _temp(params, batch_idx) -> torch.Tensor:
    t = params["temp"]
    return t.to_local(grad_placements=_grad_pl(t, _split(batch_idx))) if isinstance(
        t, DTensor) else t


def two_tower_loss(params, batch: RecsysBatch, cfg: RecsysConfig):
    """In-batch sampled softmax with logQ correction: ``(loss,
    {"in_batch_acc"})``, differentiable when grad mode is on.  On a mesh
    each rank takes the logits of its batch rows against every item (the
    item embeddings gathered over the batch dims) and the loss's terms are
    summed over the batch dims: every rank holds the loss, a plain
    tensor."""
    u = user_tower(params, batch.user_idx, batch.user_wt, cfg)  # [B, D]
    it = item_tower(params, batch.item_idx, batch.item_wt, cfg)  # [B, D]
    temp = _temp(params, batch.user_idx)
    if not (_sharded(params) and _split(batch.user_idx)):
        log_q = sharding.local(batch.log_q)
        logits = (u @ it.T) * temp  # [B, B]
        logits = logits - log_q.to(logits.device)[None, :]  # correct for sampling bias
        labels = torch.arange(u.shape[0], device=u.device)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.diagonal()
        loss = (lse - ll).mean()
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        return loss, {"in_batch_acc": acc}
    mesh, dims = batch.user_idx.device_mesh, _split(batch.user_idx)
    B = batch.user_idx.shape[0]
    lo, b = sharding.shard_span(batch.user_idx, 0)
    logits = (u @ _Whole.apply(it, mesh, dims).T) * temp  # [b, B]
    logits = logits - _whole(sharding.local(batch.log_q), mesh, dims)[None, :]
    labels = lo + torch.arange(b, device=u.device)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits[torch.arange(b, device=u.device), labels]
    loss = _BatchSum.apply((lse - ll).sum(), mesh, dims) / B
    hits = (logits.argmax(dim=-1) == labels).float().sum().detach()
    acc = _summed(hits.reshape(1), mesh, dims, scatter=False).reshape(()) / B
    return loss, {"in_batch_acc": acc}


def score_pairs(params, batch: RecsysBatch, cfg: RecsysConfig):
    """Online/offline scoring: one score per (user, item) row, [B] (on a
    mesh, a DTensor split over the batch's dims)."""
    u = user_tower(params, batch.user_idx, batch.user_wt, cfg)
    it = item_tower(params, batch.item_idx, batch.item_wt, cfg)
    s = torch.sum(u * it, dim=-1) * _temp(params, batch.user_idx)
    if not _sharded(params):
        return s
    return _rows_out(s, batch.user_idx, batch.user_idx.shape[0])


def retrieval_scores(params, user_idx, user_wt, cand_emb, cfg: RecsysConfig, top_k=100):
    """One query against N precomputed candidate embeddings [N, D] (one
    matrix-vector product): ``(top-k scores, their indices)``, best first.
    On a mesh the query's bag is all-reduced over the table's dims, each
    rank scores its candidate rows and takes a local top-k, and one
    gather of the ranks' (score, global index) pairs gives the top-k, ties
    by index ascending; every rank holds it."""
    u = user_tower(params, user_idx, user_wt, cfg)  # [1, D]
    scores = (sharding.local(cand_emb) @ u[0]) * _temp(params, user_idx)  # [N] (a rank's rows)
    dims = _split(cand_emb)
    if not dims:
        return torch.topk(scores, top_k)
    lo, n = sharding.shard_span(cand_emb, 0)
    v, i = torch.topk(scores, min(top_k, n))
    pairs = _whole(torch.stack([v.double(), (i + lo).double()], dim=1),
                   cand_emb.device_mesh, dims)  # [k R, 2]: exact in float64
    pairs = pairs[torch.argsort(pairs[:, 1], stable=True)]
    pairs = pairs[torch.argsort(-pairs[:, 0], stable=True)][:top_k]
    return pairs[:, 0].to(scores.dtype), pairs[:, 1].to(torch.int64)
