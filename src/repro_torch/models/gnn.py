"""GNN zoo of the port (port of ``repro/models/gnn.py``): GCN, GAT,
MeshGraphNet and DimeNet, their forward and their loss, trainable.

GCN's two aggregations per layer (``A h`` over ``src -> dst`` and ``A^T h``
over ``dst -> src``, weights ``inv_sqrt[src] * inv_sqrt[dst]``) go through
:class:`_GcnAggregate`, an ``autograd.Function`` over
:func:`repro_torch.kernels.gather_segsum.gather_segsum`: the K4 kernel on
CUDA, its plain row-level version on the CPU, forward and backward (the
gradient of ``A h + A^T h`` is the same two aggregations of the incoming
gradient, as the two directions are transposes).  The weights depend only
on the graph, so both directions' destination rows are built once per graph by
:func:`gcn_rows` and passed to :func:`gnn_forward` (built there when not
given).  GAT, MeshGraphNet and DimeNet aggregate with ``segment_sum`` in
plain PyTorch, as the reference does outside any Pallas kernel.

Parameters keep the reference's tree layout (``x @ w``; MeshGraphNet's
``proc_*`` and DimeNet's ``blocks`` stacked with a leading L dimension);
:class:`GNN` holds such a tree as module parameters, and
:mod:`repro_torch.convert` carries the reference's trees across.  The
reference's sharding hints (``constrain``) are no-ops on one device and
are dropped; its scans become Python loops.  GAT, MeshGraphNet and DimeNet
take their gradients from autograd over plain ops, as the reference's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve_device
from repro_torch.graphstore.segment_ops import segment_mean, segment_softmax, segment_sum
from repro_torch.kernels.gather_segsum import BlockRows, build_rows, gather_segsum
from repro_torch.models.layers import normal_init

__all__ = ["GraphBatch", "GCNRows", "GNN", "init_gnn_params", "gcn_edge_weights", "gcn_rows",
           "gnn_forward", "gnn_loss", "make_triplets", "flatten_params", "unflatten_params"]


class GraphBatch(NamedTuple):
    """Static-shape graph inputs (the reference's fields).

    ``edge_src/edge_dst`` index ``node_feat``; padding edges point at node
    ``N-1`` with ``edge_mask = False``.  DimeNet fields may be size 1 for
    other models.
    """

    node_feat: torch.Tensor  # [N, F] f32
    edge_src: torch.Tensor  # [E] i32
    edge_dst: torch.Tensor  # [E] i32
    edge_mask: torch.Tensor  # [E] bool
    node_mask: torch.Tensor  # [N] bool
    edge_feat: torch.Tensor  # [E, Fe] f32 (meshgraphnet; else [E, 0])
    labels: torch.Tensor  # [N] i32
    tri_in: torch.Tensor  # [T] i32 edge id (k->j)
    tri_out: torch.Tensor  # [T] i32 edge id (j->i)
    tri_angle: torch.Tensor  # [T] f32
    tri_mask: torch.Tensor  # [T] bool
    edge_len: torch.Tensor  # [E] f32 distances (dimenet)


class GCNRows(NamedTuple):
    """GCN's normalised adjacency as destination rows, built once per graph."""

    fwd: BlockRows  # src -> dst, weights inv_sqrt[src] * inv_sqrt[dst]
    bwd: BlockRows  # dst -> src, the same weights
    self_weight: torch.Tensor  # [N] inv_sqrt^2, the self loop


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _mlp_params(w, dims: list[int]) -> dict:
    pairs = list(zip(dims[:-1], dims[1:]))
    return ({f"w{i}": w((a, b), a) for i, (a, b) in enumerate(pairs)}
            | {f"b{i}": w((b,), None) for i, (_, b) in enumerate(pairs)})


def _stack(trees: list[dict]) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _param_tree(cfg: GNNConfig, d_feat: int, d_edge_feat: int, make) -> dict:
    """The reference's parameter tree, each weight ``make(shape, fan_in)``
    and each bias ``make(shape, None)``."""
    H = cfg.d_hidden
    if cfg.kind == "gcn":
        dims = [d_feat] + [H] * (cfg.n_layers - 1) + [cfg.n_classes]
        pairs = list(zip(dims[:-1], dims[1:]))
        return {"w": [make((a, b), a) for a, b in pairs],
                "b": [make((b,), None) for _, b in pairs]}
    if cfg.kind == "gat":
        layers, d_in = [], d_feat
        for li in range(cfg.n_layers):
            last = li == cfg.n_layers - 1
            d_out = cfg.n_classes if last else H
            layers.append({"w": make((d_in, cfg.n_heads * d_out), d_in),
                           "a_src": make((cfg.n_heads, d_out), d_out),
                           "a_dst": make((cfg.n_heads, d_out), d_out)})
            d_in = d_out if last else cfg.n_heads * d_out
        return {"layers": layers}
    if cfg.kind == "meshgraphnet":
        L, n = cfg.n_layers, cfg.mlp_layers
        return {
            "enc_node": _mlp_params(make, [d_feat] + [H] * n),
            "enc_edge": _mlp_params(make, [d_edge_feat] + [H] * n),
            "proc_edge": _stack([_mlp_params(make, [3 * H] + [H] * n) for _ in range(L)]),
            "proc_node": _stack([_mlp_params(make, [2 * H] + [H] * n) for _ in range(L)]),
            "dec": _mlp_params(make, [H] * n + [cfg.n_classes]),
        }
    if cfg.kind == "dimenet":
        nr, ns, nb = cfg.n_radial, cfg.n_spherical, cfg.n_bilinear
        block = lambda: {"w_sbf": make((ns * nr, nb), ns * nr), "w_bil": make((nb, H, H), H),
                         "w_msg": make((H, H), H), "w_rbf": make((nr, H), nr),
                         "w_out1": make((H, H), H), "w_out2": make((H, H), H)}
        return {
            "embed_node": make((d_feat, H), d_feat),
            "embed_rbf": make((nr, H), nr),
            "blocks": _stack([block() for _ in range(cfg.n_layers)]),
            "out": _mlp_params(make, [H, H, cfg.n_classes]),
        }
    raise ValueError(cfg.kind)


def init_gnn_params(cfg: GNNConfig, d_feat: int, d_edge_feat: int = 4, *,
                    device: str | torch.device | None = None,
                    generator: torch.Generator | None = None) -> dict:
    """The reference's tree of fan-in-scaled normal weights (zero biases),
    drawn from ``generator`` (on ``device``; seeded with 0 when None)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    dtype = getattr(torch, cfg.dtype)

    def make(shape, fan_in):
        if fan_in is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return normal_init(shape, fan_in, dtype, dev, gen)

    return _param_tree(cfg, d_feat, d_edge_feat, make)


def flatten_params(tree, prefix: tuple = ()):
    """``(path, leaf)`` pairs of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_params(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_params(v, prefix + (i,))
    else:
        yield prefix, tree


def unflatten_params(items) -> dict:
    """The tree of :func:`flatten_params`'s pairs (int keys become lists)."""
    root: dict = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in range(len(node))]
        return node

    return fix(root)


class GNN(nn.Module):
    """A GNN's parameter tree on one device; ``forward(g, rows=None)`` is
    :func:`gnn_forward`.

    ``device=None`` means ``cuda`` (raising without a GPU; pass ``"cpu"``
    for the plain path).  Weights are drawn as :func:`init_gnn_params`
    draws them; ``init=False`` leaves them uninitialised, for loading
    (:func:`repro_torch.convert.gnn_params_from_numpy`).
    """

    def __init__(self, cfg: GNNConfig, d_feat: int, d_edge_feat: int = 4,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None, init: bool = True):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        if init:
            tree = init_gnn_params(cfg, d_feat, d_edge_feat, device=dev, generator=generator)
        else:
            tree = _param_tree(cfg, d_feat, d_edge_feat,
                               lambda shape, _: torch.empty(shape, dtype=dtype, device=dev))
        self._paths = []
        for path, leaf in flatten_params(tree):
            self._paths.append(path)
            self.register_parameter(self._name(path), nn.Parameter(leaf))

    @staticmethod
    def _name(path) -> str:
        return "__".join(str(k) for k in path)

    def params(self) -> dict:
        """The parameter tree in the reference's layout."""
        return unflatten_params((p, getattr(self, self._name(p))) for p in self._paths)

    def forward(self, g: GraphBatch, rows: GCNRows | None = None) -> torch.Tensor:
        return gnn_forward(self.params(), g, self.cfg, rows=rows)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _mlp(p: dict, x, n: int, act=F.relu, final_act=False):
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def gcn_edge_weights(g: GraphBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """GCN's symmetric normalisation of ``g``: the edge weights
    ``inv_sqrt[src] * inv_sqrt[dst]`` (0 on masked edges) and ``inv_sqrt``,
    with ``deg`` = in-degree + out-degree + 1 (the self loop)."""
    N = g.node_feat.shape[0]
    ones = g.edge_mask.to(torch.float32)
    deg = segment_sum(ones, g.edge_dst, N) + segment_sum(ones, g.edge_src, N) + 1.0
    inv_sqrt = torch.rsqrt(deg)
    ew = torch.where(g.edge_mask, inv_sqrt[g.edge_src.long()] * inv_sqrt[g.edge_dst.long()],
                     0.0)
    return ew, inv_sqrt


def gcn_rows(g: GraphBatch) -> GCNRows:
    """GCN's normalised adjacency of ``g`` as destination rows in both
    directions on ``g``'s device, and the self-loop weights."""
    N = g.node_feat.shape[0]
    ew, inv_sqrt = gcn_edge_weights(g)
    src, dst = g.edge_src, g.edge_dst
    return GCNRows(fwd=build_rows(src, dst, ew, N, N),
                   bwd=build_rows(dst, src, ew, N, N),
                   self_weight=inv_sqrt * inv_sqrt)


class _GcnAggregate(torch.autograd.Function):
    """``_GcnAggregate.apply(x, fwd, bwd) = gather_segsum(fwd, x, n) +
    gather_segsum(bwd, x, n)``, ``n = fwd.n_out``, where ``bwd`` holds the
    transpose of ``fwd``'s matrix, as :func:`gcn_rows` builds them from one
    set of symmetric edge weights (nothing else may call it: the backward
    is right only for such a pair).  The gradient of ``A x + A^T x`` is
    ``A^T g + A g``: the same two launches on the incoming gradient, each
    direction's term through the other direction's rows.  The matrices
    take no gradient."""

    @staticmethod
    def forward(ctx, x, fwd: BlockRows, bwd: BlockRows):
        n = fwd.n_out
        if {fwd.n_src, bwd.n_out, bwd.n_src} != {n}:
            raise ValueError(f"_GcnAggregate: fwd is {n} x {fwd.n_src}, bwd {bwd.n_out} "
                             f"x {bwd.n_src}; both must be square and of one size")
        ctx.rows = (fwd, bwd)
        return gather_segsum(fwd, x, n) + gather_segsum(bwd, x, n)

    @staticmethod
    def backward(ctx, g):
        fwd, bwd = ctx.rows
        g = g.contiguous()
        return gather_segsum(bwd, g, fwd.n_out) + gather_segsum(fwd, g, fwd.n_out), None, None


def _gcn_forward(p, g: GraphBatch, cfg: GNNConfig, rows: GCNRows | None):
    rows = rows if rows is not None else gcn_rows(g)
    x = g.node_feat
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        h = x @ w + b
        # symmetric-normalised aggregation over both directions + self loop
        agg = _GcnAggregate.apply(h, rows.fwd, rows.bwd)
        x = agg + h * rows.self_weight[:, None]
        if i < len(p["w"]) - 1:
            x = F.relu(x)
    return x


def _gat_forward(p, g: GraphBatch, cfg: GNNConfig):
    N = g.node_feat.shape[0]
    src, dst = g.edge_src.long(), g.edge_dst.long()
    x = g.node_feat
    for li, lp in enumerate(p["layers"]):
        last = li == len(p["layers"]) - 1
        heads, d_out = cfg.n_heads, lp["a_src"].shape[1]
        h = (x @ lp["w"]).reshape(N, heads, d_out)
        es = torch.einsum("nhd,hd->nh", h, lp["a_src"])
        ed = torch.einsum("nhd,hd->nh", h, lp["a_dst"])
        logits = F.leaky_relu(es[src] + ed[dst], 0.2)  # [E, H]
        logits = torch.where(g.edge_mask[:, None], logits, -1e30)
        alpha = segment_softmax(logits, g.edge_dst, N)  # [E, H]
        msgs = h[src] * alpha[..., None]  # [E, H, D]
        agg = segment_sum(torch.where(g.edge_mask[:, None, None], msgs, 0.0), g.edge_dst, N)
        x = agg.mean(dim=1) if last else F.elu(agg.reshape(N, heads * d_out))
    return x


def _layer_norm(x, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _mgn_forward(p, g: GraphBatch, cfg: GNNConfig):
    N = g.node_feat.shape[0]
    n = cfg.mlp_layers
    src, dst = g.edge_src.long(), g.edge_dst.long()
    h = _layer_norm(_mlp(p["enc_node"], g.node_feat, n, final_act=True))
    e = _layer_norm(_mlp(p["enc_edge"], g.edge_feat, n, final_act=True))
    em = g.edge_mask[:, None]
    for li in range(p["proc_edge"]["w0"].shape[0]):
        pe = {k: v[li] for k, v in p["proc_edge"].items()}
        pn = {k: v[li] for k, v in p["proc_node"].items()}
        e_in = torch.cat([e, h[src], h[dst]], dim=-1)
        e = e + torch.where(em, _layer_norm(_mlp(pe, e_in, n)), 0.0)
        if cfg.aggregator == "mean":
            agg = segment_mean(torch.where(em, e, 0.0), g.edge_dst, N)
        else:
            agg = segment_sum(torch.where(em, e, 0.0), g.edge_dst, N)
        h = h + _layer_norm(_mlp(pn, torch.cat([h, agg], dim=-1), n))
    return _mlp(p["dec"], h, n)


def _radial_basis(d, n_radial, cutoff=5.0):
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    d = torch.clamp(d, min=1e-6)[:, None]
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d


def _spherical_basis(angle, d, n_spherical, n_radial, cutoff=5.0):
    # separable Fourier-Bessel-flavoured basis: cos(l*theta) * sin(n*pi*d/c)/d
    l = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=angle.device)
    ang = torch.cos(l[None, :] * angle[:, None])  # [T, S]
    dd = torch.clamp(d, min=1e-6)[:, None]
    rad = torch.sin(n * math.pi * dd / cutoff) / dd  # [T, R]
    return (ang[:, :, None] * rad[:, None, :]).reshape(angle.shape[0], -1)  # [T, S*R]


def _dimenet_forward(p, g: GraphBatch, cfg: GNNConfig):
    N, E = g.node_feat.shape[0], g.edge_src.shape[0]
    src, dst = g.edge_src.long(), g.edge_dst.long()
    tri_in, tri_out = g.tri_in.long(), g.tri_out.long()
    rbf = _radial_basis(g.edge_len, cfg.n_radial)  # [E, R]
    x = g.node_feat @ p["embed_node"]  # [N, H]
    m = F.silu(x[src] + x[dst] + rbf @ p["embed_rbf"])  # [E, H]
    sbf = _spherical_basis(g.tri_angle, g.edge_len[tri_out], cfg.n_spherical, cfg.n_radial)
    outs = []
    for li in range(p["blocks"]["w_msg"].shape[0]):
        bp = {k: v[li] for k, v in p["blocks"].items()}
        # directional message passing over triplets k->j->i
        m_kj = m[tri_in] @ bp["w_msg"]  # [T, H]
        basis = sbf @ bp["w_sbf"]  # [T, B]
        # einsum("tb,bhf,th->tf") as two products, never [T, B, H, H]
        inter = torch.einsum("tb,tbf->tf", basis, torch.einsum("th,bhf->tbf", m_kj, bp["w_bil"]))
        inter = torch.where(g.tri_mask[:, None], inter, 0.0)
        agg = segment_sum(inter, g.tri_out, E)  # [E, H]
        m = F.silu(m + agg + rbf @ bp["w_rbf"])
        outs.append(F.silu(m @ bp["w_out1"]) @ bp["w_out2"])
    per_edge = torch.stack(outs).sum(0)  # [E, H]
    per_node = segment_sum(torch.where(g.edge_mask[:, None], per_edge, 0.0), g.edge_dst, N)
    return _mlp(p["out"], per_node, 2)


def gnn_forward(p: dict, g: GraphBatch, cfg: GNNConfig,
                rows: GCNRows | None = None) -> torch.Tensor:
    """Logits ``[N, n_classes]`` (``[N, d_out]`` for GAT's last layer).
    ``rows``: GCN's :func:`gcn_rows` of ``g`` (built here when None); the
    other kinds take none."""
    if cfg.kind == "gcn":
        return _gcn_forward(p, g, cfg, rows)
    if rows is not None:
        raise ValueError(f"{cfg.kind}: only GCN aggregates through destination rows")
    fn = {"gat": _gat_forward, "meshgraphnet": _mgn_forward,
          "dimenet": _dimenet_forward}[cfg.kind]
    return fn(p, g, cfg)


def gnn_loss(p: dict, g: GraphBatch, cfg: GNNConfig, rows: GCNRows | None = None):
    """Mean node cross-entropy over ``node_mask``: ``(loss, {})``,
    differentiable in ``p`` when grad mode is on."""
    logits = gnn_forward(p, g, cfg, rows)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, g.labels.long()[:, None], dim=-1)[:, 0]
    nll = torch.where(g.node_mask, lse - ll, 0.0)
    return nll.sum() / torch.clamp(g.node_mask.sum(), min=1), {}


# ---------------------------------------------------------------------------
# host-side triplet construction (dimenet data pipeline; numpy copy)
# ---------------------------------------------------------------------------


def make_triplets(src: np.ndarray, dst: np.ndarray, cap_per_edge: int,
                  rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each edge (j->i), sample up to ``cap_per_edge`` incoming edges
    (k->j); returns (tri_in, tri_out, mask) of static size E * cap."""
    E = src.shape[0]
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(int(max(dst.max(initial=0), src.max(initial=0)) + 2), np.int64)
    np.add.at(indptr, dst + 1, 1)
    np.cumsum(indptr, out=indptr)
    tri_in = np.zeros(E * cap_per_edge, np.int32)
    tri_out = np.zeros(E * cap_per_edge, np.int32)
    mask = np.zeros(E * cap_per_edge, bool)
    for e in range(E):
        j = src[e]
        lo, hi = indptr[j], indptr[j + 1]
        incoming = order[lo:hi]
        incoming = incoming[incoming != e]
        if incoming.shape[0] == 0:
            continue
        take = min(cap_per_edge, incoming.shape[0])
        sel = rng.choice(incoming, size=take, replace=False)
        s = e * cap_per_edge
        tri_in[s : s + take] = sel
        tri_out[s : s + take] = e
        mask[s : s + take] = True
    return tri_in, tri_out, mask
