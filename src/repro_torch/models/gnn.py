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

Every kind runs sharded when its batch is DTensors placed by the
reference's logical axes (``launch.cells.shard_cell``: the vertex arrays
on ``vertex``, the edge and triplet arrays on ``edges``, the parameters
replicated).  Each rank works on its own edge block, gathers the node
state whole over the vertex dims (:class:`_GatherRows`, whose backward
reduce-scatters the gradient and sums it over the edge group), scatters
only the edges of its block whose destination lies in its vertex rows
``[lo, lo + n)`` (:func:`_ends_in`), so that each edge's scatter runs on
one rank, and settles its rows' partial sums over the edge group
(:func:`_settle_rows`, one all-reduce).  GCN builds those rows as K4's
destination rows (:func:`gcn_rows_sharded`; the degrees summed over the
edge group) and runs K4 under ``local_map``.  GAT's edge softmax spans
the edge group: each destination's max by one all-reduce (detached: the
softmax does not depend on the shift) and its denominator by another
under autograd (:func:`_edge_sum`), the ``1e-9`` added once to the summed
denominator.  MeshGraphNet keeps its edge state on ``("edges", None)``
(each rank its block's ``[E_b, H]``, repeated over ``vertex``), and
DimeNet its messages; DimeNet reads ``m[tri_in]`` and ``edge_len[tri_out]``
from them gathered whole over the edge dims and reduce-scatters the
triplets' partial sums back to the edge block (:class:`_EdgesWhole`,
:class:`_EdgesSummed`).  Node-level work (the projections, the MLPs on
node rows, the decoders) runs on DTensor rows; edge-level work on the
rank's local tensors, the parameters it reads taken with partial
gradients over every split dim.  The gradient of an edge tensor repeated
over ``vertex`` is kept as each rank's partial sum, which the linear
backward carries to the parameters and to the gathered node state.
Every collective is a named redistribute, :func:`~repro_torch.dist.
sharding.settle` or an ``autograd.Function`` that states its backward;
the loss's numerator and count are summed over the vertex shards.

Parameters keep the reference's tree layout (``x @ w``; MeshGraphNet's
``proc_*`` and DimeNet's ``blocks`` stacked with a leading L dimension);
:class:`GNN` holds such a tree as module parameters, and
:mod:`repro_torch.convert` carries the reference's trees across.  The
reference's sharding hints (``constrain``) are no-ops on one device and
are dropped; its scans become Python loops, and the rematerialisation of
its scanned bodies stays: MeshGraphNet's processor step and DimeNet's
interaction block run under ``torch.utils.checkpoint`` (non-reentrant)
when grad mode is on, as the reference's ``jax.checkpoint`` (so the
backward stores each step's carries, not its ``[E, 3H]`` concatenation or
``[T, B, H]`` product; on a mesh the step's gathers run again in the
backward).  GAT, MeshGraphNet and DimeNet take their gradients from
autograd over plain ops, as the reference's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.graphstore.segment_ops import (segment_max, segment_mean, segment_softmax,
                                                segment_sum)
from repro_torch.kernels.gather_segsum import BlockRows, build_rows, gather_segsum
from repro_torch.kernels.gather_segsum.ref import spmm_rows_ref
from repro_torch.models.layers import normal_init

__all__ = ["GraphBatch", "GCNRows", "GNN", "init_gnn_params", "gcn_edge_weights", "gcn_rows",
           "gcn_rows_sharded", "gnn_forward", "gnn_loss", "make_triplets", "flatten_params",
           "unflatten_params"]


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
    """GCN's normalised adjacency as destination rows, built once per graph
    (on a mesh: a rank's rows of its edge block, :func:`gcn_rows_sharded`)."""

    fwd: BlockRows  # src -> dst, weights inv_sqrt[src] * inv_sqrt[dst]
    bwd: BlockRows  # dst -> src, the same weights
    self_weight: torch.Tensor  # [N] inv_sqrt^2, the self loop (a rank's rows)
    fwd_t: BlockRows | None = None  # fwd's transpose; None: bwd (the whole graph)
    bwd_t: BlockRows | None = None  # bwd's transpose; None: fwd


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


def _k4(rows: BlockRows, x: torch.Tensor, n_out: int) -> torch.Tensor:
    """K4 (its plain version on the CPU); a meta tensor (the dry run's
    trace) holds no data to launch K4 on: it takes the plain version, for
    shapes."""
    if x.device.type == "meta":
        return spmm_rows_ref(rows, x)[:n_out]
    return gather_segsum(rows, x, n_out)


class _GcnAggregate(torch.autograd.Function):
    """``_GcnAggregate.apply(x, fwd, bwd, fwd_t=None, bwd_t=None) =
    gather_segsum(fwd, x, n) + gather_segsum(bwd, x, n)``, ``n =
    fwd.n_out``.  The gradient is the same two launches on the incoming
    gradient through the two matrices' transposes, ``fwd_t`` and
    ``bwd_t``.  Without them ``bwd`` must hold the transpose of ``fwd``'s
    matrix, as :func:`gcn_rows` builds them from one set of symmetric edge
    weights (both square and of one size), and each direction's term goes
    through the other direction's rows.  The matrices take no gradient."""

    @staticmethod
    def forward(ctx, x, fwd: BlockRows, bwd: BlockRows, fwd_t: BlockRows | None = None,
                bwd_t: BlockRows | None = None):
        n, N = fwd.n_out, x.shape[0]
        if fwd_t is None and bwd_t is None:
            if {fwd.n_src, bwd.n_out, bwd.n_src} != {n}:
                raise ValueError(f"_GcnAggregate: fwd is {n} x {fwd.n_src}, bwd {bwd.n_out} "
                                 f"x {bwd.n_src}; both must be square and of one size")
            fwd_t, bwd_t = bwd, fwd
        elif (bwd.n_out, fwd.n_src, bwd.n_src) != (n, N, N) or {
                (t.n_out, t.n_src) for t in (fwd_t, bwd_t)} != {(N, n)}:
            raise ValueError(f"_GcnAggregate: fwd {n} x {fwd.n_src}, bwd {bwd.n_out} x "
                             f"{bwd.n_src} and their transposes {N} x {n} over x of {N} rows")
        ctx.rows = (fwd_t, bwd_t)
        return _k4(fwd, x, n) + _k4(bwd, x, n)

    @staticmethod
    def backward(ctx, g):
        fwd_t, bwd_t = ctx.rows
        g = g.contiguous()
        n = fwd_t.n_out
        return _k4(fwd_t, g, n) + _k4(bwd_t, g, n), None, None, None, None


def _gcn_forward(p, g: GraphBatch, cfg: GNNConfig, rows: GCNRows | None):
    if isinstance(g.node_feat, DTensor):
        return _gcn_forward_sharded(p, g, rows)
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


def _mesh_dims(t: DTensor) -> list[int]:
    """The mesh dims (of more than one rank) that shard ``t``."""
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and t.device_mesh.size(i) > 1]


class _Shards(NamedTuple):
    """A rank's share of a batch of DTensors: its mesh, the mesh dims that
    split the vertex rows (``vertex``) and the edge arrays (``edges``), and
    its vertex rows ``[lo, lo + n)`` of ``N``."""

    mesh: object
    vertex: tuple[int, ...]
    edges: tuple[int, ...]
    lo: int
    n: int
    N: int

    def _pl(self, on_vertex, on_edges) -> list:
        return [on_vertex if i in self.vertex else on_edges if i in self.edges else Replicate()
                for i in range(self.mesh.ndim)]

    @property
    def whole(self) -> list:
        return [Replicate()] * self.mesh.ndim

    @property
    def rows(self) -> list:
        """A vertex array's placements: its rows split over ``vertex``."""
        return self._pl(Shard(0), Replicate())

    @property
    def part_rows(self) -> list:
        """The rank's rows' partial sums over the edge group."""
        return self._pl(Shard(0), Partial())

    @property
    def block(self) -> list:
        """An edge array's placements: its edges split over ``edges``."""
        return self._pl(Replicate(), Shard(0))

    @property
    def partial(self) -> list:
        """The gradient of a tensor every rank reads for its own work: a
        partial sum over every split dim."""
        return self._pl(Partial(), Partial())


def _shards(g: GraphBatch) -> _Shards:
    """The rank's share of ``g``, a batch of DTensors.  Edge dims of more
    than one mesh dim get their flattened group first, so that every move
    over them, DTensor's own too, is one collective."""
    feat, mesh = g.node_feat, g.node_feat.device_mesh
    lo, n = sharding.shard_span(feat, 0)
    edges = tuple(_mesh_dims(g.edge_src))
    if len(edges) > 1:
        sharding.mesh_group(mesh, edges)
    return _Shards(mesh, tuple(_mesh_dims(feat)), edges, lo, n, feat.shape[0])


def _ends_in(ends: torch.Tensor, sh: _Shards) -> torch.Tensor | None:
    """The mask of the rank's edge block whose ``ends`` lie in its vertex
    rows; None when every edge's do (one vertex shard) or on ``meta`` (the
    dry run's trace: shapes only, every edge of the block kept)."""
    if sh.n == sh.N or ends.device.type == "meta":
        return None
    return (ends >= sh.lo) & (ends < sh.lo + sh.n)


def _edge_reduce(t: torch.Tensor, sh: _Shards, op: str) -> torch.Tensor:
    """A local tensor with no gradient all-reduced over the edge group
    (one call over the edge dims' flattened group; none without them)."""
    if not sh.edges:
        return t
    return sharding.all_reduce(t, op, [sharding.mesh_group(sh.mesh, sh.edges)])


class _EdgeSum(torch.autograd.Function):
    """A local tensor's partial sums over the edge group added by one
    all-reduce.  Each rank reads the sum for its own edges, so its
    gradient is a partial sum too: the backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, x, sh: _Shards):
        ctx.sh = sh
        return _edge_reduce(x, sh, "sum")

    @staticmethod
    def backward(ctx, g):
        return _edge_reduce(g.contiguous(), ctx.sh, "sum"), None


def _edge_sum(x: torch.Tensor, sh: _Shards) -> torch.Tensor:
    """:class:`_EdgeSum` (``x`` itself without edge dims)."""
    return _EdgeSum.apply(x, sh) if sh.edges else x


def _dtensor(x: torch.Tensor, sh: _Shards, placements, n0: int) -> DTensor:
    """The local ``x`` as a DTensor of ``n0`` rows on ``sh``'s mesh."""
    shape = (n0,) + tuple(x.shape[1:])
    return DTensor.from_local(x, sh.mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _settle_rows(part: torch.Tensor, sh: _Shards) -> DTensor:
    """The rank's rows' partial sums ``part`` ([n, ...], local) settled
    over the edge group (:func:`~repro_torch.dist.sharding.settle`: one
    all-reduce), as DTensor rows.  Backward: each rank's partial sums take
    its rows' gradient as it comes, with no collective."""
    return sharding.settle(_dtensor(part.contiguous(), sh, sh.part_rows, sh.N))


class _EdgesWhole(torch.autograd.Function):
    """``_EdgesWhole.apply(x, sh, E)``: the rank's edge block ``x`` ([E_b,
    ...], local) gathered whole ([E, ...]) over the edge dims by one named
    redistribute.  Backward: the whole tensor's partial gradient
    reduce-scattered over the edge dims back to the block."""

    @staticmethod
    def forward(ctx, x, sh: _Shards, E: int):
        ctx.sh, ctx.E = sh, E
        return _edges_whole(x, sh, E)

    @staticmethod
    def backward(ctx, g):
        return _edges_summed(g.contiguous(), ctx.sh, ctx.E), None, None


def _edges_whole(x: torch.Tensor, sh: _Shards, E: int) -> torch.Tensor:
    """The rank's edge block ``x`` ([E_b, ...], local) gathered whole over
    the edge dims (one named redistribute)."""
    return sharding.redistribute(_dtensor(x.contiguous(), sh, sh.block, E), sh.whole).to_local()


def _edges_summed(x: torch.Tensor, sh: _Shards, E: int) -> torch.Tensor:
    """The ranks' partial sums ``x`` ([E, ...], local) over the edge dims,
    reduce-scattered to this rank's block (one named redistribute)."""
    pl = [Partial() if i in sh.edges else Replicate() for i in range(sh.mesh.ndim)]
    return sharding.redistribute(_dtensor(x, sh, pl, E), sh.block).to_local()


class _EdgesSummed(torch.autograd.Function):
    """``_EdgesSummed.apply(x, sh)``: the ranks' partial sums ``x`` ([E,
    ...], local) reduce-scattered over the edge dims to the rank's block
    (:func:`_edges_summed`).  Backward: the block's gradient gathered whole
    (:func:`_edges_whole`), each rank's partial sums taking the sum's
    gradient."""

    @staticmethod
    def forward(ctx, x, sh: _Shards):
        ctx.sh, ctx.E = sh, x.shape[0]
        return _edges_summed(x.contiguous(), sh, x.shape[0])

    @staticmethod
    def backward(ctx, g):
        return _edges_whole(g, ctx.sh, ctx.E), None


def _local_params(tree, sh: _Shards):
    """A parameter tree's local tensors for a rank's own work, each taking
    a partial gradient over every split dim (settled by the train step)."""
    if isinstance(tree, dict):
        return {k: _local_params(v, sh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_local_params(v, sh) for v in tree]
    return tree.to_local(grad_placements=sh.partial)


def _on_mesh(plain, sharded, p, g: GraphBatch, cfg: GNNConfig):
    """A GNN's forward on a batch of DTensors: ``sharded(p, g, cfg, sh)``,
    or, where no mesh dim of more than one rank splits the batch (a
    one-rank mesh), ``plain`` on the rank's local tensors, which gives
    the unsharded bits (the sharded path sums a gathered tensor's
    gradients in another order); the output as DTensor rows."""
    sh = _shards(g)
    if sh.vertex or sh.edges:
        return sharded(p, g, cfg, sh)
    out = plain(_local_params(p, sh), GraphBatch(*(sharding.local(t) for t in g)), cfg)
    return _dtensor(out, sh, sh.rows, sh.N)


def _gather_rows(h: DTensor, sh: _Shards) -> torch.Tensor:
    """DTensor rows ``h`` gathered whole (:class:`_GatherRows`), local, for
    the rank's own edges: a partial gradient over every split dim."""
    return _GatherRows.apply(h, sh.whole).to_local(grad_placements=sh.partial)


def _kept(x: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
    """The rows of ``x`` (one an edge of the block) that ``keep`` keeps."""
    return x if keep is None else x[keep]


def _edge_block(g: GraphBatch, sh: _Shards):
    """The rank's edge block ``(src, dst, mask)`` (long indices), the mask
    ``keep`` of its edges whose destination lies in its rows
    (:func:`_ends_in`) and those edges' destinations as indices into the
    rows (``seg``)."""
    src, dst = (sharding.local(t).long() for t in (g.edge_src, g.edge_dst))
    keep = _ends_in(dst, sh)
    return src, dst, sharding.local(g.edge_mask), keep, _kept(dst, keep) - sh.lo


def gcn_rows_sharded(g: GraphBatch) -> GCNRows:
    """This rank's part of :func:`gcn_rows` for a batch of DTensors (the
    vertex arrays row-sharded, the edge arrays split over the edge group):
    the degrees of its edge block summed over the edge group (one
    all-reduce), then, of its block's edges, those whose destination lies
    in the rank's vertex rows ``[lo, lo + n)`` as ``fwd`` ([n, N]), those
    whose source does as ``bwd``, both with their transposes ([N, n]), and
    the self-loop weights of its rows.  No rank builds another's rows."""
    sh = _shards(g)
    N, lo, n = sh.N, sh.lo, sh.n
    src, dst, mask = (sharding.local(t) for t in (g.edge_src, g.edge_dst, g.edge_mask))
    ones = mask.to(torch.float32)
    deg = _edge_reduce(segment_sum(ones, dst, N) + segment_sum(ones, src, N), sh, "sum")
    inv_sqrt = torch.rsqrt(deg + 1.0)
    ew = torch.where(mask, inv_sqrt[src.long()] * inv_sqrt[dst.long()], 0.0)
    if n == N:  # one vertex shard: the whole graph's rows of this block
        return GCNRows(fwd=build_rows(src, dst, ew, N, N), bwd=build_rows(dst, src, ew, N, N),
                       self_weight=inv_sqrt * inv_sqrt)

    def ends_in(ends, others):  # the edges of this block with an end in [lo, lo + n)
        keep = _ends_in(ends, sh)
        if keep is None:
            return ends - lo, others, ew
        return ends[keep] - lo, others[keep], ew[keep]

    d_in, s_of, w_in = ends_in(dst, src)
    s_out, d_of, w_out = ends_in(src, dst)
    return GCNRows(fwd=build_rows(s_of, d_in, w_in, n, N),
                   bwd=build_rows(d_of, s_out, w_out, n, N),
                   self_weight=(inv_sqrt * inv_sqrt)[lo:lo + n],
                   fwd_t=build_rows(d_in, s_of, w_in, N, n),
                   bwd_t=build_rows(s_out, d_of, w_out, N, n))


class _GatherRows(torch.autograd.Function):
    """``_GatherRows.apply(h, whole)``: ``h`` made whole by one named
    redistribute (an all-gather over the vertex dims).  Its gradient comes
    partial over the vertex and the edge dims; it is reduce-scattered over
    the vertex dims first, then all-reduced over the edge dims, so the
    all-reduce moves only the rank's rows."""

    @staticmethod
    def forward(ctx, h, whole):
        ctx.placements = tuple(h.placements)
        return sharding.redistribute(h, whole)

    @staticmethod
    def backward(ctx, g):
        rows = [p if isinstance(p, Shard) else q for p, q in zip(ctx.placements, g.placements)]
        return sharding.redistribute(sharding.redistribute(g, rows), ctx.placements), None


def _gcn_forward_sharded(p, g: GraphBatch, rows: GCNRows | None):
    """GCN on a mesh: ``x`` row-sharded on ``vertex``, the parameters
    replicated, each layer's ``h`` gathered whole (:class:`_GatherRows`,
    whose backward reduce-scatters its gradient), the rank's K4 launches
    under ``local_map`` giving its vertex rows' partial sums over the edge
    group (and, in the backward, its partial gradient of the whole ``h``),
    settled by one all-reduce over the edge group."""
    rows = rows if rows is not None else gcn_rows_sharded(g)
    feat = g.node_feat
    sh = _shards(g)
    aggregate = local_map(lambda hl: _GcnAggregate.apply(hl, *rows[:2], *rows[3:]),
                          out_placements=sh.part_rows,
                          in_placements=(sh.whole,), in_grad_placements=(sh.partial,),
                          device_mesh=sh.mesh)
    self_weight = DTensor.from_local(rows.self_weight[:, None], sh.mesh, feat.placements,
                                     run_check=False, shape=(sh.N, 1), stride=(1, 1))
    x = feat
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        h = x @ w + b
        agg = sharding.settle(aggregate(_GatherRows.apply(h, sh.whole)))
        x = agg + h * self_weight
        if i < len(p["w"]) - 1:
            x = F.relu(x)
    return x


def _gat_forward(p, g: GraphBatch, cfg: GNNConfig):
    if isinstance(g.node_feat, DTensor):
        return _on_mesh(_gat_forward, _gat_forward_sharded, p, g, cfg)
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


def _edge_softmax(logits: torch.Tensor, seg: torch.Tensor, sh: _Shards) -> torch.Tensor:
    """:func:`segment_softmax` of the rank's edges into its ``n`` rows,
    over the edge group: each row's max all-reduced (detached; a row no
    edge of the rank reaches gives ``-inf``, which the max passes, and
    the ``-inf -> 0`` fix comes after), its denominator summed by
    :func:`_edge_sum` and the ``1e-9`` added once, to the sum.  Without
    edge dims, :func:`segment_softmax` itself."""
    if not sh.edges:
        return segment_softmax(logits, seg, sh.n)
    m = _edge_reduce(segment_max(logits.detach(), seg, sh.n), sh, "max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = torch.exp(logits - m[seg])
    denom = _edge_sum(segment_sum(z, seg, sh.n), sh)
    return z / (denom[seg] + 1e-9)


def _gat_forward_sharded(p, g: GraphBatch, cfg: GNNConfig, sh: _Shards):
    """GAT on a mesh: each layer's ``h = x @ w`` on the rank's rows,
    gathered whole; ``es``/``ed`` from the whole ``h``; the logits, the
    edge softmax (:func:`_edge_softmax`) and the messages on the rank's
    edges with their destination in its rows; the messages' row sums
    settled over the edge group; the last layer's mean over heads on the
    rank's rows."""
    src, dst, mask, keep, seg = _edge_block(g, sh)
    src, dst, mask = (_kept(t, keep) for t in (src, dst, mask))
    x = g.node_feat
    for li, lp in enumerate(p["layers"]):
        last = li == len(p["layers"]) - 1
        heads, d_out = cfg.n_heads, lp["a_src"].shape[1]
        h = _gather_rows((x @ lp["w"]).reshape(sh.N, heads, d_out), sh)
        a_src, a_dst = (_local_params(lp[k], sh) for k in ("a_src", "a_dst"))
        es = torch.einsum("nhd,hd->nh", h, a_src)
        ed = torch.einsum("nhd,hd->nh", h, a_dst)
        logits = F.leaky_relu(es[src] + ed[dst], 0.2)
        logits = torch.where(mask[:, None], logits, -1e30)
        alpha = _edge_softmax(logits, seg, sh)
        msgs = h[src] * alpha[..., None]
        agg = _settle_rows(segment_sum(torch.where(mask[:, None, None], msgs, 0.0), seg, sh.n),
                           sh)
        x = agg.mean(dim=1) if last else F.elu(agg.reshape(sh.N, heads * d_out))
    return x


def _layer_norm(x, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _remat(fn, *args):
    """``fn(*args)``, rematerialised in the backward when grad mode is on
    (the reference's ``jax.checkpoint``): non-reentrant, so it stores
    ``args`` and recomputes the rest, collectives included."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _mgn_forward(p, g: GraphBatch, cfg: GNNConfig):
    if isinstance(g.node_feat, DTensor):
        return _on_mesh(_mgn_forward, _mgn_forward_sharded, p, g, cfg)
    N = g.node_feat.shape[0]
    n = cfg.mlp_layers
    src, dst = g.edge_src.long(), g.edge_dst.long()
    h = _layer_norm(_mlp(p["enc_node"], g.node_feat, n, final_act=True))
    e = _layer_norm(_mlp(p["enc_edge"], g.edge_feat, n, final_act=True))
    em = g.edge_mask[:, None]

    def step(h, e, pe, pn):
        e_in = torch.cat([e, h[src], h[dst]], dim=-1)
        e = e + torch.where(em, _layer_norm(_mlp(pe, e_in, n)), 0.0)
        if cfg.aggregator == "mean":
            agg = segment_mean(torch.where(em, e, 0.0), g.edge_dst, N)
        else:
            agg = segment_sum(torch.where(em, e, 0.0), g.edge_dst, N)
        h = h + _layer_norm(_mlp(pn, torch.cat([h, agg], dim=-1), n))
        return h, e

    for li in range(p["proc_edge"]["w0"].shape[0]):
        h, e = _remat(step, h, e, {k: v[li] for k, v in p["proc_edge"].items()},
                      {k: v[li] for k, v in p["proc_node"].items()})
    return _mlp(p["dec"], h, n)


def _mgn_forward_sharded(p, g: GraphBatch, cfg: GNNConfig, sh: _Shards):
    """MeshGraphNet on a mesh: ``h`` on ``("vertex", None)`` (DTensor rows),
    gathered whole each step for ``h[src]``/``h[dst]``; the edge state
    ``e`` on ``("edges", None)``, each rank its block's ``[E_b, H]`` (local,
    repeated over ``vertex``); ``agg`` the rank's rows' partial sums over
    the edge group, settled (a ``mean`` aggregator's counts summed over
    the edge group first).  Each step rematerialised, as unsharded."""
    n = cfg.mlp_layers
    src, dst, mask, keep, seg = _edge_block(g, sh)
    em = mask[:, None]
    h = _layer_norm(_mlp(p["enc_node"], g.node_feat, n, final_act=True))
    e = _layer_norm(_mlp(_local_params(p["enc_edge"], sh), sharding.local(g.edge_feat), n,
                         final_act=True))
    proc_edge = _local_params(p["proc_edge"], sh)
    count = None
    if cfg.aggregator == "mean":
        c = _edge_reduce(segment_sum(torch.ones(seg.shape, device=seg.device), seg, sh.n),
                         sh, "sum")
        count = _dtensor(torch.clamp(c, min=1e-9)[:, None], sh, sh.rows, sh.N)

    def step(h, e, pe, pn):
        hw = _gather_rows(h, sh)
        e_in = torch.cat([e, hw[src], hw[dst]], dim=-1)
        e = e + torch.where(em, _layer_norm(_mlp(pe, e_in, n)), 0.0)
        agg = _settle_rows(segment_sum(_kept(torch.where(em, e, 0.0), keep), seg, sh.n), sh)
        if count is not None:
            agg = agg / count
        h = h + _layer_norm(_mlp(pn, torch.cat([h, agg], dim=-1), n))
        return h, e

    for li in range(p["proc_edge"]["w0"].shape[0]):
        h, e = _remat(step, h, e, {k: v[li] for k, v in proc_edge.items()},
                      {k: v[li] for k, v in p["proc_node"].items()})
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


def _interaction(m, bp, tri_in, tri_out, tri_mask, sbf, rbf, E: int, whole, summed):
    """DimeNet's interaction block: directional message passing over the
    triplets k->j->i, ``m[tri_in]`` read from ``whole(m)`` and the
    triplets' sums over ``tri_out`` (E edges) put back by ``summed``.
    Returns ``(m, out)``."""
    m_kj = whole(m)[tri_in] @ bp["w_msg"]  # [T, H]
    basis = sbf @ bp["w_sbf"]  # [T, B]
    # einsum("tb,bhf,th->tf") as two products, never [T, B, H, H]
    inter = torch.einsum("tb,tbf->tf", basis, torch.einsum("th,bhf->tbf", m_kj, bp["w_bil"]))
    inter = torch.where(tri_mask[:, None], inter, 0.0)
    agg = summed(segment_sum(inter, tri_out, E))  # [E, H]
    m = F.silu(m + agg + rbf @ bp["w_rbf"])
    return m, F.silu(m @ bp["w_out1"]) @ bp["w_out2"]


def _dimenet_forward(p, g: GraphBatch, cfg: GNNConfig):
    if isinstance(g.node_feat, DTensor):
        return _on_mesh(_dimenet_forward, _dimenet_forward_sharded, p, g, cfg)
    N, E = g.node_feat.shape[0], g.edge_src.shape[0]
    src, dst = g.edge_src.long(), g.edge_dst.long()
    tri_in, tri_out = g.tri_in.long(), g.tri_out.long()
    rbf = _radial_basis(g.edge_len, cfg.n_radial)  # [E, R]
    x = g.node_feat @ p["embed_node"]  # [N, H]
    m = F.silu(x[src] + x[dst] + rbf @ p["embed_rbf"])  # [E, H]
    sbf = _spherical_basis(g.tri_angle, g.edge_len[tri_out], cfg.n_spherical, cfg.n_radial)
    block = lambda m, bp: _interaction(m, bp, tri_in, tri_out, g.tri_mask, sbf, rbf, E,
                                       lambda t: t, lambda t: t)
    outs = []
    for li in range(p["blocks"]["w_msg"].shape[0]):
        m, out = _remat(block, m, {k: v[li] for k, v in p["blocks"].items()})
        outs.append(out)
    per_edge = torch.stack(outs).sum(0)  # [E, H]
    per_node = segment_sum(torch.where(g.edge_mask[:, None], per_edge, 0.0), g.edge_dst, N)
    return _mlp(p["out"], per_node, 2)


def _dimenet_forward_sharded(p, g: GraphBatch, cfg: GNNConfig, sh: _Shards):
    """DimeNet on a mesh: ``x = node_feat @ embed_node`` on the rank's
    rows, gathered whole for ``x[src] + x[dst]``; ``m`` on the rank's edge
    block; the triplets on ``edges``, as the edges; each block reads
    ``m[tri_in]`` from ``m`` gathered whole over the edge dims
    (:class:`_EdgesWhole`) and reduce-scatters the triplets' partial sums
    over ``tri_out`` back to the block (:class:`_EdgesSummed`);
    ``edge_len[tri_out]`` from ``edge_len`` gathered whole (no gradient);
    ``per_node`` the rank's rows' partial sums, settled.  The path holds
    for any batch whose triplets split as its edges."""
    if tuple(_mesh_dims(g.tri_in)) != sh.edges:
        raise ValueError(f"dimenet: the triplets split over mesh dims {_mesh_dims(g.tri_in)}, "
                         f"the edges over {list(sh.edges)}: place both on 'edges'")
    E = g.edge_src.shape[0]
    src, dst, mask, keep, seg = _edge_block(g, sh)
    tri_in, tri_out = (sharding.local(t).long() for t in (g.tri_in, g.tri_out))
    tri_mask, tri_angle = sharding.local(g.tri_mask), sharding.local(g.tri_angle)
    edge_len = sharding.local(g.edge_len)
    whole_len = sharding.local(sharding.redistribute(g.edge_len, sh.whole)) if sh.edges \
        else edge_len
    q = _local_params({k: p[k] for k in ("embed_rbf", "blocks")}, sh)
    rbf = _radial_basis(edge_len, cfg.n_radial)  # [E_b, R]
    x = _gather_rows(g.node_feat @ p["embed_node"], sh)  # [N, H]
    m = F.silu(x[src] + x[dst] + rbf @ q["embed_rbf"])  # [E_b, H]
    sbf = _spherical_basis(tri_angle, whole_len[tri_out], cfg.n_spherical, cfg.n_radial)
    if sh.edges:
        whole = lambda t: _EdgesWhole.apply(t, sh, E)
        summed = lambda t: _EdgesSummed.apply(t, sh)
    else:
        whole = summed = lambda t: t
    block = lambda m, bp: _interaction(m, bp, tri_in, tri_out, tri_mask, sbf, rbf, E, whole,
                                       summed)
    outs = []
    for li in range(p["blocks"]["w_msg"].shape[0]):
        m, out = _remat(block, m, {k: v[li] for k, v in q["blocks"].items()})
        outs.append(out)
    per_edge = torch.stack(outs).sum(0)  # [E_b, H]
    part = _kept(torch.where(mask[:, None], per_edge, 0.0), keep)
    return _mlp(p["out"], _settle_rows(segment_sum(part, seg, sh.n), sh), 2)


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


def _nll_sums(logits, labels, node_mask):
    """(the masked nodes' summed cross-entropy, their count in float64,
    which rounds to float32 as the integer count does)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[:, None], dim=-1)[:, 0]
    return torch.where(node_mask, lse - ll, 0.0).sum(), node_mask.sum(dtype=torch.float64)


def gnn_loss(p: dict, g: GraphBatch, cfg: GNNConfig, rows: GCNRows | None = None):
    """Mean node cross-entropy over ``node_mask``: ``(loss, {})``,
    differentiable in ``p`` when grad mode is on.  On a sharded batch each
    rank sums its vertex rows under ``local_map``, and the numerator and
    the count are summed over the vertex shards (two all-reduces)."""
    logits = gnn_forward(p, g, cfg, rows)
    if not isinstance(logits, DTensor):
        num, cnt = _nll_sums(logits, g.labels, g.node_mask)
        return num / torch.clamp(cnt, min=1).to(torch.float32), {}
    rows_of = set(_mesh_dims(logits))
    pl = [Partial() if i in rows_of else Replicate() for i in range(logits.device_mesh.ndim)]
    num, cnt = local_map(_nll_sums, out_placements=(pl, pl),
                         in_placements=tuple(t.placements for t in (logits, g.labels,
                                                                    g.node_mask)),
                         device_mesh=logits.device_mesh)(logits, g.labels, g.node_mask)
    cnt = torch.clamp(sharding.settle(cnt), min=1).to(torch.float32)
    return sharding.settle(num) / cnt, {}


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
