"""Cell matrix of the port (port of ``repro/launch/cells.py``): every
(architecture x input shape) combination as a runnable unit, a step
function, its arguments and the logical axes they shard over.

A *cell* is what the dry run traces on the ``meta`` device
(``build_cell(..., concrete=False)``: shapes and dtypes, no data), what
the training launcher steps, and what the tests and ``chip_smoke.py`` run
at smoke size (``concrete=True, smoke=True``): the 40 assigned cells and
the paper's own two.

``concrete=True`` draws every input array from
``np.random.default_rng(seed)`` in the reference's order, so the arrays
equal the reference's; the weights are the port's own seeded draw (a test
swaps in the reference's through :mod:`repro_torch.convert`).  The
logical axes (``in_logical``) are the reference's, over the reference's
layout of the arguments (an LM's layers stacked and its experts
unfolded): :func:`reference_args` gives that layout, which the sharding
layer places (:mod:`repro_torch.dist.sharding`).  ``model_flops`` are the
reference's formulas.  The reference donates a train step's state; the
port's train step updates it in place, to the same effect.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch import pytree
from repro_torch.configs import ARCH_FAMILY, Skip, arch_shapes, get_config, get_smoke_config
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig, ShapeSpec, SpadeConfig
from repro_torch.convert import lm_params_to_reference, train_state_to_reference
from repro_torch.core.incremental import DeviceSpadeState, init_state, insert_and_maintain
from repro_torch.core.peel import bulk_peel
from repro_torch.device import resolve_device
from repro_torch.graphstore.structs import DeviceGraph, device_graph_from_coo
from repro_torch.models.gnn import GNN, GraphBatch, gnn_loss, make_triplets
from repro_torch.models.transformer import (KVCache, TransformerLM, cache_window,
                                            decode_step, lm_loss, prefill)
from repro_torch.models.two_tower import (RecsysBatch, init_two_tower_params,
                                          retrieval_scores, score_pairs, two_tower_loss)
from repro_torch.train.optimizer import AdamConfig, TrainState, init_train_state
from repro_torch.train.train_step import make_train_step

__all__ = ["Cell", "MODEL_AXIS", "build_cell", "graph_batch", "reference_args",
           "lm_param_logical", "gnn_param_logical", "recsys_param_logical"]

MODEL_AXIS = 16  # 'model' mesh dim size in the production meshes

_META = torch.device("meta")


def _round_up(x: int, m: int = 512) -> int:
    """Shardable dims are padded to multiples of 512 (every mesh-dim
    product: pod * data = 32, data * model = 256); validity masks make the
    padding inert."""
    return -(-int(x) // m) * m


@dataclass
class Cell:
    arch: str
    shape: str
    family: str
    step_name: str
    fn: Callable  # fn(*args)
    args: tuple  # the port's arguments: tensors, modules and trees of them
    in_logical: tuple  # logical axes of reference_args(cell), tree for tree
    out_logical: Any  # logical axes of the outputs (or None: unspecified)
    model_flops: float = 0.0  # analytic "useful" FLOPs (the reference's formulas)

    def to(self, device: str | torch.device) -> Cell:
        """The cell with copies of its arguments on ``device`` (modules
        copied whole): the same weights and inputs on another device."""
        return dataclasses.replace(self, args=_move(self.args, resolve_device(device)))


def _move(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, copy=True)
    if isinstance(x, nn.Module):
        return copy.deepcopy(x).to(dev)
    if isinstance(x, dict):
        return {k: _move(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_move(v, dev) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_move(v, dev) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _move(getattr(x, f.name), dev)
                                         for f in dataclasses.fields(x)})
    return x


def reference_args(cell: Cell) -> tuple:
    """``cell.args`` in the reference's layout, on ``meta``: an LM module
    as the reference's tree (layers stacked, experts unfolded), an LM train
    state as :func:`~repro_torch.convert.train_state_to_reference` gives
    it, the rest as it is.  ``cell.in_logical`` names its dims."""
    def ref(x):
        if isinstance(x, TransformerLM):
            return lm_params_to_reference(x, _META)
        if isinstance(x, TrainState) and isinstance(x.params, TransformerLM):
            return train_state_to_reference(x, _META)
        return _move(x, _META)

    return tuple(ref(a) for a in cell.args)


def _tensor(shape, dtype, dev, draw=None) -> torch.Tensor:
    """``draw()`` (a numpy array) on ``dev``, or an empty tensor on meta."""
    if dev.type == "meta":
        return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device=dev)
    return torch.from_numpy(np.ascontiguousarray(draw())).to(dev)


# ---------------------------------------------------------------------------
# logical-axis rule trees (the reference's layout)
# ---------------------------------------------------------------------------


def lm_param_logical(cfg: LMConfig, fsdp: bool = True) -> dict:
    F = "fsdp" if fsdp else None
    layers: dict[str, Any] = {
        "attn_norm": (None, None),
        "mlp_norm": (None, None),
        "wq": (None, F, "model"),
        "wk": (None, F, "model"),
        "wv": (None, F, "model"),
        "wo": (None, "model", F),
    }
    if cfg.qk_norm:
        layers["q_norm"] = (None, None)
        layers["k_norm"] = (None, None)
    if cfg.moe:
        if cfg.moe.expert_parallel:
            layers["moe"] = {
                "router": (None, F, None),
                "w_gate": (None, "expert", F, None),
                "w_up": (None, "expert", F, None),
                "w_down": (None, "expert", None, F),
            }
        else:
            layers["moe"] = {
                "router": (None, F, None),
                "w_gate": (None, None, F, "model"),
                "w_up": (None, None, F, "model"),
                "w_down": (None, None, "model", F),
            }
    else:
        layers["mlp"] = {
            "w_gate": (None, F, "model"),
            "w_up": (None, F, "model"),
            "w_down": (None, "model", F),
        }
    return {
        "embed": ("model", F),
        "layers": layers,
        "final_norm": (None,),
        "head": (F, "model"),
    }


def _state_logical(param_logical) -> TrainState:
    return TrainState(params=param_logical, m=param_logical, v=param_logical, step=(),
                      err=None)


def gnn_param_logical(params) -> Any:
    # GNN params are small: replicated
    return pytree.tree_map(lambda p: tuple(None for _ in p.shape), params)


def recsys_param_logical() -> dict:
    """The reference's tree, which names three layers a tower: the full
    config's (1024-512-256); the smoke config's two-layer towers have no
    ``w2``/``b2`` to pair with it."""
    rep2 = (None, None)
    mlp = lambda n: {f"w{i}": rep2 for i in range(n)} | {f"b{i}": (None,) for i in range(n)}
    return {
        "user_table": ("rows", None),
        "item_table": ("rows", None),
        "user_mlp": mlp(3),
        "item_mlp": mlp(3),
        "temp": (),
    }


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm(cfg: LMConfig, dev) -> TransformerLM:
    """The port's seeded weights (uninitialised on meta)."""
    return TransformerLM(cfg, device=dev, init=dev.type != "meta")


def _tokens(rng, vocab: int, shape, dev) -> torch.Tensor:
    return _tensor(shape, torch.int32, dev,
                   lambda: rng.integers(0, vocab, shape).astype(np.int32))


def _lm_train_cell(arch, cfg: LMConfig, spec: ShapeSpec, rng, dev,
                   roofline: bool = False) -> Cell:
    B, S = spec.global_batch, spec.seq_len
    adam = AdamConfig()
    loss = lambda model, batch: lm_loss(model, batch["tokens"], batch["labels"])
    # microbatched gradient accumulation: 8x smaller live activations; the
    # roofline variant takes one microbatch (the same total FLOPs)
    micro = 1 if roofline else (8 if B >= 64 else 1)
    step = make_train_step(loss, adam, microbatches=micro)
    state = init_train_state(_lm(cfg, dev))
    tokens = _tokens(rng, cfg.vocab, (B, S), dev)
    batch = {"tokens": tokens, "labels": tokens}
    pl = lm_param_logical(cfg, fsdp=True)
    in_logical = (_state_logical(pl), {"tokens": ("batch", None), "labels": ("batch", None)})
    # 6ND (dense) / 6*N_active*D (MoE) + causal attention term
    n_act = cfg.n_active_params
    attn_flops = 2 * 3 * cfg.n_layers * B * S * S // 2 * cfg.n_heads * cfg.d_head
    mf = 6 * n_act * B * S + attn_flops
    return Cell(arch, spec.name, "lm", "train_step", step, (state, batch), in_logical,
                (_state_logical(pl), None), model_flops=mf)


def _lm_prefill_cell(arch, cfg: LMConfig, spec: ShapeSpec, rng, dev) -> Cell:
    B, S = spec.global_batch, spec.seq_len
    model = _lm(cfg, dev)
    tokens = _tokens(rng, cfg.vocab, (B, S), dev)
    pl = lm_param_logical(cfg, fsdp=False)
    cache_logical = KVCache(
        k=(None, "batch", "model", None, None), v=(None, "batch", "model", None, None)
    )
    mf = (2 * cfg.n_active_params * B * S
          + 2 * 2 * cfg.n_layers * B * S * S // 2 * cfg.n_heads * cfg.d_head)
    return Cell(arch, spec.name, "lm", "prefill", prefill, (model, tokens),
                (pl, ("batch", None)), (("batch", "model"), cache_logical),
                model_flops=mf)


def _lm_decode_cell(arch, cfg: LMConfig, spec: ShapeSpec, rng, dev) -> Cell:
    B, S = spec.global_batch, spec.seq_len
    W, _ = cache_window(cfg, S)
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    dt = getattr(torch, cfg.dtype)
    model = _lm(cfg, dev)
    cache = KVCache(k=torch.zeros((L, B, W, Hkv, Dh), dtype=dt, device=dev),
                    v=torch.zeros((L, B, W, Hkv, Dh), dtype=dt, device=dev))
    token = _tokens(rng, cfg.vocab, (B,), dev)
    pos = torch.full((B,), min(S - 1, W + 3), dtype=torch.int32, device=dev)
    pl = lm_param_logical(cfg, fsdp=False)
    b_ax = "batch" if B % 32 == 0 else None
    # GQA kv-heads (8) don't divide the model axis (16): shard the cache's
    # sequence dim instead (flash-decode style)
    cl = KVCache(k=(None, b_ax, "model", None, None), v=(None, b_ax, "model", None, None))
    mf = 2 * cfg.n_active_params * B + 2 * 2 * L * B * W * cfg.n_heads * Dh
    return Cell(arch, spec.name, "lm", "decode_step", decode_step,
                (model, cache, token, pos), (pl, cl, (b_ax,), (b_ax,)),
                ((b_ax, "model"), cl), model_flops=mf)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _graph_size(cfg: GNNConfig, spec: ShapeSpec) -> tuple[int, int, int]:
    """(nodes, edges, feature width) of ``spec``'s batch: a sampled block's
    worst case for ``graph_mini`` (seeds plus fanout expansion), all graphs
    of a ``graph_batch``; node and edge counts rounded up to 512."""
    if spec.kind == "graph_mini":
        e1 = spec.batch_nodes * spec.fanout[0]
        e2 = e1 * spec.fanout[1] if len(spec.fanout) > 1 else 0
        E = e1 + e2
        N = spec.batch_nodes + E  # every sampled edge can introduce a new node
    elif spec.kind == "graph_batch":
        N, E = spec.n_nodes * spec.n_graphs, spec.n_edges * spec.n_graphs
    else:
        N, E = spec.n_nodes, spec.n_edges
    return _round_up(N), _round_up(E), spec.d_feat if spec.d_feat else cfg.d_feat


def _graph_batch_meta(cfg: GNNConfig, spec: ShapeSpec) -> GraphBatch:
    """The shapes and dtypes of the reference's abstract batch."""
    N, E, F = _graph_size(cfg, spec)
    T = E * cfg.triplet_cap_per_edge if cfg.kind == "dimenet" else 512
    Fe = 4 if cfg.kind == "meshgraphnet" else 0
    e = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device=_META)
    i32, b = torch.int32, torch.bool
    return GraphBatch(node_feat=e(N, F), edge_src=e(E, dt=i32), edge_dst=e(E, dt=i32),
                      edge_mask=e(E, dt=b), node_mask=e(N, dt=b), edge_feat=e(E, Fe),
                      labels=e(N, dt=i32), tri_in=e(T, dt=i32), tri_out=e(T, dt=i32),
                      tri_angle=e(T), tri_mask=e(T, dt=b), edge_len=e(E))


def graph_batch(cfg: GNNConfig, spec: ShapeSpec, seed: int,
                device: str | torch.device | None = None) -> GraphBatch:
    """A uniform random graph of ``spec``'s size for ``cfg`` on ``device``
    (default ``cuda``, raising without a GPU): the reference's arrays for
    the same seed (one numpy Generator consumed in the reference's order:
    ``src``, ``dst``, triplets, ``node_feat``, ``edge_feat``, ``labels``,
    ``tri_angle``, ``edge_len``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    N, E, F = _graph_size(cfg, spec)
    Fe = 4 if cfg.kind == "meshgraphnet" else 0
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    if cfg.kind == "dimenet":
        ti, to, tm = make_triplets(src, dst, cfg.triplet_cap_per_edge, rng)
    else:
        ti = to = np.zeros(1, np.int32)
        tm = np.zeros(1, bool)
    node_feat = rng.normal(size=(N, F)).astype(np.float32)
    edge_feat = rng.normal(size=(E, Fe)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, N).astype(np.int32)
    tri_angle = rng.uniform(0, np.pi, ti.shape[0]).astype(np.float32)
    edge_len = rng.uniform(0.5, 4.0, E).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(dev)
    return GraphBatch(
        node_feat=put(node_feat), edge_src=put(src), edge_dst=put(dst),
        edge_mask=torch.ones(E, dtype=torch.bool, device=dev),
        node_mask=torch.ones(N, dtype=torch.bool, device=dev),
        edge_feat=put(edge_feat), labels=put(labels), tri_in=put(ti), tri_out=put(to),
        tri_angle=put(tri_angle), tri_mask=put(tm), edge_len=put(edge_len))


def _gnn_graph_logical() -> GraphBatch:
    return GraphBatch(
        node_feat=("vertex", None),
        edge_src=("edges",),
        edge_dst=("edges",),
        edge_mask=("edges",),
        node_mask=("vertex",),
        edge_feat=("edges", None),
        labels=("vertex",),
        tri_in=("edges",),
        tri_out=("edges",),
        tri_angle=("edges",),
        tri_mask=("edges",),
        edge_len=("edges",),
    )


def _gnn_train_cell(arch, cfg: GNNConfig, spec: ShapeSpec, seed: int, dev) -> Cell:
    g = graph_batch(cfg, spec, seed, dev) if dev.type != "meta" else _graph_batch_meta(cfg, spec)
    F = g.node_feat.shape[1]
    adam = AdamConfig(weight_decay=0.0)
    loss = lambda params, batch: gnn_loss(params, batch, cfg)
    step = make_train_step(loss, adam)
    params = GNN(cfg, F, device=dev, init=dev.type != "meta").params()
    state = init_train_state(params)
    pl = gnn_param_logical(params)
    in_logical = (_state_logical(pl), _gnn_graph_logical())
    E, N = g.edge_src.shape[0], g.node_feat.shape[0]
    mf = _gnn_model_flops(cfg, N, E, F) * 3.0  # fwd + bwd(2x)
    return Cell(arch, spec.name, "gnn", "train_step", step, (state, g), in_logical,
                (_state_logical(pl), None), model_flops=float(mf))


def _gnn_model_flops(cfg: GNNConfig, N: int, E: int, F: int) -> float:
    """Analytic forward FLOPs (matmul-dominated terms; 2 flops/MAC)."""
    H, L, C = cfg.d_hidden, cfg.n_layers, cfg.n_classes
    if cfg.kind == "gcn":
        dims = [F] + [H] * (L - 1) + [C]
        fl = sum(2 * N * a * b + 4 * E * b for a, b in zip(dims[:-1], dims[1:]))
        return float(fl)
    if cfg.kind == "gat":
        hds = cfg.n_heads
        fl = 0
        d_in = F
        for li in range(L):
            d_out = C if li == L - 1 else H
            fl += 2 * N * d_in * hds * d_out  # projection
            fl += 6 * E * hds * d_out  # scores + weighted messages
            d_in = d_out if li == L - 1 else hds * d_out
        return float(fl)
    if cfg.kind == "meshgraphnet":
        n_mlp = cfg.mlp_layers
        enc = 2 * N * (F * H + (n_mlp - 1) * H * H) + 2 * E * (4 * H + (n_mlp - 1) * H * H)
        per_step = 2 * E * (3 * H * H + (n_mlp - 1) * H * H) + 2 * N * (
            2 * H * H + (n_mlp - 1) * H * H
        )
        dec = 2 * N * (H * H * (n_mlp - 1) + H * C)
        return float(enc + L * per_step + dec)
    # dimenet
    T = E * cfg.triplet_cap_per_edge
    B_, ns, nr, nb = L, cfg.n_spherical, cfg.n_radial, cfg.n_bilinear
    per_block = (
        2 * T * (ns * nr) * nb  # sbf basis projection
        + 2 * T * nb * H * H  # bilinear interaction
        + 2 * T * H  # msg gather mult
        + 2 * E * H * H * 3  # msg/out transforms
    )
    embed = 2 * N * F * H + 2 * E * nr * H
    return float(embed + B_ * per_block)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------


def _recsys_batch(cfg: RecsysConfig, B, rng, dev) -> RecsysBatch:
    Fu, Fi, M = cfg.n_user_fields, cfg.n_item_fields, cfg.multi_hot
    ones = lambda F: torch.ones((B, F, M), dtype=torch.float32, device=dev)
    user_idx = _tokens(rng, cfg.user_vocab, (B, Fu, M), dev)
    item_idx = _tokens(rng, cfg.item_vocab, (B, Fi, M), dev)
    return RecsysBatch(user_idx=user_idx, user_wt=ones(Fu), item_idx=item_idx,
                       item_wt=ones(Fi),
                       log_q=torch.zeros((B,), dtype=torch.float32, device=dev))


_RB_LOGICAL = RecsysBatch(
    user_idx=("batch", None, None),
    user_wt=("batch", None, None),
    item_idx=("batch", None, None),
    item_wt=("batch", None, None),
    log_q=("batch",),
)


def _recsys_cell(arch, cfg: RecsysConfig, spec: ShapeSpec, rng, dev) -> Cell:
    pl = recsys_param_logical()
    params = init_two_tower_params(cfg, device=dev, init=dev.type != "meta")
    if spec.kind == "recsys_train":
        adam = AdamConfig(weight_decay=0.0)
        loss = lambda params, batch: two_tower_loss(params, batch, cfg)
        step = make_train_step(loss, adam)
        batch = _recsys_batch(cfg, spec.batch, rng, dev)
        B = spec.batch
        mf = (_recsys_flops(cfg, B) + 2.0 * B * B * cfg.tower_mlp[-1]) * 3
        return Cell(arch, spec.name, "recsys", "train_step", step,
                    (init_train_state(params), batch), (_state_logical(pl), _RB_LOGICAL),
                    (_state_logical(pl), None), model_flops=mf)
    if spec.kind == "recsys_serve":
        fn = functools.partial(score_pairs, cfg=cfg)
        batch = _recsys_batch(cfg, spec.batch, rng, dev)
        return Cell(arch, spec.name, "recsys", "score_pairs", fn, (params, batch),
                    (pl, _RB_LOGICAL), ("batch",), model_flops=_recsys_flops(cfg, spec.batch))
    # retrieval: one query vs n_candidates precomputed item embeddings
    fn = functools.partial(retrieval_scores, cfg=cfg, top_k=100)
    Fu, M, D = cfg.n_user_fields, cfg.multi_hot, cfg.embed_dim
    N = _round_up(spec.n_candidates)
    uidx = _tokens(rng, cfg.user_vocab, (1, Fu, M), dev)
    uwt = torch.ones((1, Fu, M), dtype=torch.float32, device=dev)
    cand = _tensor((N, D), torch.float32, dev,
                   lambda: rng.normal(size=(N, D)).astype(np.float32))
    return Cell(arch, spec.name, "recsys", "retrieval", fn, (params, uidx, uwt, cand),
                (pl, (None, None, None), (None, None, None), ("rows", None)), None,
                model_flops=2.0 * N * D)


def _recsys_flops(cfg: RecsysConfig, B: int) -> float:
    D = cfg.embed_dim
    lookups = (cfg.n_user_fields + cfg.n_item_fields) * cfg.multi_hot * D
    dims_u = [cfg.n_user_fields * D, *cfg.tower_mlp]
    dims_i = [cfg.n_item_fields * D, *cfg.tower_mlp]
    mlp = sum(a * b for a, b in zip(dims_u[:-1], dims_u[1:])) + sum(
        a * b for a, b in zip(dims_i[:-1], dims_i[1:])
    )
    return float(B) * (2.0 * mlp + lookups)


# ---------------------------------------------------------------------------
# spade cells (the paper's own workload)
# ---------------------------------------------------------------------------


def _spade_graph(cfg: SpadeConfig, rng, dev) -> DeviceGraph:
    N, E = _round_up(cfg.n_capacity), _round_up(cfg.e_capacity)
    if dev.type == "meta":
        e = lambda n, dt: torch.empty((n,), dtype=dt, device=_META)
        return DeviceGraph(src=e(E, torch.int32), dst=e(E, torch.int32),
                           c=e(E, torch.float32), edge_mask=e(E, torch.bool),
                           a=e(N, torch.float32), vertex_mask=e(N, torch.bool),
                           n_capacity=N, e_capacity=E)
    m = int(E * 0.9)
    src = rng.integers(0, N, m)
    dst = rng.integers(0, N, m)
    keep = src != dst
    return device_graph_from_coo(N, src[keep], dst[keep], np.ones(keep.sum(), np.float32),
                                 n_capacity=N, e_capacity=E, device=dev)


_DG_LOGICAL = dict(
    src=("edges",), dst=("edges",), c=("edges",), edge_mask=("edges",),
    a=(None,), vertex_mask=(None,),
)


def _spade_cells(arch, cfg: SpadeConfig, spec: ShapeSpec, rng, dev) -> Cell:
    Ncap, Ecap = _round_up(cfg.n_capacity), _round_up(cfg.e_capacity)
    gl = DeviceGraph(n_capacity=Ncap, e_capacity=Ecap, **_DG_LOGICAL)
    # essential per-round work: 2 segment-sum adds + 2 mask mults per edge,
    # plus threshold compare/update over vertices
    mf = float(cfg.max_rounds) * (6.0 * Ecap + 4.0 * Ncap)
    g = _spade_graph(cfg, rng, dev)
    if spec.kind == "spade_static":
        fn = functools.partial(bulk_peel, eps=cfg.eps, max_rounds=cfg.max_rounds)
        return Cell(arch, spec.name, "spade", "bulk_peel", fn, (g,), (gl,), None,
                    model_flops=mf)
    # streaming maintenance cell
    fn = functools.partial(insert_and_maintain, eps=cfg.eps, max_rounds=cfg.max_rounds)
    B = cfg.batch_edges
    if dev.type == "meta":
        e = lambda shape, dt: torch.empty(shape, dtype=dt, device=_META)
        state = DeviceSpadeState(graph=g, level=e((Ncap,), torch.int32),
                                 best_g=e((), torch.float32),
                                 community=e((Ncap,), torch.bool),
                                 edge_count=e((), torch.int32), w0=e((Ncap,), torch.float32))
        bs, bd = e((B,), torch.int32), e((B,), torch.int32)
        bc, valid = e((B,), torch.float32), e((B,), torch.bool)
    else:
        state = init_state(g, eps=cfg.eps)
        bs = _tokens(rng, g.n_capacity, (B,), dev)
        bd = _tokens(rng, g.n_capacity, (B,), dev)
        bc = torch.ones((B,), dtype=torch.float32, device=dev)
        valid = bs != bd
    sl = DeviceSpadeState(graph=gl, level=(None,), best_g=(), community=(None,),
                          edge_count=(), w0=(None,))
    return Cell(arch, spec.name, "spade", "insert_and_maintain", fn,
                (state, bs, bd, bc, valid), (sl, (None,), (None,), (None,), (None,)), sl,
                model_flops=mf)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def build_cell(arch: str, shape: str, *, concrete: bool = False, smoke: bool = False,
               roofline: bool = False, override_layers: int | None = None, seed: int = 0,
               device: str | torch.device | None = None) -> Cell | Skip:
    """Build one cell.  ``smoke=True`` swaps in the reduced config and
    shrinks the shape spec to CPU scale (same code path, tiny sizes).
    ``concrete=False`` builds it on ``meta`` (``device`` is not read);
    ``concrete=True`` on ``device`` (default ``cuda``, raising without a
    GPU).

    ``roofline=True`` builds the analysis variant of the reference: one
    microbatch (identical total FLOPs) and coarse attention blocks (a
    quarter of the sequence; they tile the plain attention that a meta
    trace runs).  The reference also unrolls its scans there; the port
    has none."""
    fam = ARCH_FAMILY[arch]
    spec = arch_shapes(arch)[shape]
    if isinstance(spec, Skip):
        return spec
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if smoke:
        spec = _shrink(spec)
    if roofline and fam == "lm":
        qb = max(spec.seq_len // 4, 128) if spec.seq_len else 512
        cfg = dataclasses.replace(cfg, q_block=qb, kv_block=qb)
    if override_layers is not None and hasattr(cfg, "n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=override_layers)
    dev = resolve_device(device) if concrete else _META
    rng = np.random.default_rng(seed)
    if fam == "lm":
        if spec.kind == "train":
            return _lm_train_cell(arch, cfg, spec, rng, dev, roofline=roofline)
        if spec.kind == "prefill":
            return _lm_prefill_cell(arch, cfg, spec, rng, dev)
        return _lm_decode_cell(arch, cfg, spec, rng, dev)
    if fam == "gnn":
        return _gnn_train_cell(arch, cfg, spec, seed, dev)
    if fam == "recsys":
        return _recsys_cell(arch, cfg, spec, rng, dev)
    if fam == "spade":
        return _spade_cells(arch, cfg, spec, rng, dev)
    raise KeyError(arch)


def _shrink(spec: ShapeSpec) -> ShapeSpec:
    """CPU-scale version of a shape spec (same kind, tiny sizes)."""
    reps = {}
    if spec.seq_len:
        reps["seq_len"] = min(spec.seq_len, 64)
    if spec.global_batch:
        reps["global_batch"] = min(spec.global_batch, 2)
    if spec.n_nodes:
        reps["n_nodes"] = min(spec.n_nodes, 64)
    if spec.n_edges:
        reps["n_edges"] = min(spec.n_edges, 256)
    if spec.batch_nodes:
        reps["batch_nodes"] = min(spec.batch_nodes, 8)
    if spec.fanout:
        reps["fanout"] = tuple(min(f, 3) for f in spec.fanout)
    if spec.n_graphs:
        reps["n_graphs"] = min(spec.n_graphs, 4)
    if spec.d_feat:
        reps["d_feat"] = min(spec.d_feat, 8)
    if spec.batch:
        reps["batch"] = min(spec.batch, 4)
    if spec.n_candidates:
        reps["n_candidates"] = min(spec.n_candidates, 128)
    return dataclasses.replace(spec, **reps)
