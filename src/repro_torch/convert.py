"""State carried across frameworks as numpy arrays.

Spade: the dict holds the fields of ``DeviceSpadeState`` — ``level``, ``best_g``,
``community``, ``edge_count``, ``w0`` — and of its ``DeviceGraph`` —
``src``, ``dst``, ``c``, ``edge_mask``, ``a``, ``vertex_mask`` — each as
``np.asarray`` of the leaf, plus the two capacities ``n_capacity`` and
``e_capacity``.  Built from the JAX package's state, it lets a test start
both engines from one state and compare them after any tick.

LM: :func:`lm_params_from_numpy` takes the pytree of the JAX package's
``init_lm_params`` (``{"embed", "layers": {..., "mlp": {...}} or {...,
"moe": {...}}, "final_norm", "head"}``, per-layer leaves stacked ``[L,
...]``, ``x @ w`` layout) as numpy arrays and builds a
:class:`~repro_torch.models.TransformerLM`; :func:`lm_params_to_numpy`
gives the same pytree back.  A MoE layer's ``moe`` leaves are ``router
[D, E]`` (float32) and ``E * vs`` virtual experts ``w_gate``/``w_up [E *
vs, D, F / vs]``, ``w_down [E * vs, F / vs, D]`` (``vs`` the config's
``virtual_split``; virtual expert ``e * vs + v`` is expert e's v-th slice
of F); the port holds each expert whole, ``[E, D, F]`` and ``[E, F, D]``,
so the leaves are folded on the way in and unfolded on the way out (pure
reshapes: the round trip gives the same bits; in bf16 the folded expert
rounds its product once, where the reference rounds each virtual
expert's partial and then their sum).  bfloat16 leaves
cross as bits: ``np.asarray`` of a JAX bf16 array has the ``ml_dtypes``
``bfloat16`` dtype, which ``torch.from_numpy`` refuses, so it is viewed as
``uint16`` and the tensor as ``torch.bfloat16``; going back, a bf16 leaf
comes out as a ``uint16`` array of its bits.

GNN: :func:`gnn_params_from_numpy` takes the tree of the JAX package's
``init_gnn_params`` (dicts and lists of arrays; MeshGraphNet's ``proc_*``
and DimeNet's ``blocks`` stacked with a leading L dimension) and builds a
:class:`~repro_torch.models.gnn.GNN`; :func:`gnn_params_to_numpy` gives the
same tree back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, LMConfig
from repro_torch.core.incremental import DeviceSpadeState
from repro_torch.device import resolve_device
from repro_torch.graphstore.structs import DeviceGraph
from repro_torch.models.gnn import GNN, flatten_params, unflatten_params
from repro_torch.models.transformer import TransformerLM

__all__ = ["GRAPH_FIELDS", "STATE_FIELDS", "state_from_numpy", "state_to_numpy",
           "lm_params_from_numpy", "lm_params_to_numpy", "fold_experts", "unfold_experts",
           "gnn_params_from_numpy",
           "gnn_params_to_numpy"]

GRAPH_FIELDS = {"src": np.int32, "dst": np.int32, "c": np.float32,
                "edge_mask": np.bool_, "a": np.float32, "vertex_mask": np.bool_}
STATE_FIELDS = {"level": np.int32, "best_g": np.float32,
                "community": np.bool_, "edge_count": np.int32,
                "w0": np.float32}


def state_from_numpy(d: dict, device: str | torch.device | None = None
                     ) -> DeviceSpadeState:
    """Build the port's state (and graph) on ``device`` (default ``cuda``,
    raising without a GPU) from the numpy dict described above."""
    dev = resolve_device(device)

    def put(name, dtype):
        x = np.ascontiguousarray(np.asarray(d[name], dtype=dtype))
        return torch.from_numpy(x.copy()).to(dev)

    g = DeviceGraph(**{f: put(f, t) for f, t in GRAPH_FIELDS.items()},
                    n_capacity=int(d["n_capacity"]),
                    e_capacity=int(d["e_capacity"]))
    return DeviceSpadeState(graph=g, **{f: put(f, t) for f, t in STATE_FIELDS.items()})


def state_to_numpy(state: DeviceSpadeState) -> dict:
    """The numpy dict of ``state`` (the inverse of :func:`state_from_numpy`)."""
    g = state.graph
    out = {f: getattr(g, f).cpu().numpy() for f in GRAPH_FIELDS}
    out.update({f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS})
    out["n_capacity"] = g.n_capacity
    out["e_capacity"] = g.e_capacity
    return out


_LAYER_LEAVES = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "q_norm", "k_norm")
_MLP_LEAVES = ("w_gate", "w_up", "w_down")
_MOE_LEAVES = ("router",) + _MLP_LEAVES


def fold_experts(name: str, w: torch.Tensor, vs: int) -> torch.Tensor:
    """One layer's ``moe`` leaf as the port holds it: virtual experts
    ``[E * vs, ...]`` joined into whole experts (the router as it is)."""
    if name in ("w_gate", "w_up"):  # [Ev, D, Fv] -> [E, D, vs * Fv]
        Ev, D, Fv = w.shape
        return w.reshape(Ev // vs, vs, D, Fv).permute(0, 2, 1, 3).reshape(Ev // vs, D, vs * Fv)
    if name == "w_down":  # [Ev, Fv, D] -> [E, vs * Fv, D]
        Ev, Fv, D = w.shape
        return w.reshape(Ev // vs, vs * Fv, D)
    return w


def unfold_experts(name: str, w: torch.Tensor, vs: int) -> torch.Tensor:
    """The inverse of :func:`fold_experts`."""
    if name in ("w_gate", "w_up"):  # [E, D, F] -> [E * vs, D, F / vs]
        E, D, F = w.shape
        return w.reshape(E, D, vs, F // vs).permute(0, 2, 1, 3).reshape(E * vs, D, F // vs)
    if name == "w_down":  # [E, F, D] -> [E * vs, F / vs, D]
        E, F, D = w.shape
        return w.reshape(E * vs, F // vs, D)
    return w


def _to_tensor(x, dtype: torch.dtype) -> torch.Tensor:
    x = np.ascontiguousarray(np.asarray(x))
    if dtype == torch.bfloat16:
        if x.dtype.name not in ("bfloat16", "uint16"):
            raise TypeError(f"expected bfloat16 (or its uint16 bits), got {x.dtype}")
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy()).to(dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def lm_params_from_numpy(params_np: dict, cfg: LMConfig,
                         device: str | torch.device | None = None) -> TransformerLM:
    """A :class:`TransformerLM` on ``device`` (default ``cuda``, raising
    without a GPU) holding the JAX-layout pytree ``params_np`` bit for bit."""
    model = TransformerLM(cfg, device=device, init=False)
    dev, dtype = model.device, model.embed.dtype
    put = lambda x: _to_tensor(x, dtype).to(dev)
    with torch.no_grad():
        for name in ("embed", "final_norm", "head"):
            getattr(model, name).copy_(put(params_np[name]))
        layers = params_np["layers"]
        for li, lp in enumerate(model.layers):
            for name in _LAYER_LEAVES:
                if hasattr(lp, name):
                    getattr(lp, name).copy_(put(layers[name][li]))
            if cfg.moe is None:
                for name in _MLP_LEAVES:
                    getattr(lp, name).copy_(put(layers["mlp"][name][li]))
                continue
            for name in _MOE_LEAVES:
                leaf = getattr(lp, name)
                w = _to_tensor(layers["moe"][name][li], leaf.dtype)
                leaf.copy_(fold_experts(name, w, cfg.moe.virtual_split).to(dev))
    return model


def lm_params_to_numpy(model: TransformerLM) -> dict:
    """The JAX-layout pytree of ``model`` (the inverse of
    :func:`lm_params_from_numpy`); bf16 leaves as ``uint16`` bits."""
    moe = model.cfg.moe
    stack = lambda name: np.stack([_to_numpy(getattr(lp, name)) for lp in model.layers])
    layers = {name: stack(name) for name in _LAYER_LEAVES if hasattr(model.layers[0], name)}
    if moe is None:
        layers["mlp"] = {name: stack(name) for name in _MLP_LEAVES}
    else:
        layers["moe"] = {name: np.stack([_to_numpy(unfold_experts(
            name, getattr(lp, name), moe.virtual_split)) for lp in model.layers])
            for name in _MOE_LEAVES}
    return {"embed": _to_numpy(model.embed), "layers": layers,
            "final_norm": _to_numpy(model.final_norm), "head": _to_numpy(model.head)}


def _gnn_input_dims(params_np: dict, cfg: GNNConfig) -> tuple[int, int]:
    """(d_feat, d_edge_feat) of a reference GNN tree."""
    if cfg.kind == "gcn":
        return np.shape(params_np["w"][0])[0], 4
    if cfg.kind == "gat":
        return np.shape(params_np["layers"][0]["w"])[0], 4
    if cfg.kind == "meshgraphnet":
        return (np.shape(params_np["enc_node"]["w0"])[0],
                np.shape(params_np["enc_edge"]["w0"])[0])
    if cfg.kind == "dimenet":
        return np.shape(params_np["embed_node"])[0], 4
    raise ValueError(cfg.kind)


def gnn_params_from_numpy(params_np: dict, cfg: GNNConfig,
                          device: str | torch.device | None = None) -> GNN:
    """A :class:`GNN` on ``device`` (default ``cuda``, raising without a
    GPU) holding the reference tree ``params_np`` bit for bit."""
    model = GNN(cfg, *_gnn_input_dims(params_np, cfg), device=device, init=False)
    given = dict(flatten_params(params_np))
    with torch.no_grad():
        for path, leaf in flatten_params(model.params()):
            if path not in given:
                raise KeyError(f"gnn_params_from_numpy: {path} missing")
            x = _to_tensor(given.pop(path), leaf.dtype)
            if x.shape != leaf.shape:
                raise ValueError(f"gnn_params_from_numpy: {path} has shape "
                                 f"{tuple(x.shape)}, expected {tuple(leaf.shape)}")
            leaf.copy_(x)
    if given:
        raise KeyError(f"gnn_params_from_numpy: unexpected leaves {sorted(given)}")
    return model


def gnn_params_to_numpy(model: GNN) -> dict:
    """The reference tree of ``model`` (the inverse of
    :func:`gnn_params_from_numpy`)."""
    return unflatten_params((p, _to_numpy(t)) for p, t in flatten_params(model.params()))
