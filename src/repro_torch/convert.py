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

Training state: :func:`train_state_to_numpy` gives the port's
:class:`~repro_torch.train.TrainState` as the reference's (``params``,
``m``, ``v``, ``step``, ``err``; an LM's moments and residuals stacked,
unfolded and keyed as its parameters), :func:`train_state_from_numpy`
takes it back, bit for bit; :func:`train_state_to_reference` is the same
map onto torch tensors (bf16 kept), which the checkpoints write.

GNN: :func:`gnn_params_from_numpy` takes the tree of the JAX package's
``init_gnn_params`` (dicts and lists of arrays; MeshGraphNet's ``proc_*``
and DimeNet's ``blocks`` stacked with a leading L dimension) and builds a
:class:`~repro_torch.models.gnn.GNN`; :func:`gnn_params_to_numpy` gives the
same tree back.

Two-tower: :func:`two_tower_params_from_numpy` takes the tree of the JAX
package's ``init_two_tower_params`` (``user_table``, ``item_table``,
``user_mlp``, ``item_mlp``, ``temp``) and gives the port's tree of
tensors, keyed the same; :func:`two_tower_params_to_numpy` gives it back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.core.incremental import DeviceSpadeState
from repro_torch.device import resolve_device
from repro_torch.graphstore.structs import DeviceGraph
from repro_torch.models.gnn import GNN, flatten_params, unflatten_params
from repro_torch.models.transformer import TransformerLM, reference_leaves
from repro_torch.models.two_tower import init_two_tower_params
from repro_torch.train.optimizer import TrainState

__all__ = ["GRAPH_FIELDS", "STATE_FIELDS", "state_from_numpy", "state_to_numpy",
           "lm_params_from_numpy", "lm_params_to_numpy", "lm_params_to_reference",
           "fold_experts", "unfold_experts",
           "gnn_params_from_numpy", "gnn_params_to_numpy", "two_tower_params_from_numpy",
           "two_tower_params_to_numpy", "tensor_from_numpy",
           "train_state_to_reference", "train_state_to_numpy", "train_state_from_numpy"]

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


def tensor_from_numpy(x, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` holding a copy of the array ``x``; a bf16
    tensor takes ``x``'s bits (an ``ml_dtypes`` bfloat16 array or its
    ``uint16`` view)."""
    x = np.array(x, order="C")  # a copy (0-d stays 0-d)
    if dtype == torch.bfloat16:
        if x.dtype.name not in ("bfloat16", "uint16"):
            raise TypeError(f"expected bfloat16 (or its uint16 bits), got {x.dtype}")
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x).to(dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _lm_to_reference(get, cfg: LMConfig, leaf, stack) -> dict:
    """The reference's LM tree from ``get(port name)`` (the leaves of
    :func:`~repro_torch.models.transformer.reference_leaves`): each tensor
    unfolded where it is an expert leaf, then ``leaf``-converted, and a
    layer leaf's ``stack``-ed."""
    vs = cfg.moe.virtual_split if cfg.moe is not None else 1
    tree: dict = {}
    for path, names in reference_leaves(cfg):
        xs = [get(n) for n in names]
        if path[:2] == ("layers", "moe"):
            xs = [unfold_experts(path[-1], x, vs) for x in xs]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = stack([leaf(x) for x in xs]) if path[0] == "layers" else leaf(xs[0])
    return tree


def _lm_from_reference(tree: dict, cfg: LMConfig, put) -> None:
    """``put(port name, reference slice)`` for every port tensor of the
    reference's LM tree; ``put`` converts the slice (``fold`` it after)."""
    for path, names in reference_leaves(cfg):
        x = tree
        for k in path:
            x = x[k]
        for i, n in enumerate(names):
            put(n, x[i] if path[0] == "layers" else x, path[-1] if path[1:2] == ("moe",) else None)


def lm_params_from_numpy(params_np: dict, cfg: LMConfig,
                         device: str | torch.device | None = None) -> TransformerLM:
    """A :class:`TransformerLM` on ``device`` (default ``cuda``, raising
    without a GPU) holding the JAX-layout pytree ``params_np`` bit for bit."""
    model = TransformerLM(cfg, device=device, init=False)
    vs = cfg.moe.virtual_split if cfg.moe is not None else 1

    def put(name, x, expert):
        leaf = model.get_parameter(name)
        w = tensor_from_numpy(x, leaf.dtype)
        leaf.copy_((fold_experts(expert, w, vs) if expert else w).to(leaf.device))

    with torch.no_grad():
        _lm_from_reference(params_np, cfg, put)
    return model


def lm_params_to_reference(model: TransformerLM, device: str | torch.device = "cpu") -> dict:
    """The reference's LM tree of ``model`` as copies on ``device``
    (``"meta"`` gives the structure alone): layers stacked, experts
    unfolded."""
    return _lm_to_reference(model.get_parameter, model.cfg,
                            lambda t: t.detach().to(device, copy=True), torch.stack)


def lm_params_to_numpy(model: TransformerLM) -> dict:
    """The JAX-layout pytree of ``model`` (the inverse of
    :func:`lm_params_from_numpy`); bf16 leaves as ``uint16`` bits."""
    return _lm_to_reference(model.get_parameter, model.cfg, _to_numpy, np.stack)


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
            x = tensor_from_numpy(given.pop(path), leaf.dtype)
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


def two_tower_params_from_numpy(params_np: dict, cfg: RecsysConfig,
                                device: str | torch.device | None = None) -> dict:
    """The port's two-tower tree on ``device`` (default ``cuda``, raising
    without a GPU) holding the reference tree ``params_np`` bit for bit;
    raises unless its leaves and shapes are ``cfg``'s."""
    dev = resolve_device(device)
    like = init_two_tower_params(cfg, device="meta", init=False)
    paths = [p for p, _ in pytree.leaves_with_path(like)]
    given = [p for p, _ in pytree.leaves_with_path(params_np)]
    if given != paths:
        raise KeyError(f"two_tower_params_from_numpy: leaves {given}, expected {paths}")

    def put(x, leaf):
        t = tensor_from_numpy(x, leaf.dtype)
        if t.shape != leaf.shape:
            raise ValueError(f"two_tower_params_from_numpy: a leaf of shape "
                             f"{tuple(t.shape)}, expected {tuple(leaf.shape)}")
        return t.to(dev)

    return pytree.tree_map(put, params_np, like)


def two_tower_params_to_numpy(params: dict) -> dict:
    """The reference tree of the port's two-tower ``params`` (the inverse
    of :func:`two_tower_params_from_numpy`)."""
    return pytree.tree_map(_to_numpy, params)


def train_state_to_reference(state: TrainState, device: str | torch.device = "cpu"
                             ) -> TrainState:
    """``state`` in the reference's layout as copies on ``device``
    (``"meta"`` gives the structure alone): an LM's leaves stacked over the
    layers and unfolded, other trees as they are."""
    leaf = lambda t: t.detach().to(device, copy=True)
    if isinstance(state.params, TransformerLM):
        conv = lambda k, t: _lm_to_reference(
            t.get_parameter if k == "params" else t.__getitem__, state.params.cfg, leaf,
            torch.stack)
    else:
        conv = lambda k, t: pytree.tree_map(leaf, t)
    trees = {"params": state.params, "m": state.m, "v": state.v, "err": state.err}
    return TrainState(step=leaf(state.step),
                      **{k: None if t is None else conv(k, t) for k, t in trees.items()})


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The reference's ``TrainState`` of ``state`` as numpy arrays (bf16
    leaves as ``uint16`` bits, ``step`` a 0-d int32 array)."""
    return pytree.tree_map(_to_numpy, train_state_to_reference(state))


def _np_tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy leaf (bf16 as an ``ml_dtypes`` array) as a tensor on ``device``."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return tensor_from_numpy(x, torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x, order="C")).to(device)


def train_state_from_numpy(state_np, cfg: LMConfig | GNNConfig | RecsysConfig | None = None,
                           device: str | torch.device | None = None) -> TrainState:
    """The port's ``TrainState`` on ``device`` (default ``cuda``, raising
    without a GPU) from the reference's as numpy (any object with
    ``params``, ``m``, ``v``, ``step`` and ``err``): with an LM config, a
    :class:`TransformerLM` and dicts keyed by its parameter names; with a
    GNN config, ``GNN.params()`` and trees like it; with a recsys config,
    the two-tower tree (checked by :func:`two_tower_params_from_numpy`)
    and trees like it; with none, the trees as they are."""
    dev = resolve_device(device)
    if isinstance(cfg, LMConfig):
        params = lm_params_from_numpy(state_np.params, cfg, dev)
        vs = cfg.moe.virtual_split if cfg.moe is not None else 1

        def conv(tree) -> dict:
            out = {}

            def put(name, x, expert):
                w = tensor_from_numpy(x, torch.float32)
                out[name] = (fold_experts(expert, w, vs) if expert else w).to(dev)

            _lm_from_reference(tree, cfg, put)
            return out
    else:
        conv = lambda tree: pytree.tree_map(lambda x: _np_tensor(x, dev), tree)
        if isinstance(cfg, GNNConfig):
            params = gnn_params_from_numpy(state_np.params, cfg, dev).params()
        elif isinstance(cfg, RecsysConfig):
            params = two_tower_params_from_numpy(state_np.params, cfg, dev)
        else:
            params = conv(state_np.params)
    m, v, err = (None if t is None else conv(t) for t in (state_np.m, state_np.v, state_np.err))
    step = torch.from_numpy(np.asarray(state_np.step, np.int32).copy()).to(dev)
    return TrainState(params=params, m=m, v=v, step=step, err=err)
