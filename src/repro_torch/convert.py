"""State carried across frameworks as a dict of numpy arrays.

The dict holds the fields of ``DeviceSpadeState`` — ``level``, ``best_g``,
``community``, ``edge_count``, ``w0`` — and of its ``DeviceGraph`` —
``src``, ``dst``, ``c``, ``edge_mask``, ``a``, ``vertex_mask`` — each as
``np.asarray`` of the leaf, plus the two capacities ``n_capacity`` and
``e_capacity``.  Built from the JAX package's state, it lets a test start
both engines from one state and compare them after any tick.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.incremental import DeviceSpadeState
from repro_torch.device import resolve_device
from repro_torch.graphstore.structs import DeviceGraph

__all__ = ["GRAPH_FIELDS", "STATE_FIELDS", "state_from_numpy", "state_to_numpy"]

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
