"""Logical-axis sharding layer on ``torch.distributed``'s ``DeviceMesh``
(port of ``repro/dist/sharding.py``): the dist plane's naming contract.

Model and engine code names a tensor's dims with *logical* axes
("batch", "edges", "model", ...) and stays mesh-agnostic.  An
:class:`AxisEnv` installed with :func:`use_axis_env` maps logical names
onto the mesh dims that exist; outside any env every annotation is a
no-op, so the same code runs from one device to a multi-pod mesh.

Resolution drops mesh dims absent from the mesh (``"batch" -> ("pod",
"data")`` is plain ``"data"`` on a single-pod mesh).  Where JAX takes a
``PartitionSpec`` (one entry a tensor dim), a DTensor takes one
``Placement`` a mesh dim: :meth:`AxisEnv.placements` gives ``Shard(d)``
for the mesh dims that carry tensor dim ``d`` and ``Replicate()`` for the
rest.  A tensor dim split over several mesh dims (``"rows" -> ("data",
"model")``) is split in mesh order, data-major as in JAX, so a rule must
list its mesh dims in the mesh's order.  :func:`constrain` also drops a
constraint whose dim does not divide by its shard count, so smoke-scale
shapes run under a production-shaped mesh.
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager
from typing import Any, Iterator, Mapping, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

__all__ = [
    "DEFAULT_RULES",
    "AxisEnv",
    "use_axis_env",
    "axis_env",
    "constrain",
    "tree_shardings",
    "logical_leaves",
    "local_shape",
]

# logical axis -> mesh dims that may carry it, in order; dims absent from
# the active mesh drop out at resolution time.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),  # pure data parallelism (DCN-friendly)
    "fsdp": ("data",),  # param/optimizer shards within a pod
    "model": ("model",),  # tensor parallelism
    "expert": ("model",),  # expert parallelism rides the model axis
    "seq": ("model",),  # sequence-sharded serving attention
    "vertex": ("model",),  # GNN vertex arrays
    "edges": ("pod", "data"),  # COO edge buffers (spade + GNN)
    "rows": ("data", "model"),  # embedding-table rows
    "data": ("data",),  # escape hatch: name the mesh axis directly
}


@dataclasses.dataclass(frozen=True)
class AxisEnv:
    """A mesh plus the logical -> mesh-dim rule table.

    ``rules`` entries are merged over :data:`DEFAULT_RULES`; map a logical
    name to ``()`` to force replication of that axis.
    """

    mesh: DeviceMesh | None = None
    rules: Mapping[str, Sequence[str]] | None = None

    @property
    def mesh_shape(self) -> dict[str, int]:
        """``{mesh dim name: size}`` in the mesh's order."""
        if self.mesh is None:
            return {}
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    def rule(self, logical: str) -> tuple[str, ...]:
        if self.rules is not None and logical in self.rules:
            return tuple(self.rules[logical])
        try:
            return DEFAULT_RULES[logical]
        except KeyError:
            raise KeyError(
                f"unknown logical axis {logical!r}; known: "
                f"{sorted(set(DEFAULT_RULES) | set(self.rules or ()))}"
            ) from None

    def resolve(self, logical: str | None) -> str | tuple[str, ...] | None:
        """Mesh dims carrying ``logical`` on this mesh (None if none do)."""
        if logical is None or self.mesh is None:
            return None
        axes = tuple(a for a in self.rule(logical) if a in self.mesh_shape)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes

    def _axes(self, logical: str | None) -> tuple[str, ...]:
        ax = self.resolve(logical)
        return () if ax is None else (ax,) if isinstance(ax, str) else ax

    def axis_size(self, logical: str | None) -> int:
        """Total number of shards ``logical`` resolves to (1 if replicated)."""
        return math.prod(self.mesh_shape[a] for a in self._axes(logical))

    def placements(self, *logical: str | None, shape: Sequence[int] | None = None
                   ) -> tuple[Placement, ...]:
        """One placement a mesh dim for a tensor whose dims are named
        ``logical`` (``()`` for a scalar: replicated).  With ``shape``, a
        dim that does not divide by its shard count is replicated
        (:func:`constrain`'s rule)."""
        if self.mesh is None:
            raise ValueError("AxisEnv has no mesh; cannot place a tensor")
        names = list(self.mesh_shape)
        out: list[Placement] = [Replicate() for _ in names]
        for d, name in enumerate(logical):
            axes = self._axes(name)
            if shape is not None and shape[d] % self.axis_size(name):
                continue
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"logical axis {name!r} resolves to {axes}, not in the "
                                 f"mesh's order {tuple(names)}")
            for i in order:
                if isinstance(out[i], Shard):
                    raise ValueError(f"mesh dim {names[i]!r} carries two tensor dims "
                                     f"({out[i].dim} and {d}) of {logical}")
                out[i] = Shard(d)
        return tuple(out)


def local_shape(shape: Sequence[int], placements: Sequence[Placement],
                mesh_sizes: Sequence[int]) -> tuple[int, ...]:
    """The largest shard of a ``shape`` tensor under ``placements`` (a mesh
    dim at a time, in mesh order, rank 0's chunk: ``ceil``); every shard's
    when the dims divide, as JAX requires of an argument's sharding."""
    out = list(shape)
    for p, n in zip(placements, mesh_sizes):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // n)
    return tuple(out)


_STACK: list[AxisEnv] = []


def axis_env() -> AxisEnv | None:
    """The innermost active AxisEnv, or None outside any ``use_axis_env``."""
    return _STACK[-1] if _STACK else None


@contextmanager
def use_axis_env(env: AxisEnv) -> Iterator[AxisEnv]:
    _STACK.append(env)
    try:
        yield env
    finally:
        _STACK.pop()


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Annotate ``x`` with logical axes (one per dim, None = unconstrained).

    Under an active env a DTensor is redistributed to the placements the
    names resolve to; a plain tensor (one device's data) passes through,
    as does everything outside an env.  Dims that do not divide by their
    shard count keep their data but lose the constraint (replicated).
    """
    env = axis_env()
    if env is None or env.mesh is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(
            f"constrain got {len(logical)} logical axes for rank-{x.dim()} tensor"
        )
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(env.mesh, env.placements(*logical, shape=tuple(x.shape)))


def _is_logical_leaf(node: Any) -> bool:
    """A tuple of logical names / Nones (possibly empty -> scalar), not a
    NamedTuple."""
    return (type(node) is tuple
            and all(isinstance(e, (str, type(None))) for e in node))


def _children(node) -> list[tuple[Any, Any]] | None:
    """``[(key, child), ...]`` of a container node (dict keys, NamedTuple
    and dataclass field names, sequence indices), None for anything
    else."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node._asdict().items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _rebuild(node, items: dict):
    if isinstance(node, dict):
        return {k: items[k] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(**items)
    if isinstance(node, (list, tuple)):
        return type(node)(items[i] for i in range(len(node)))
    return dataclasses.replace(node, **items)


def tree_shardings(logical_tree: Any, env: AxisEnv | None = None) -> Any:
    """Map a tree of logical-axis tuples to the matching tree of placement
    tuples (one placement a mesh dim).  Leaves are tuples like
    ``("batch", None)`` (``()`` for scalars); anything that is not a
    container or such a tuple (a capacity, None) is kept as it is."""
    env = env if env is not None else axis_env()
    if env is None or env.mesh is None:
        raise ValueError("tree_shardings requires an active AxisEnv with a mesh "
                         "(wrap the call in use_axis_env)")

    def go(node):
        if _is_logical_leaf(node):
            return env.placements(*node)
        kids = _children(node)
        if kids is None:
            return node
        return _rebuild(node, {k: go(c) for k, c in kids})

    return go(logical_tree)


def logical_leaves(values: Any, logical_tree: Any, path: tuple = ()
                   ) -> list[tuple[tuple, Any, tuple]]:
    """``(path, value, logical names)`` of every logical leaf of
    ``logical_tree``, paired with the value at the same place in ``values``
    (a tree of the same containers: dicts by key, sequences by position,
    NamedTuples and dataclasses by field).  A path holds those keys."""
    if _is_logical_leaf(logical_tree):
        return [(path, values, logical_tree)]
    kids = _children(logical_tree)
    if kids is None:
        return []
    vals = dict(_children(values) or ())
    out = []
    for k, c in kids:
        if k not in vals:
            raise KeyError(f"logical_leaves: {path + (k,)} has no value")
        out += logical_leaves(vals[k], c, path + (k,))
    return out
