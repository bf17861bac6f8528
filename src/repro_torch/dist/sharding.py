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

Where GSPMD partitions a jitted program, the port runs it eagerly on
DTensors: :func:`place` and :func:`shard_tree` put arguments on the mesh,
:func:`constrain` redistributes at the reference's points, and the
models add one where DTensor does not infer a layout (the row-parallel
products' partial sums).  Each redistribution is a named call, and
:class:`LocalCost` counts what one rank runs: the FLOPs of its local ops
and the bytes of every collective, under the reference's five names.  An
op without a DTensor sharding rule raises; nothing here gathers quietly.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from contextlib import contextmanager, nullcontext
from typing import Any, Iterator, Mapping, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "DEFAULT_RULES",
    "MODEL_AXIS",
    "AxisEnv",
    "use_axis_env",
    "axis_env",
    "constrain",
    "tree_shardings",
    "logical_leaves",
    "local_shape",
    "place",
    "shard_tree",
    "shard_span",
    "replicate_as",
    "redistribute",
    "unshard",
    "all_reduce",
    "settle",
    "zeros",
    "local",
    "split_dims",
    "local_slices",
    "mesh_group",
    "barrier",
    "GlooGathers",
    "COLLECTIVES",
    "LocalCost",
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

MODEL_AXIS = 16  # 'model' mesh dim size in the production meshes


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
        (:func:`constrain`'s rule).  A mesh dim of one rank is
        ``Replicate()`` whatever it carries: its one shard is the whole
        tensor, and a DTensor reshapes a replicated dim freely."""
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
                if self.mesh.size(i) == 1:
                    continue  # one rank holds it all: whole, as DTensor keeps it
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
    """``env`` active inside; on a mesh of CUDA ranks with a gloo group,
    :class:`GlooGathers` too."""
    _STACK.append(env)
    try:
        with GlooGathers() if env is not None and _gloo_cuda_mesh(env.mesh) else nullcontext():
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
    return redistribute(x, env.placements(*logical, shape=tuple(x.shape)))


def _gloo_on_cuda(x: DTensor, mesh_dim: int) -> bool:
    import torch.distributed as dist

    return (x.device_mesh.device_type == "cuda"
            and dist.get_backend(x.device_mesh.get_group(mesh_dim)) == "gloo")


class _GatherByAllToAll(torch.autograd.Function):
    """The all-to-all gather of :func:`_gather_by_all_to_all` with a
    gradient: the gathered tensor's gradient (a partial sum over the mesh
    dim, or whole on every rank) put back into ``x``'s placements by
    :func:`redistribute`, a reduce-scatter of the same bytes or a local
    slice."""

    @staticmethod
    def forward(ctx, x, mesh_dim):
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor.experimental import local_map

        ctx.placements = tuple(x.placements)
        mesh = x.device_mesh
        d = x.placements[mesh_dim].dim
        k = mesh.size(mesh_dim)
        if x.shape[d] % k:
            raise ValueError(f"gather: dim {d} of {tuple(x.shape)} does not divide by {k}")
        out_pl = list(x.placements)
        out_pl[mesh_dim] = Replicate()

        def local(xl):
            src = torch.cat([xl.movedim(d, 0)] * k).contiguous()
            got = funcol.all_to_all_single(src, None, None, (mesh, mesh_dim))
            # contiguous, as DTensor's all-gather leaves it (K3 reads a unit last stride)
            return funcol.wait_tensor(got).movedim(0, d).contiguous()

        return local_map(local, out_placements=out_pl, in_placements=(x.placements,),
                         device_mesh=mesh)(x)

    @staticmethod
    def backward(ctx, grad):
        return redistribute(grad, ctx.placements), None


def _gather_by_all_to_all(x: DTensor, mesh_dim: int) -> DTensor:
    """``x`` made whole along the tensor dim that mesh dim ``mesh_dim``
    shards, by one ``all_to_all_single`` whose every chunk is this rank's
    shard: each rank sends its shard to every rank, as an all-gather does,
    and the same bytes arrive.  Differentiable: the backward is the
    reduce-scatter (or, from a whole gradient, the local slice) that
    DTensor's all-gather has."""
    return _GatherByAllToAll.apply(x, mesh_dim)


def _gloo_cuda_mesh(mesh: DeviceMesh | None) -> bool:
    """Whether ``mesh`` holds CUDA ranks and one of its dims' groups is gloo."""
    import torch.distributed as dist

    return (mesh is not None and mesh.device_type == "cuda"
            and any(dist.get_backend(mesh.get_group(i)) == "gloo" for i in range(mesh.ndim)))


def _gloo_group(group) -> bool:
    """Whether a functional collective's group (its name, or the group) is gloo."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_backend(_resolve_process_group(group) if isinstance(group, str)
                            else group) == "gloo"


def _gloo_gather(func, args, cpu: bool = False) -> bool:
    """Whether ``func(*args)`` is a functional all-gather of a CUDA tensor
    (or, with ``cpu``, any tensor) on a gloo group: what
    :class:`GlooGathers` runs as an all-to-all."""
    return (func is torch.ops._c10d_functional.all_gather_into_tensor.default
            and (args[0].is_cuda or cpu) and _gloo_group(args[2]))


class GlooGathers(TorchDispatchMode):
    """Inside, every functional all-gather on a gloo group of CUDA tensors
    runs as the all-to-all that moves the same bytes (each rank sends its
    shard to every rank: gloo's CUDA all-gather faults in torch 2.11).  It
    takes DTensor's own gathers, which :func:`redistribute` does not make
    itself: the layout an op's sharding rule asks for, and the gather in
    the backward of a constraint that sliced a whole tensor (the MoE
    buffer's).  :func:`use_axis_env` enters it on a mesh of CUDA ranks
    with a gloo group; ``cpu=True`` takes CPU tensors too (a test of the
    rewrite on gloo's CPU group)."""

    def __init__(self, cpu: bool = False):
        super().__init__()
        self.cpu = cpu

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if _gloo_gather(func, args, self.cpu):
            x, k, group = args[0].contiguous(), args[1], args[2]
            split = [x.shape[0]] * k
            return torch.ops._c10d_functional.all_to_all_single.default(
                torch.cat([x] * k), split, split, group)
        return func(*args, **kwargs)


def all_reduce(t: torch.Tensor, op: str, groups: Sequence[tuple[DeviceMesh, int]]
               ) -> torch.Tensor:
    """A plain (rank-local) tensor all-reduced with ``op`` ("sum", "max")
    over each ``(mesh, mesh dim)`` group in turn, for the explicit
    collectives inside a ``local_map``; no group: ``t`` itself.  It has no
    backward: a tensor that autograd would differentiate through it
    raises (detach it, or reduce inside an ``autograd.Function``'s forward
    that states its own backward)."""
    import torch.distributed._functional_collectives as funcol

    if groups and t.requires_grad and torch.is_grad_enabled():
        raise ValueError("sharding.all_reduce has no backward: detach its input or call it "
                         "from an autograd.Function's forward")
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
    return t


class _AddPartials(torch.autograd.Function):
    """``x``'s partial sums over the mesh dims ``dims`` added by one
    all-reduce over their flattened group (:func:`mesh_group`), those dims
    then whole.  Backward: the gradient as it comes, whole on those dims,
    as DTensor's all-reduce keeps it."""

    @staticmethod
    def forward(ctx, x, dims):
        import torch.distributed._functional_collectives as funcol

        mesh = x.device_mesh
        t = funcol.wait_tensor(funcol.all_reduce(x.to_local(), "sum", mesh_group(mesh, dims)))
        pl = [Replicate() if i in dims else p for i, p in enumerate(x.placements)]
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=x.shape,
                                  stride=x.stride())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def redistribute(x: DTensor, placements: Sequence[Placement]) -> DTensor:
    """``x.redistribute(x.device_mesh, placements)``: the port's one way to
    move a DTensor between layouts, so that every change is named.  Two
    exceptions to DTensor's own collectives: gloo has no all-gather on CUDA
    tensors (torch 2.11 faults in it), so on a gloo group of CUDA ranks a
    mesh dim that goes from a shard to whole is gathered by an all-to-all
    that moves the same bytes (and is counted as one; DTensor's own
    gathers there, which no call here names, go through
    :class:`GlooGathers`); and partial sums over more than one mesh dim
    made whole (a replicated weight's gradient on (data, model)) are added
    by one all-reduce over their flattened group, where DTensor takes one
    a dim until such a group exists and one after.  A DTensor's
    redistribute is differentiable: its backward moves the gradient back
    into ``x``'s placements (an all-gather's is a reduce-scatter; an
    all-reduce's keeps the whole gradient)."""
    placements = tuple(placements)
    summed = tuple(i for i, (a, b) in enumerate(zip(x.placements, placements))
                   if a == Partial() and isinstance(b, Replicate))
    if len(summed) > 1:
        x = _AddPartials.apply(x, summed)
    for i in reversed(range(len(placements))):
        a, b = x.placements[i], placements[i]
        if isinstance(a, Shard) and isinstance(b, Replicate) and _gloo_on_cuda(x, i):
            x = _gather_by_all_to_all(x, i)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def unshard(x: torch.Tensor, logical: str) -> torch.Tensor:
    """``x`` made whole along the mesh dims that ``logical`` resolves to
    on the active env (FSDP's gather of a weight over ``"fsdp"``), its
    other placements kept: one named :func:`redistribute` (an all-gather,
    whose backward reduce-scatters the gradient into ``x``'s placements).
    A plain tensor, a DTensor no such dim shards, or no env: ``x``."""
    env = axis_env()
    if not isinstance(x, DTensor) or env is None or env.mesh is None:
        return x
    names = list(env.mesh_shape)
    axes = {names.index(a) for a in env._axes(logical)}
    pl = [Replicate() if i in axes and isinstance(p, Shard) else p
          for i, p in enumerate(x.placements)]
    return redistribute(x, pl)


def _env() -> AxisEnv:
    env = axis_env()
    if env is None or env.mesh is None:
        raise ValueError("no active AxisEnv with a mesh (wrap the call in use_axis_env)")
    return env


def place(x: torch.Tensor, *logical: str | None, local: bool = False,
          shape: Sequence[int] | None = None) -> DTensor:
    """``x`` as a DTensor on the active env's mesh, its dims named
    ``logical``.  By default ``x`` is the whole tensor, which every rank
    holds, and each rank keeps its shard (``distribute_tensor`` with no
    source rank: a local slice, no collective, copied where it would keep
    the whole tensor's storage alive; on ``meta`` too); with
    ``local=True`` ``x`` is this rank's shard of a tensor of global
    ``shape`` (``DTensor.from_local``).  A dim that does not divide by its
    shard count is replicated (:func:`constrain`'s rule)."""
    env = _env()
    if not local:
        pl = env.placements(*logical, shape=tuple(x.shape))
        d = distribute_tensor(x.detach(), env.mesh, pl, src_data_rank=None)
        loc = d.to_local()
        if loc.is_meta or loc.untyped_storage().nbytes() <= loc.numel() * loc.element_size():
            return d
        # a shard that views the whole tensor would keep the whole alive
        return DTensor.from_local(loc.clone(), env.mesh, pl, run_check=False, shape=d.shape,
                                  stride=d.stride())
    if shape is None:
        raise ValueError("place(local=True) needs the global shape")
    shape = tuple(int(n) for n in shape)
    pl = env.placements(*logical, shape=shape)
    return DTensor.from_local(x, env.mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def shard_tree(values: Any, logical_tree: Any) -> Any:
    """``values`` with every tensor at a logical leaf of ``logical_tree``
    placed by :func:`place` (the containers, and whatever is not a tensor
    at a leaf or has no leaf, kept as they are): ``logical_leaves``'
    pairing, rebuilt.  A DTensor is kept as it is (placed already)."""
    if _is_logical_leaf(logical_tree):
        if isinstance(values, DTensor) or not isinstance(values, torch.Tensor):
            return values
        return place(values, *logical_tree)
    kids = _children(logical_tree)
    vals = _children(values)
    if kids is None or vals is None:
        return values
    logical = dict(kids)
    return _rebuild(values, {k: shard_tree(v, logical[k]) if k in logical else v
                             for k, v in vals})


def shard_span(x: torch.Tensor, dim: int) -> tuple[int, int]:
    """``(first index, length)`` of this rank's part of ``x``'s dim ``dim``:
    ``(0, size)`` for a plain tensor or an unsharded dim.  DTensor splits a
    dim mesh dim by mesh dim, in mesh order, into ``torch.chunk``'s
    pieces (``ceil(n / k)`` long, the last ones shorter or empty)."""
    if not isinstance(x, DTensor):
        return 0, x.shape[dim]
    return _span(x.shape[dim], dim % x.dim(), x.placements, x.device_mesh)


def _span(n: int, dim: int, placements: Sequence[Placement], mesh: DeviceMesh
          ) -> tuple[int, int]:
    start, size = 0, n
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            c = -(-size // mesh.size(i))
            lo = min(c * coord[i], size)
            start, size = start + lo, min(c, size - lo)
    return start, size


def replicate_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a plain tensor every rank holds whole (a RoPE table, an
    index range), as a replicated DTensor on ``like``'s mesh when ``like``
    is a DTensor; ``t`` itself otherwise.  No collective."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial sums (a row-parallel product's, a reduction over
    a sharded dim) all-reduced: each ``Partial`` placement redistributed
    to ``Replicate``, the rest kept.  Anything else passes through."""
    if not isinstance(x, DTensor) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return redistribute(x, pl)


def zeros(shape: Sequence[int], *logical: str | None, dtype: torch.dtype,
          device: torch.device | str) -> DTensor:
    """A DTensor of zeros of global ``shape`` on the active env's mesh,
    placed by ``logical`` (:func:`constrain`'s rule), each rank allocating
    only its shard on ``device`` (``meta`` in the dry run)."""
    env = _env()
    shape = tuple(int(n) for n in shape)
    pl = env.placements(*logical, shape=shape)
    local = [_span(n, d, pl, env.mesh)[1] for d, n in enumerate(shape)]
    return place(torch.zeros(local, dtype=dtype, device=device), *logical, local=True,
                 shape=shape)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (the same storage), or ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def split_dims(t: torch.Tensor) -> tuple[int, ...]:
    """The mesh dims that shard a DTensor (none for a plain tensor)."""
    if not isinstance(t, DTensor):
        return ()
    return tuple(i for i, p in enumerate(t.placements) if isinstance(p, Shard))


def local_slices(shape: Sequence[int], *logical: str | None) -> tuple[slice, ...]:
    """This rank's part of a tensor of global ``shape`` placed by
    ``logical`` on the active env's mesh (:func:`constrain`'s rule), one
    slice a dim: what :func:`place` keeps of the whole tensor, for a
    reader that loads only that part."""
    env = _env()
    shape = tuple(int(n) for n in shape)
    pl = env.placements(*logical, shape=shape)
    return tuple(slice(a, a + n) for a, n in (_span(s, d, pl, env.mesh)
                                               for d, s in enumerate(shape)))


def mesh_group(mesh: DeviceMesh, dims: Sequence[int]):
    """The ranks of ``mesh`` along ``dims`` as one group for a functional
    collective: ``(mesh, dim)`` for one dim, the dims' flattened mesh
    (which ``DeviceMesh`` caches by name) for several."""
    dims = sorted(dims)
    if len(dims) == 1:
        return (mesh, dims[0])
    return mesh[tuple(mesh.mesh_dim_names[i] for i in dims)]._flatten()


def barrier(mesh: DeviceMesh) -> None:
    """Wait until every rank of ``mesh`` arrives: one all-reduce of a
    one-element tensor over them all."""
    import torch.distributed._functional_collectives as funcol

    dev = "cpu" if mesh.device_type == "cpu" else torch.device(
        mesh.device_type, torch.cuda.current_device())
    funcol.wait_tensor(funcol.all_reduce(torch.zeros(1, device=dev), "sum",
                                         mesh_group(mesh, range(mesh.ndim))))


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


# ---------------------------------------------------------------------------
# what one rank runs: local FLOPs and collective bytes
# ---------------------------------------------------------------------------

#: the reference's names of the collectives (``repro.launch.dryrun``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_KIND = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the call stack: it
    evaluates ops on global shapes (on fake tensors, or on meta tensors
    through its decompositions) to find the output's layout."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_globals.get("__name__", "").startswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


_PROPAGATION = ("torch.distributed.tensor._sharding_prop",
                "torch.distributed.tensor._decompositions")


def _matmul_flops(a, b, *_, out_val=None, **__) -> int:
    return 2 * out_val.numel() * a.shape[-1]


def _einsum_flops(equation, operands, *_, out_val=None, **__) -> int:
    """Two operands: 2 x the product of every index's size (a multiply
    and an add per term of the contraction); else 0."""
    if len(operands) != 2:
        return 0
    sizes = {}
    for spec, t in zip(equation.split("->")[0].split(","), operands):
        sizes.update(zip(spec.strip(), t.shape))
    return 2 * math.prod(sizes.values())


def _flop_formula(func):
    """``torch.utils.flop_counter``'s formula for ``func``, or this
    module's for the composite ops that inference mode hands a mode
    whole (``matmul``, ``einsum``)."""
    from torch.utils.flop_counter import flop_registry

    packet = func._overloadpacket
    if packet in flop_registry:
        return flop_registry[packet]
    return {torch.ops.aten.matmul: _matmul_flops,
            torch.ops.aten.einsum: _einsum_flops}.get(packet)


class _Collectives(TorchDispatchMode):
    """Adds the collectives DTensor issues inside one op to ``cost``."""

    def __init__(self, cost: LocalCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.cost._collective(func, args, out)
        return out


class LocalCost(TorchDispatchMode):
    """What this rank runs inside the ``with`` block: ``flops``, the FLOPs
    of its local ops (``torch.utils.flop_counter``'s formulas, and this
    module's for ``matmul`` and ``einsum``), and
    ``collectives``, the bytes of every collective's output on this rank by
    kind, as the reference counts the per-shard output shapes of its
    partitioned HLO (a gather on a gloo group of CUDA tensors as the
    all-to-all that :class:`GlooGathers` runs); ``calls`` counts them.

    A DTensor op is handed on to DTensor (the mode returns
    ``NotImplemented``), which redistributes and runs the local op; its
    collectives come back here on plain tensors.  A DTensor op with a
    FLOP formula is run here instead, and counted as its global FLOPs over
    the ranks that split it: the mesh dims on which its output is a shard
    or a partial sum (each of those ranks does that share; on the others
    the work is repeated).  That is the local op's count on even shards,
    and it does not depend on whether the local op reaches a Python mode
    (in torch 2.13 DTensor runs it from C++).  Plain ops (the bodies of
    ``local_map``) are counted as they run, except those DTensor's
    sharding propagation evaluates on global shapes to find a layout."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives = {c: 0 for c in COLLECTIVES}
        self.calls = {c: 0 for c in COLLECTIVES}

    def _collective(self, func, args, out) -> bool:
        kind = _KIND.get(func._overloadpacket._qualified_op_name.replace("::", "."))
        if kind == "all-gather" and _gloo_gather(func, args):
            kind = "all-to-all"  # what GlooGathers runs
        if kind is not None:
            self.collectives[kind] += _nbytes(out)
            self.calls[kind] += 1
        return kind is not None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor

        kwargs = kwargs or {}
        formula = _flop_formula(func)
        if any(issubclass(t, DTensor) for t in types):
            if formula is None:
                return NotImplemented
            with _Collectives(self):
                out = func(*args, **kwargs)
            split = math.prod(out.device_mesh.size(i) for i, p in enumerate(out.placements)
                              if isinstance(p, (Shard, Partial)))
            self.flops += int(formula(*args, **kwargs, out_val=out)) // split
            return out
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor) for a in args) or isinstance(out, FakeTensor):
            return out
        if not self._collective(func, args, out) and formula is not None and (
                not _in_sharding_propagation()):
            self.flops += int(formula(*args, **kwargs, out_val=out))
        return out
