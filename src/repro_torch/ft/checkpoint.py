"""Checkpoints of the port (port of ``repro/ft/checkpoint.py``): one
``.npy`` file a leaf and a JSON manifest, committed by an atomic rename,
keep-last-k retention and an async writer thread.

The layout on disk is the reference's, so either package restores the
other's checkpoints:

    <dir>/step_00000420.tmp/...   (in flight)
    <dir>/step_00000420/manifest.json + leaf_00000.npy ...   (committed)

The leaves go in the reference's ``jax.tree.flatten`` order: the
``TrainState`` fields ``params, m, v, step, err``, dict keys sorted.  The
manifest holds ``step``, ``n_leaves``, ``paths`` (``jax.tree_util.keystr``
of each leaf), ``dtypes``, ``shapes`` and ``time``.  A ``TrainState``
whose params are an LM module is written in the reference's layout
(:func:`repro_torch.convert.train_state_to_reference`: layers stacked,
experts unfolded), and read back into the port's.  A bf16 leaf is written
as two-byte void data (its ``uint16`` bits; numpy gives the header
``'|V2'`` where the reference's ``ml_dtypes`` gives ``'<V2'``, the data
bytes are the same) with ``bfloat16`` in the manifest's ``dtypes``, and is
read back through that dtype, with no ``ml_dtypes``.

A sharded state (DTensor leaves: every state ``launch.cells.shard_cell``
makes) is written in the same format with no leaf gathered: every rank
of its mesh copies its own shards to host memory and writes them into
their region of the step's leaf files.  The first rank (coordinate 0 on
every mesh dim) creates each split leaf's file at full size
(``np.lib.format.open_memmap``) and writes the leaves no dim splits; a
shard that several ranks hold is written by the one at coordinate 0
along the dims that do not split it.  The ranks signal through files in
the step's directory, with no collective (the manager's writer thread
runs beside the step's own collectives): the first rank's ``_ready``
once the files exist, each rank's ``_done_<i>`` once its regions are on
disk; the first rank then commits the step (manifest, atomic rename),
and every rank returns once the step is committed.  The directory must
be one that every rank reads and writes.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch import pytree
from repro_torch.convert import (lm_from_reference, tensor_from_numpy, train_state_from_numpy,
                                 train_state_to_reference)
from repro_torch.dist.sharding import (AxisEnv, _is_logical_leaf, barrier, local_slices, place,
                                      shard_span, use_axis_env)
from repro_torch.models.transformer import TransformerLM, port_logical
from repro_torch.train.optimizer import TrainState

__all__ = ["CheckpointManager", "save_pytree", "load_pytree", "latest_step"]


def _lm_state(tree) -> bool:
    return isinstance(tree, TrainState) and isinstance(tree.params, nn.Module)


def _meta(t: torch.Tensor) -> torch.Tensor:
    """An empty meta tensor of ``t``'s (global) shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _reference(tree, device: str = "cpu"):
    """``tree`` in the layout written to disk: copies on ``device``
    (``"meta"``: the global shapes alone, of plain or DTensor leaves)."""
    if _lm_state(tree):
        if torch.device(device).type == "meta":
            return train_state_to_reference(tree, leaf=_meta)
        return train_state_to_reference(tree, device)
    return pytree.tree_map(
        lambda x: x.detach().to(device, copy=True) if isinstance(x, torch.Tensor)
        else np.array(x), tree)


def _spec(x) -> tuple[str, list[int]]:
    """A leaf's manifest dtype and its global shape, from its metadata."""
    if isinstance(x, _Stacked):
        dt, shape = _spec(x.xs[0])
        return dt, [len(x.xs), *shape]
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch."), list(x.shape)
    arr = np.asarray(x)
    return str(arr.dtype), list(arr.shape)


def _host(x) -> np.ndarray:
    """A leaf as the array written to disk (bf16 as two-byte void data)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16).view("V2")
    return arr


class _Stacked:
    """A reference leaf that stacks the port's per-layer tensors ``xs``,
    not built until it is written."""

    def __init__(self, xs: list):
        self.xs = xs


def _mesh_of(tree) -> DeviceMesh | None:
    """The mesh of a state's DTensor leaves, or None for a plain state."""
    leaves = pytree.leaves(tree.params if _lm_state(tree) else tree)
    return next((x.device_mesh for x in leaves if isinstance(x, DTensor)), None)


WAIT_S = 900.0  # seconds a rank waits for another's file before it raises


def _wait_for(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: {what} not there after {WAIT_S} s")
        time.sleep(0.01)


def _mark(path: str) -> None:
    """An empty file at ``path``, whole or absent (written, then renamed)."""
    with open(path + ".part", "w"):
        pass
    os.replace(path + ".part", path)


def _ref_items(tree) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` of ``tree`` in the layout on disk, the leaves as
    they are (an LM's layer leaves as :class:`_Stacked`)."""
    ref = train_state_to_reference(tree, leaf=lambda t: t, stack=_Stacked) \
        if _lm_state(tree) else tree
    return pytree.leaves_with_path(ref)


def _manifest(items, step: int) -> dict:
    specs = [_spec(x) for _, x in items]
    return {"step": step, "n_leaves": len(items),
            "paths": [pytree.keystr(p) for p, _ in items],
            "dtypes": [dt for dt, _ in specs], "shapes": [shape for _, shape in specs]}


class _Rank(NamedTuple):
    """A rank's place in a sharded save: its index in the mesh (the
    first rank's is 0) and the mesh's number of ranks."""

    index: int
    n: int


def _rank(mesh: DeviceMesh) -> _Rank:
    coord = mesh.get_coordinate()
    return _Rank(int(np.ravel_multi_index(coord, tuple(mesh.shape))), mesh.size())


def _split(x: DTensor) -> bool:
    return any(isinstance(p, Shard) and x.device_mesh.size(i) > 1
               for i, p in enumerate(x.placements))


def _writes(x: DTensor) -> bool:
    """Whether this rank writes its shard of ``x``: it is at coordinate 0
    along every mesh dim that does not split ``x``."""
    coord = x.device_mesh.get_coordinate()
    return not any(coord[i] for i, p in enumerate(x.placements) if not isinstance(p, Shard))


def _region(x: DTensor) -> tuple[slice, ...]:
    return tuple(slice(a, a + n) for a, n in (shard_span(x, d) for d in range(x.dim())))


def _parts(items, first: bool) -> tuple[list, dict]:
    """This rank's share of a sharded state, copied to host memory: the
    regions it writes of each split leaf ``[(leaf index, region, array),
    ...]``, and the leaves no dim splits ``{leaf index: array}`` (the
    first rank's alone)."""
    parts, whole = [], {}
    for i, (_, x) in enumerate(items):
        xs = x.xs if isinstance(x, _Stacked) else [x]
        if any(isinstance(t, DTensor) and _split(t) for t in xs):
            for layer, t in enumerate(xs):
                if _writes(t):
                    lead = (slice(layer, layer + 1),) if isinstance(x, _Stacked) else ()
                    arr = _host(t.to_local().to("cpu", copy=True))
                    parts.append((i, lead + _region(t), arr[None] if lead else arr))
        elif first:
            local = [t.to_local() if isinstance(t, DTensor) else t for t in xs]
            one = torch.stack(local) if isinstance(x, _Stacked) else local[0]
            whole[i] = _host(one.detach().to("cpu", copy=True))
    return parts, whole


def _np_dtype(dt: str) -> np.dtype:
    return np.dtype("V2") if dt == "bfloat16" else np.dtype(dt)


def _commit_parts(directory: str, step: int, manifest: dict, parts: list, whole: dict,
                  me: _Rank) -> str:
    """A sharded save's files, every rank's part (the protocol of the
    module docstring); returns once the step is committed."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    leaf = lambda i: os.path.join(tmp, f"leaf_{i:05d}.npy")
    if me.index == 0:
        os.makedirs(tmp)
        for i, (dt, shape) in enumerate(zip(manifest["dtypes"], manifest["shapes"])):
            if i in whole:
                np.save(leaf(i), whole[i])
            else:
                np.lib.format.open_memmap(leaf(i), mode="w+", dtype=_np_dtype(dt),
                                          shape=tuple(shape)).flush()
        _mark(os.path.join(tmp, "_ready"))
    else:
        _wait_for(lambda: os.path.exists(os.path.join(tmp, "_ready")), f"{tmp}/_ready")
    for i, region, arr in parts:
        mm = np.load(leaf(i), mmap_mode="r+")
        (mm.view(np.uint16) if manifest["dtypes"][i] == "bfloat16" else mm)[region] = arr
        mm.flush()
        del mm
    _mark(os.path.join(tmp, f"_done_{me.index}"))
    if me.index:
        _wait_for(lambda: not os.path.exists(tmp), f"the commit of {final}")
        return final
    for r in range(me.n):
        _wait_for(lambda: os.path.exists(os.path.join(tmp, f"_done_{r}")), f"{tmp}/_done_{r}")
    for name in ["_ready"] + [f"_done_{r}" for r in range(me.n)]:
        os.remove(os.path.join(tmp, name))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest | {"time": time.time()}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _clear(directory: str, mesh: DeviceMesh, step: int | None = None) -> None:
    """The first rank removes what a failed save left (a step's ``.tmp``,
    or every one with ``step`` None), then every rank of ``mesh`` waits
    for it (a barrier: run from the main thread only)."""
    if not any(mesh.get_coordinate()) and os.path.isdir(directory):
        for d in os.listdir(directory):
            if d.endswith(".tmp") and (step is None or d == f"step_{step:08d}.tmp"):
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    barrier(mesh)


def save_pytree(tree: Any, directory: str, step: int) -> str:
    """Synchronous atomic save, one leaf at a time. Returns the committed
    directory.

    A sharded state (DTensor leaves, every rank of its mesh calling this:
    any state ``launch.cells.shard_cell`` makes; a sharded MoE layer's
    virtual experts are held unfolded, the layout on disk, and written as
    they are) is written in the same format, each rank writing its own
    shards into the leaf files and no leaf gathered (the module
    docstring)."""
    mesh = _mesh_of(tree)
    if mesh is not None:
        os.makedirs(directory, exist_ok=True)
        me = _rank(mesh)
        items = _ref_items(tree)
        parts, whole = _parts(items, me.index == 0)
        _clear(directory, mesh, step)
        return _commit_parts(directory, step, _manifest(items, step), parts, whole, me)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    items = _ref_items(tree)
    for i, (_, x) in enumerate(items):
        whole = torch.stack(x.xs) if isinstance(x, _Stacked) else x
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), _host(whole))
        del whole
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(_manifest(items, step) | {"time": time.time()}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _steps(directory: str) -> list[int]:
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [s for s in _steps(directory)
             if os.path.exists(os.path.join(directory, f"step_{s:08d}", "manifest.json"))]
    return max(steps) if steps else None


def _read(d: str, manifest: dict, ref, mmap: bool = False) -> list[np.ndarray]:
    """The checkpoint's arrays in ``ref``'s leaf order (memory-mapped with
    ``mmap``), bf16 leaves as their ``uint16`` bits; raises unless its
    paths and shapes are ``ref``'s."""
    items = pytree.leaves_with_path(ref)
    if [pytree.keystr(p) for p, _ in items] != manifest["paths"]:
        raise ValueError(f"load_pytree: {d} holds another tree structure "
                         f"({manifest['n_leaves']} leaves, {len(items)} expected)")
    arrays = []
    for i, ((path, x), dt) in enumerate(zip(items, manifest["dtypes"])):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"), mmap_mode="r" if mmap else None)
        if dt == "bfloat16":  # two-byte void data: the bf16 bits
            arr = arr.view(np.uint16)
        if tuple(arr.shape) != tuple(np.shape(x)):
            raise ValueError(f"load_pytree: {pytree.keystr(path)} has shape {arr.shape}, "
                             f"expected {tuple(np.shape(x))}")
        arrays.append(arr)
    return arrays


def load_pytree(like: Any, directory: str, step: int | None = None,
                device: str | torch.device | None = None, env: AxisEnv | None = None,
                logical: Any = None) -> Any:
    """Restore checkpoint ``step`` (the latest when None) into the
    structure of ``like``, as new tensors on ``device`` or, when None, on
    each leaf's device in ``like`` (an LM module's device for its state).
    Raises unless the checkpoint's paths and shapes are ``like``'s.

    With ``env`` and ``logical`` (the reference's ``shardings=``: the
    elastic restart onto another mesh, such as ``ft.replan``'s
    ``MeshPlan.device_mesh()``), an LM ``TrainState``, dense or MoE, is
    restored as DTensors on ``env``'s mesh, placed by ``logical``, the
    logical tree of the reference's layout (a train cell's
    ``in_logical[0]``): each rank reads only its shard of each leaf (a
    memory-mapped ``.npy``), on ``device`` (default: the mesh's device
    type).  A MoE layer's experts come back in the checkpoint's (the
    reference's) unfolded layout, as :func:`~repro_torch.launch.cells.
    shard_cell` places them.  Any other state (a GNN's or two-tower's
    ``TrainState``, a tree of tensors) comes back with every leaf placed
    by its names in ``logical`` (a leaf it does not name: replicated).
    ``like`` gives only the structure (a state on ``meta`` will do);
    ``step`` comes back plain."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if env is not None:
        return _load_sharded(like, d, manifest, device, env, logical)
    ref = _reference(like, "meta") if _lm_state(like) else like
    it = iter(_read(d, manifest, ref))
    if _lm_state(like):
        loaded = pytree.tree_map(lambda _: next(it), ref)
        dev = device if device is not None else like.params.device
        return train_state_from_numpy(loaded, like.params.cfg, dev)

    def put(x):
        arr = next(it)
        if not isinstance(x, torch.Tensor):
            return arr
        return tensor_from_numpy(arr, x.dtype).to(x.device if device is None else device)

    return pytree.tree_map(put, like)


def _load_sharded(like, d: str, manifest: dict, device, env: AxisEnv, logical):
    """:func:`load_pytree`'s restore onto ``env``'s mesh."""
    if logical is None:
        raise ValueError("load_pytree(env=...) needs the state's logical tree (logical=)")
    dev = torch.device(device if device is not None else env.mesh.device_type)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not _lm_state(like):
        return _load_tree_sharded(like, d, manifest, dev, env, logical)
    cfg = like.params.cfg
    meta = _reference(like, "meta")
    it = iter(_read(d, manifest, meta, mmap=True))
    loaded = pytree.tree_map(lambda _: next(it), meta)

    with use_axis_env(env):
        def part(tree, names: dict, dtype_of) -> dict:
            out = {}

            # an expert leaf as the reference holds it, unfolded, which is
            # how a sharded model holds its virtual experts (shard_cell)
            def put(name, x, _):
                sl = local_slices(x.shape, *names[name])
                t = tensor_from_numpy(np.ascontiguousarray(x[sl]), dtype_of(name)).to(dev)
                out[name] = place(t, *names[name], local=True, shape=x.shape)

            lm_from_reference(tree, cfg, put)
            return out

        model = TransformerLM(cfg, device="meta", init=False)
        dtypes = {n: p.dtype for n, p in model.named_parameters()}
        params = part(loaded.params, port_logical(cfg, logical.params), dtypes.__getitem__)
        for name, t in params.items():
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner) if owner else model, leaf,
                    nn.Parameter(t, requires_grad=True))
        f32 = lambda _: torch.float32
        trees = {k: None if getattr(loaded, k) is None else
                 part(getattr(loaded, k), port_logical(cfg, getattr(logical, k) or logical.m),
                      f32) for k in ("m", "v", "err")}
    step = torch.from_numpy(np.array(loaded.step, np.int32)).to(dev)
    return TrainState(params=model, step=step, **trees)


def _names_at(logical, path: tuple, ndim: int) -> tuple:
    """The logical names of the leaf at ``path`` in a logical tree (all
    None where the tree names no such leaf)."""
    node = logical
    for kind, k in path:
        if kind == "attr":
            node = getattr(node, k, None)
        elif isinstance(node, dict):
            node = node.get(k)
        elif isinstance(node, (list, tuple)) and not _is_logical_leaf(node) and k < len(node):
            node = node[k]
        else:
            node = None
        if node is None:
            break
    return node if _is_logical_leaf(node) and len(node) == ndim else (None,) * ndim


def _load_tree_sharded(like, d: str, manifest: dict, dev, env: AxisEnv, logical):
    """A state that is no LM's restored onto ``env``'s mesh: each leaf
    placed by its names in ``logical``, each rank reading its part of a
    memory-mapped leaf; a ``TrainState``'s ``step`` plain."""
    items = pytree.leaves_with_path(like)
    arrays = _read(d, manifest, like, mmap=True)
    out = []
    with use_axis_env(env):
        for (path, x), arr in zip(items, arrays):
            dtype = x.dtype if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.zeros(0, arr.dtype)).dtype
            if path[:1] == (("attr", "step"),):
                out.append(tensor_from_numpy(arr, dtype).to(dev))
                continue
            names = _names_at(logical, path, arr.ndim)
            sl = local_slices(arr.shape, *names)
            t = tensor_from_numpy(arr[sl], dtype).to(dev)
            out.append(place(t, *names, local=True, shape=arr.shape))
    it = iter(out)
    return pytree.tree_map(lambda _: next(it), like)


class CheckpointManager:
    """Async writer with keep-k retention and a save-every-N policy.

    ``maybe_save`` copies the tree to host memory before queueing it, so
    the caller may update its state in place at once; a writer thread saves
    and prunes.  ``wait`` blocks until every queued save is committed,
    ``check`` raises the writer's first error, ``close`` waits and stops
    the thread.  A sharded state: every rank of its mesh calls
    ``maybe_save`` and holds a manager on the same directory; each copies
    only its own shards, and the ranks' writer threads write and commit the
    step as :func:`save_pytree` does (through files, with no collective);
    the first rank prunes.  The first sharded save removes what a failed
    save left (one barrier, from the calling thread)."""

    def __init__(self, directory: str, keep: int = 3, every_steps: int = 100):
        self.directory = directory
        self.keep = keep
        self.every_steps = every_steps
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._errors: list[Exception] = []
        self._cleared = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def maybe_save(self, tree: Any, step: int, force: bool = False) -> bool:
        if not force and (step % self.every_steps != 0):
            return False
        mesh = _mesh_of(tree)
        if mesh is None:
            self._q.put((_reference(tree), step, None))
            return True
        me = _rank(mesh)
        items = _ref_items(tree)
        job = (_manifest(items, step), *_parts(items, me.index == 0), me)
        if not self._cleared:
            os.makedirs(self.directory, exist_ok=True)
            _clear(self.directory, mesh)
            self._cleared = True
        self._q.put((None, step, job))
        return True

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                tree, step, job = item
                if job is None:
                    save_pytree(tree, self.directory, step)
                else:
                    _commit_parts(self.directory, step, *job)
                if job is None or job[-1].index == 0:
                    self._gc()
            except Exception as e:  # surfaced by check()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self) -> None:
        steps = sorted(_steps(self.directory))
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def wait(self) -> None:
        self._q.join()

    def check(self) -> None:
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        self._q.join()
        self._q.put(None)
        self._worker.join(timeout=10)
