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
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import pytree
from repro_torch.convert import (lm_from_reference, tensor_from_numpy, train_state_from_numpy,
                                 train_state_to_reference)
from repro_torch.dist.sharding import (AxisEnv, barrier, local_slices, place, redistribute,
                                      use_axis_env)
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
    leaves = pytree.leaves(tree)
    return next((x.device_mesh for x in leaves if isinstance(x, DTensor)), None)


def _whole(x, host: bool):
    """A leaf whole, on the host when ``host`` (else None, after taking
    part): a DTensor gathered (a named redistribute, collective: every
    rank of its mesh calls it), a stacked layer leaf built one layer at a
    time."""
    if isinstance(x, _Stacked):
        xs = [_whole(t, host) for t in x.xs]
        return torch.stack(xs) if host else None
    if isinstance(x, DTensor):
        x = redistribute(x.detach(), [Replicate()] * x.device_mesh.ndim).to_local()
    if not host:
        return None
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def save_pytree(tree: Any, directory: str, step: int) -> str:
    """Synchronous atomic save, one leaf at a time. Returns the committed
    directory.

    A sharded state (an LM state whose leaves are DTensors, dense or MoE:
    a sharded MoE layer's virtual experts are held unfolded, the layout on
    disk, and written as they are) is written in the same format: every
    rank of its mesh takes part in gathering each leaf, the mesh's first
    rank writes it and commits, and the ranks leave together."""
    mesh = _mesh_of(tree.params if _lm_state(tree) else tree)
    writer = mesh is None or not any(mesh.get_coordinate())
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    ref = train_state_to_reference(tree, leaf=lambda t: t, stack=_Stacked) \
        if _lm_state(tree) else tree
    items = pytree.leaves_with_path(ref)
    for i, (_, x) in enumerate(items):
        whole = _whole(x, writer)
        if writer:
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), _host(whole))
        del whole
    if writer:
        specs = [_spec(x) for _, x in items]
        manifest = {
            "step": step,
            "n_leaves": len(items),
            "paths": [pytree.keystr(p) for p, _ in items],
            "dtypes": [dt for dt, _ in specs],
            "shapes": [shape for _, shape in specs],
            "time": time.time(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
    if mesh is not None:
        barrier(mesh)
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
    shard_cell` places them.  ``like`` gives only the
    structure (a state on ``meta`` will do); ``step`` comes back plain."""
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
    if not _lm_state(like):
        raise NotImplementedError("load_pytree(env=...): a sharded restore takes an LM "
                                  "TrainState (the dense train cells' state)")
    if logical is None:
        raise ValueError("load_pytree(env=...) needs the state's logical tree (logical=)")
    cfg = like.params.cfg
    meta = _reference(like, "meta")
    it = iter(_read(d, manifest, meta, mmap=True))
    loaded = pytree.tree_map(lambda _: next(it), meta)
    dev = torch.device(device if device is not None else env.mesh.device_type)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

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


class CheckpointManager:
    """Async writer with keep-k retention and a save-every-N policy.

    ``maybe_save`` copies the tree to host memory before queueing it, so
    the caller may update its state in place at once; a writer thread saves
    and prunes.  ``wait`` blocks until every queued save is committed,
    ``check`` raises the writer's first error, ``close`` waits and stops
    the thread."""

    def __init__(self, directory: str, keep: int = 3, every_steps: int = 100):
        self.directory = directory
        self.keep = keep
        self.every_steps = every_steps
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._errors: list[Exception] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def maybe_save(self, tree: Any, step: int, force: bool = False) -> bool:
        if not force and (step % self.every_steps != 0):
            return False
        if _mesh_of(tree.params if _lm_state(tree) else tree) is not None:
            raise NotImplementedError("CheckpointManager: a sharded state is saved by "
                                      "save_pytree, which every rank calls")
        self._q.put((_reference(tree), step))
        return True

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                tree, step = item
                save_pytree(tree, self.directory, step)
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
