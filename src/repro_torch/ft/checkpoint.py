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

from repro_torch import pytree
from repro_torch.convert import tensor_from_numpy, train_state_from_numpy, train_state_to_reference
from repro_torch.train.optimizer import TrainState

__all__ = ["CheckpointManager", "save_pytree", "load_pytree", "latest_step"]


def _lm_state(tree) -> bool:
    return isinstance(tree, TrainState) and isinstance(tree.params, nn.Module)


def _reference(tree, device: str = "cpu"):
    """``tree`` in the layout written to disk: copies on ``device``."""
    if _lm_state(tree):
        return train_state_to_reference(tree, device)
    return pytree.tree_map(
        lambda x: x.detach().to(device, copy=True) if isinstance(x, torch.Tensor)
        else np.array(x), tree)


def _host(x) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk, and its manifest dtype."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16).view("V2"), "bfloat16"
    return arr, str(arr.dtype)


def save_pytree(tree: Any, directory: str, step: int) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    items = pytree.leaves_with_path(_reference(tree) if _lm_state(tree) else tree)
    host = [_host(x) for _, x in items]
    manifest = {
        "step": step,
        "n_leaves": len(items),
        "paths": [pytree.keystr(p) for p, _ in items],
        "dtypes": [dt for _, dt in host],
        "shapes": [list(a.shape) for a, _ in host],
        "time": time.time(),
    }
    for i, (arr, _) in enumerate(host):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
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


def load_pytree(like: Any, directory: str, step: int | None = None,
                device: str | torch.device | None = None) -> Any:
    """Restore checkpoint ``step`` (the latest when None) into the
    structure of ``like``, as new tensors on ``device`` or, when None, on
    each leaf's device in ``like`` (an LM module's device for its state).
    Raises unless the checkpoint's paths and shapes are ``like``'s."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    ref = _reference(like, "meta") if _lm_state(like) else like
    items = pytree.leaves_with_path(ref)
    if [pytree.keystr(p) for p, _ in items] != manifest["paths"]:
        raise ValueError(f"load_pytree: {d} holds another tree structure "
                         f"({manifest['n_leaves']} leaves, {len(items)} expected)")
    arrays = []
    for i, ((path, x), dt) in enumerate(zip(items, manifest["dtypes"])):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        if dt == "bfloat16":  # two-byte void data: the bf16 bits
            arr = arr.view(np.uint16)
        if tuple(arr.shape) != tuple(np.shape(x)):
            raise ValueError(f"load_pytree: {pytree.keystr(path)} has shape {arr.shape}, "
                             f"expected {tuple(np.shape(x))}")
        arrays.append(arr)
    it = iter(arrays)
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
