"""Start the ranks of a ``torch.distributed`` job on one host.

:func:`spawn` runs ``fn(mesh, *args)`` in ``world`` processes, one a rank,
on ``device`` (``cuda`` unless the caller passes ``"cpu"``; raising
without a GPU), each in a process group of the backend (``nccl`` on cards
and ``gloo`` on the CPU unless named; ``gloo`` for more ranks than
cards), initialised through a ``FileStore`` in a fresh temporary
directory: no network.  ``mesh`` is a
1-D ``DeviceMesh`` whose one dim is named ``"data"``.  The launcher
(``repro_torch.launch.serve --mesh``), the tests and ``chip_smoke.py``
start their ranks with it.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device

__all__ = ["spawn"]


def _rank_main(rank: int, fn, world: int, backend: str, device: str, tmp: str,
               args: tuple) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        mesh = DeviceMesh(dev.type, list(range(world)), mesh_dim_names=("data",))
        out = fn(mesh, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str | None = None, device: str | None = None,
          args: tuple = (), timeout: float | None = None) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` ranks and return their return
    values (which must pickle) in rank order.  ``fn`` must be importable
    by name (a module-level function); ``mesh``'s one dim is ``"data"``
    (``EngineSpec``'s default ``shard_axis``).  Any rank's failure is
    raised here, after the other ranks are stopped; so is ``TimeoutError``
    when ``timeout`` seconds pass first.  On ``cuda`` rank r takes card
    ``r % device_count``; ``nccl`` needs a card a rank and raises
    otherwise, naming ``gloo``.  ``device`` defaults to ``cuda`` (raising
    without a GPU), ``backend`` to ``nccl`` on ``cuda`` and ``gloo`` on
    the CPU."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl runs on CUDA devices; use --backend gloo on the CPU")
        n = torch.cuda.device_count()
        if world > n:
            raise ValueError(f"nccl needs one card a rank: {world} ranks, {n} card(s); "
                             f"run more ranks than cards with --backend gloo")
    tmp = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    try:
        ctx = mp.start_processes(_rank_main, args=(fn, world, backend, str(dev), tmp, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):  # raises a rank's failure, stopping the rest
            if deadline is not None and time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(f"spawn: {world} ranks still running after {timeout} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
