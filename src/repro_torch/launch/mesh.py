"""Production meshes on ``torch.distributed`` (port of
``repro/launch/mesh.py``), with the reference's shapes and dim names so
that the cells shard as the reference's do.

Single pod: ``(data=16, model=16)``, 256 ranks.  Multi-pod: ``(pod=2,
data=16, model=16)``, 512 ranks; the ``pod`` dim carries pure data
parallelism (parameters replicated across pods, FSDP within a pod), so
the slow inter-pod hop sees only gradient all-reduces.  (The ``model``
dim keeps the reference's 16, where an H100 node holds 8 cards: on
H100s a 16-wide tensor-parallel group spans two nodes.)

``init_device_mesh`` needs a process group of the mesh's size:
``torch.distributed.init_process_group`` with its address, world size and
rank, or, for the dry run in one process, torch's fake process group.
Functions, not constants, so importing this module touches no process
group.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "SINGLE_POD", "MULTI_POD",
           "SINGLE_POD_AXES", "MULTI_POD_AXES"]

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def _world(n: int) -> None:
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise RuntimeError(f"a mesh of {n} ranks needs a process group of {n} ranks "
                           f"(have {have})")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"
                         ) -> DeviceMesh:
    shape = MULTI_POD if multi_pod else SINGLE_POD
    _world(math.prod(shape))
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """``(data=world, model=1)`` over the ranks of the process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group")
    return init_device_mesh(device_type, (dist.get_world_size(), 1),
                            mesh_dim_names=SINGLE_POD_AXES)
