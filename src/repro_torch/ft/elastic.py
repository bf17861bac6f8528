"""Elastic re-planning and straggler detection (port of
``repro/ft/elastic.py``).

*Elastic re-plan*: on a change of capacity, :func:`replan` takes the
largest ``(data, model)`` mesh that keeps the ``model`` axis whole (a
tensor-parallel group does not survive losing a member) and divides the
global batch over the data axis, shrinking it until the batch divides.
The mesh here is a record, :class:`MeshPlan`: the array of device indices
(ranks) and the axis names, as ``jax.sharding.Mesh`` holds them; its
:meth:`MeshPlan.device_mesh` is the ``torch.distributed`` ``DeviceMesh``
over those ranks, which the sharding layer
(:mod:`repro_torch.dist.sharding`) places tensors on.

*Straggler detection*: :class:`StepWatchdog` flags a step slower than
``factor`` times the median of the steps before it; the driver restores
from the last checkpoint and reports the host through ``on_straggler``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["MeshPlan", "best_mesh_for", "StepWatchdog", "ElasticPlan", "replan"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """``devices``: the ``(data, model)`` array of device indices."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device_mesh(self, device_type: str = "cuda") -> DeviceMesh:
        """The ``DeviceMesh`` of these ranks (the ranks left out by a
        re-plan are not in it), in an initialised process group that holds
        them."""
        return DeviceMesh(device_type, torch.as_tensor(self.devices),
                          mesh_dim_names=self.axis_names)


def best_mesh_for(n_devices: int, model_axis: int, axis_names=("data", "model"),
                  devices=None) -> MeshPlan:
    """Largest (data, model) mesh with the TP axis preserved, over the
    first devices of ``devices`` (indices ``0 .. n_devices - 1`` when
    None); ``.device_mesh()`` of the result is its ``DeviceMesh``."""
    if n_devices < model_axis:
        raise ValueError(
            f"cannot preserve model axis {model_axis} with {n_devices} devices"
        )
    data = n_devices // model_axis
    devs = np.asarray(devices if devices is not None else np.arange(n_devices))
    return MeshPlan(devs[: data * model_axis].reshape(data, model_axis), tuple(axis_names))


@dataclasses.dataclass
class ElasticPlan:
    mesh: MeshPlan
    global_batch: int
    per_replica_batch: int


def replan(n_devices: int, model_axis: int, global_batch: int, devices=None) -> ElasticPlan:
    """Recompute mesh + batch split after a capacity change; the global
    batch is preserved (gradient semantics unchanged) as long as it divides
    the new data-parallel degree."""
    mesh = best_mesh_for(n_devices, model_axis, devices=devices)
    dp = mesh.devices.shape[0]
    while global_batch % dp != 0:
        dp -= 1  # shrink dp by trimming stragglers off the mesh
        mesh = best_mesh_for(dp * model_axis, model_axis, devices=devices)
    return ElasticPlan(mesh=mesh, global_batch=global_batch,
                       per_replica_batch=global_batch // dp)


class StepWatchdog:
    """Detects straggling/hung steps by comparing against a running median."""

    def __init__(self, factor: float = 3.0, min_history: int = 5,
                 on_straggler: Callable[[int, float], None] | None = None):
        self.factor = factor
        self.min_history = min_history
        self.on_straggler = on_straggler
        self.history: list[float] = []
        self.flagged: list[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if the step is deemed a straggler."""
        is_bad = False
        if len(self.history) >= self.min_history:
            med = float(np.median(self.history))
            if seconds > self.factor * med:
                is_bad = True
                self.flagged.append(step)
                if self.on_straggler:
                    self.on_straggler(step, seconds)
        if not is_bad:
            self.history.append(seconds)
            self.history = self.history[-128:]
        return is_bad
