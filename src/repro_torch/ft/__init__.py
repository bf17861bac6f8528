"""Fault tolerance of the port (port of ``repro/ft``): checkpoints in the
reference's layout, elastic re-planning and the straggler watchdog."""

from .checkpoint import CheckpointManager, latest_step, load_pytree, save_pytree
from .elastic import ElasticPlan, MeshPlan, StepWatchdog, best_mesh_for, replan

__all__ = ["CheckpointManager", "save_pytree", "load_pytree", "latest_step",
           "StepWatchdog", "best_mesh_for", "replan", "ElasticPlan", "MeshPlan"]
