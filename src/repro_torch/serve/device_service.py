"""DEPRECATED device-plane entrypoint (legacy ``metric: str`` flags; port
of ``repro/serve/device_service.py``).

The serving loop lives in :mod:`repro_torch.serve.spade_service` behind
the :class:`~repro_torch.serve.spade_service.SpadeService` facade; this
module keeps the old keyword signature of ``run_device_service`` working
as a shim that translates its flags into an
:class:`~repro_torch.serve.spade_service.EngineSpec` (``predictive=False``:
the legacy workset mode is the synced-scalar dispatcher).  ``device``
(default ``cuda``, raising without a GPU) is the port's own addition, as
on ``EngineSpec``.  Each call emits a
:class:`~repro_torch._warnings.SpadeDeprecationWarning`.
"""

from __future__ import annotations

import warnings

from torch.distributed.device_mesh import DeviceMesh

from repro_torch._warnings import SpadeDeprecationWarning
from repro_torch.graphstore.generators import TxStream
from repro_torch.serve.spade_service import DeviceServiceReport, EngineSpec, SpadeService

__all__ = ["DeviceServiceReport", "run_device_service"]


def run_device_service(
    stream: TxStream,
    metric: str = "DW",
    batch_edges: int = 1024,
    eps: float = 0.1,
    max_rounds: int = 20,
    refresh_every: int = 0,
    capacity_slack: float = 1.3,
    mesh: DeviceMesh | None = None,
    shard_axis: str = "data",
    window_ticks: int = 0,
    workset: bool = False,
    min_bucket: int = 64,
    device: str | None = None,
) -> DeviceServiceReport:
    """DEPRECATED shim: use ``SpadeService(semantics, EngineSpec(...))``.

    Flag-for-flag the same loop (same seeding, same engines, synced-scalar
    workset dispatch); ``metric`` resolves through the one semantics
    registry, so registered custom semantics work here too.
    """
    warnings.warn(
        "run_device_service is deprecated; use repro_torch.serve.SpadeService "
        "with an EngineSpec (semantics=... replaces metric=...)",
        SpadeDeprecationWarning,
        stacklevel=2,
    )
    spec = EngineSpec(
        plane="device",
        mesh=mesh,
        shard_axis=shard_axis,
        batch_edges=batch_edges,
        eps=eps,
        max_rounds=max_rounds,
        refresh_every=refresh_every,
        capacity_slack=capacity_slack,
        window_ticks=window_ticks,
        workset=workset,
        predictive=False,
        min_bucket=min_bucket,
        device=device,
    )
    return SpadeService(semantics=metric, spec=spec).run(stream)
