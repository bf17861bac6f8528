"""``SpadeService`` on torch: one facade over the host plane and the
device plane on one device (the counterpart of
``repro.serve.spade_service``).

    ``SpadeService(semantics, spec: EngineSpec).run(stream)``

With ``EngineSpec(plane="host")`` it replays the stream through the exact
host oracle (``repro_torch.core.Spade``: per-edge reorders with edge
grouping, NumPy on the host CPU) and returns a
:class:`repro_torch.serve.service.ServiceReport`.  The device plane
replays a transaction stream in fixed-size ticks: the base graph is
seeded through the semantics' batch-seeding rule, each tick is weighted
by the semantics' ``batch_weights`` and maintained through the fused,
workset or predictive-workset engine, and per-tick statistics (benign
counts, the ever-detected set) accumulate on the device and are drained
once at shutdown.  The stream's increments are copied to the device once,
before the first tick.

``EngineSpec.device`` picks the device plane's device: ``None`` means
``cuda`` and raises without a GPU; ``"cpu"`` runs the plain PyTorch path.
``EngineSpec(mesh=DeviceMesh, shard_axis=...)`` serves through the
edge-sharded engine (:mod:`repro_torch.dist.graph`): every rank of the
mesh runs the service on the same stream, holds its block of the edge
buffers and gets the same report (tick times are the slowest rank's).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.incremental import (
    BucketPredictor,
    DeviceSpadeState,
    benign_mask,
    full_refresh,
    init_state,
    insert_and_maintain,
    insert_and_maintain_auto,
    insert_and_maintain_predictive,
    slide_and_maintain,
    slide_and_maintain_auto,
    slide_and_maintain_predictive,
)
from repro_torch.core.metrics import DensityMetric
from repro_torch.core.semantics import SuspSemantics, resolve
from repro_torch.device import resolve_device
from repro_torch.dist.graph import (
    init_sharded_state,
    shard_graph,
    sharded_full_refresh,
    sharded_insert_and_maintain,
    sharded_insert_and_maintain_auto,
    sharded_insert_and_maintain_predictive,
    sharded_slide_and_maintain,
    sharded_slide_and_maintain_auto,
    sharded_slide_and_maintain_predictive,
)
from repro_torch.graphstore.generators import TxStream
from repro_torch.graphstore.structs import device_graph_from_coo
from repro_torch.serve.service import _run_host_service

__all__ = ["EngineSpec", "SpadeService", "DeviceServiceReport"]


@dataclass(frozen=True)
class EngineSpec:
    """Declarative serving-engine configuration (the *where and how*).

    Device-plane fields as in the reference: ``mesh``/``shard_axis`` (a
    ``torch.distributed`` ``DeviceMesh`` and the name of its dim the edge
    buffers are cut along; vertex state replicated; the mesh's device type
    must be ``device``'s), ``window_ticks`` (N-tick
    sliding window; 0 = unbounded insert-only), ``workset`` (affected-area
    engine), ``predictive`` (previous-tick bucket prediction; ignored
    unless ``workset``), ``min_bucket``, ``batch_edges`` (tick size),
    ``eps``, ``max_rounds``, ``refresh_every``, ``capacity_slack``.
    ``device``: ``None`` (``cuda``, raising without a GPU) or an explicit
    device such as ``"cpu"``.

    Host-plane fields: ``grouping`` (benign/urgent edge grouping, Def
    4.1), ``flush_every`` (simulated seconds between forced buffer
    flushes), ``batch_edges`` (edges per InsertBatchEdges call).  The host
    oracle is NumPy on the host CPU, so ``device`` is refused there, as
    ``mesh``, ``workset`` and ``window_ticks`` are.

    ``batch_edges = None`` resolves per plane — 1024-edge device ticks,
    per-edge (batch 1) host reorders, the paper's deployment shape for
    each.  A ``mesh`` that is not a ``DeviceMesh`` raises ``TypeError``.
    """

    plane: str = "device"
    mesh: DeviceMesh | None = None
    shard_axis: str = "data"
    batch_edges: int | None = None
    eps: float = 0.1
    max_rounds: int = 20
    refresh_every: int = 0
    capacity_slack: float = 1.3
    window_ticks: int = 0
    workset: bool = False
    predictive: bool = True
    min_bucket: int = 64
    grouping: bool = True
    flush_every: float = 1.0
    device: str | None = None

    def __post_init__(self):
        if self.plane not in ("device", "host"):
            raise ValueError(f"plane must be 'device' or 'host', got {self.plane!r}")
        if self.batch_edges is not None and self.batch_edges <= 0:
            raise ValueError("batch_edges must be positive")
        if self.plane == "host":
            if self.mesh is not None or self.workset or self.window_ticks:
                raise ValueError(
                    "mesh/workset/window_ticks are device-plane settings; "
                    "the host oracle serves per-edge with grouping/flush_every")
            if self.device is not None:
                raise ValueError(
                    "device is a device-plane setting; the host oracle runs "
                    "in NumPy on the host CPU")
        elif self.mesh is not None and not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                            f"{type(self.mesh).__name__}")

    @property
    def effective_batch_edges(self) -> int:
        """``batch_edges`` with the per-plane default resolved."""
        if self.batch_edges is not None:
            return self.batch_edges
        return 1024 if self.plane == "device" else 1


@dataclass
class DeviceServiceReport:
    n_edges: int
    n_ticks: int
    mean_tick_seconds: float
    mean_us_per_edge: float
    benign_fraction: float
    fraud_recall: float
    final_g: float
    n_refreshes: int
    window_ticks: int = 0  # 0 = unbounded (insert-only) service
    n_expired_edges: int = 0  # edges that slid out of the window
    live_edges: int = 0  # edges resident at shutdown
    n_workset_ticks: int = 0
    n_fallback_ticks: int = 0
    max_suffix_edges: int = 0  # high-water mark of the affected suffix
    max_e_bucket: int = 0  # largest edge bucket dispatched
    n_predicted_ticks: int = 0  # ticks dispatched with predicted buckets
    n_bucket_miss_ticks: int = 0  # predicted buckets the suffix outgrew
    tick_seconds: list[float] = dataclasses.field(default_factory=list)


class SpadeService:
    """The serving entrypoint: a semantics x an engine spec.

    ``semantics`` is a registered name, a :class:`SuspSemantics`, or (host
    plane only) a :class:`DensityMetric`; keyword overrides are merged
    into ``spec`` (``SpadeService("DG", window_ticks=8, device="cpu")``,
    ``SpadeService("FD", plane="host")``).  The device plane's device is
    resolved here, so a missing GPU raises at construction; the host
    plane has no device (``device`` is ``None``).
    """

    def __init__(self, semantics: SuspSemantics | DensityMetric | str = "DW",
                 spec: EngineSpec | None = None, **overrides):
        if spec is None:
            spec = EngineSpec(**overrides)
        elif overrides:
            spec = dataclasses.replace(spec, **overrides)
        self.spec = spec
        if isinstance(semantics, DensityMetric):
            if spec.plane != "host":
                raise TypeError(
                    f"DensityMetric {semantics.name!r} is host-plane-only "
                    "(scalar per-edge hooks); device planes need a "
                    "SuspSemantics — see repro_torch.core.semantics")
            self.semantics: SuspSemantics | DensityMetric = semantics
        else:
            self.semantics = resolve(semantics)
        self.device = resolve_device(spec.device) if spec.plane == "device" else None
        if spec.mesh is not None and spec.mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {spec.mesh.device_type}, the service on "
                             f"{self.device}")
        self.final_state: DeviceSpadeState | None = None

    def run(self, stream: TxStream):
        """Replay ``stream`` through the configured engine.

        Returns a :class:`DeviceServiceReport` (device plane; the
        maintained state at shutdown is kept as ``final_state``) or a
        :class:`repro_torch.serve.service.ServiceReport` (host plane)."""
        if self.spec.plane == "host":
            return _run_host_service(
                stream,
                metric=self.semantics,
                edge_grouping=self.spec.grouping,
                batch_size=self.spec.effective_batch_edges,
                flush_every=self.spec.flush_every,
            )
        report, self.final_state = _run_device_service(
            stream, self.semantics, self.spec, self.device)
        return report


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_device_service(stream: TxStream, sem: SuspSemantics,
                        spec: EngineSpec, device: torch.device
                        ) -> tuple[DeviceServiceReport, DeviceSpadeState]:
    """Fixed-size batched ticks through the device engines; returns the
    report and the final state."""
    n = stream.n_vertices
    m_base = stream.base_src.shape[0]
    m_total = m_base + stream.inc_src.shape[0]
    batch_edges = spec.effective_batch_edges
    window_ticks = spec.window_ticks
    eps, max_rounds = spec.eps, spec.max_rounds
    if window_ticks:
        e_cap = m_base + (window_ticks + 1) * batch_edges
    else:
        e_cap = int(m_total * spec.capacity_slack) + batch_edges

    base_aux = np.zeros(m_base) if sem.uses_aux else None
    base_w, in_deg = sem.seed_base(
        stream.base_src, stream.base_dst, stream.base_amt, n, aux=base_aux
    )
    a0 = sem.seed_vertices(n, in_deg, aux=None)
    g = device_graph_from_coo(
        n, stream.base_src, stream.base_dst, base_w, a=a0,
        n_capacity=-(-n // 512) * 512, e_capacity=-(-e_cap // 512) * 512,
        device=device,
    )
    predictive = spec.workset and spec.predictive
    mesh, axis = spec.mesh, spec.shard_axis
    if mesh is not None:
        g = shard_graph(g, mesh, axis=axis)
        state = init_sharded_state(g, mesh, axis=axis, eps=eps)
        on_mesh = {"mesh": mesh, "axis": axis}
        refresh = partial(sharded_full_refresh, **on_mesh)
        e_bucket_cap = g.e_local  # the sharded workset's edge buckets are per rank
        fused = (sharded_insert_and_maintain, sharded_slide_and_maintain)
        auto = (sharded_insert_and_maintain_auto, sharded_slide_and_maintain_auto)
        pred = (sharded_insert_and_maintain_predictive,
                sharded_slide_and_maintain_predictive)
    else:
        state = init_state(g, eps=eps)
        on_mesh = {}
        refresh = full_refresh
        e_bucket_cap = g.e_capacity
        fused = (insert_and_maintain, slide_and_maintain)
        auto = (insert_and_maintain_auto, slide_and_maintain_auto)
        pred = (insert_and_maintain_predictive, slide_and_maintain_predictive)
    if predictive:
        predictor = BucketPredictor(g.n_capacity, e_bucket_cap,
                                    min_bucket=spec.min_bucket)
        maintain, slide = (partial(f, predictor=predictor, **on_mesh) for f in pred)
    elif spec.workset:
        maintain, slide = (partial(f, min_bucket=spec.min_bucket, **on_mesh) for f in auto)
    else:
        maintain, slide = (partial(f, **on_mesh) for f in fused)
    deg = torch.zeros(g.n_capacity, dtype=torch.int32, device=device)
    deg[:n] = torch.from_numpy(in_deg.astype(np.int32)).to(device)

    # the whole increment stream goes to the device once, padded to whole
    # ticks; each tick takes views of it
    n_inc = stream.inc_src.shape[0]
    n_ticks_total = -(-n_inc // batch_edges)
    padded = n_ticks_total * batch_edges

    def upload(x, dtype):
        buf = np.zeros(padded, dtype)
        buf[:n_inc] = x
        return torch.from_numpy(buf).to(device)

    inc_src = upload(stream.inc_src, np.int32)
    inc_dst = upload(stream.inc_dst, np.int32)
    inc_amt = upload(stream.inc_amt, np.float32)
    inc_valid = upload(np.ones(n_inc, bool), bool)
    inc_aux = upload(stream.inc_time, np.float32) if sem.uses_aux else None

    n_ticks = n_refresh = n_expired = 0
    n_workset = n_fallback = n_predicted = n_miss = 0
    max_suffix_edges = max_e_bucket = 0
    tick_seconds: list[float] = []
    ring: list[int] = []  # per-tick resident edge counts, oldest first
    benign_acc = torch.zeros((), dtype=torch.int64, device=device)
    ever_detected = torch.zeros(g.n_capacity, dtype=torch.bool, device=device)
    slot_ids = torch.arange(g.e_capacity, dtype=torch.int32, device=device)
    for i in range(0, n_inc, batch_edges):
        cnt = min(batch_edges, n_inc - i)
        sl = slice(i, i + batch_edges)
        bs, bd, valid = inc_src[sl], inc_dst[sl], inc_valid[sl]
        aux = inc_aux[sl] if inc_aux is not None else None
        w, deg = sem.batch_weights(deg, bs, bd, inc_amt[sl], valid, aux)
        benign_acc += (benign_mask(state, bs, bd, w) & valid).sum()
        _sync(device)
        t0 = time.perf_counter()
        if window_ticks and len(ring) >= window_ticks:
            # fused tick: expire the oldest resident batch (it sits right
            # after the base graph after every compaction) + insert
            cnt0 = ring.pop(0)
            drop = (slot_ids >= m_base) & (slot_ids < m_base + cnt0)
            kw = {"n_dropped": cnt0} if predictive else {}
            out = slide(state, drop, bs, bd, w, valid, eps=eps,
                        max_rounds=max_rounds, **kw)
            n_expired += cnt0
        else:
            out = maintain(state, bs, bd, w, valid, eps=eps,
                           max_rounds=max_rounds)
        state, info = out if spec.workset else (out, None)
        _sync(device)
        tick_seconds.append(time.perf_counter() - t0)
        if info is not None:
            n_fallback += info.fallback
            n_workset += not info.fallback
            n_predicted += info.predicted
            n_miss += info.miss
            max_suffix_edges = max(max_suffix_edges, info.n_suffix_edges)
            max_e_bucket = max(max_e_bucket, info.e_bucket)
        if window_ticks:
            ring.append(cnt)
            # recall under a window is "ever detected while resident"
            ever_detected |= state.community
        n_ticks += 1
        if spec.refresh_every and n_ticks % spec.refresh_every == 0:
            state = refresh(state, eps=eps)
            n_refresh += 1

    # drain the device-resident stats once, after the loop
    if mesh is not None:  # one report on every rank: the slowest rank's ticks
        t = torch.tensor(tick_seconds, dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
        tick_seconds = t.tolist()
    benign_total = int(benign_acc)
    comm = torch.nonzero(ever_detected | state.community).flatten()
    fraud = set(stream.fraud_block.tolist())
    recall = len(fraud & set(comm.cpu().tolist())) / len(fraud) if fraud else 1.0
    t_total = float(sum(tick_seconds))
    report = DeviceServiceReport(
        n_edges=n_inc,
        n_ticks=n_ticks,
        mean_tick_seconds=t_total / max(n_ticks, 1),
        mean_us_per_edge=1e6 * t_total / max(n_inc, 1),
        benign_fraction=benign_total / max(n_inc, 1),
        fraud_recall=recall,
        final_g=float(state.best_g),
        n_refreshes=n_refresh,
        window_ticks=window_ticks,
        n_expired_edges=n_expired,
        live_edges=int(state.edge_count),
        n_workset_ticks=n_workset,
        n_fallback_ticks=n_fallback,
        max_suffix_edges=max_suffix_edges,
        max_e_bucket=max_e_bucket,
        n_predicted_ticks=n_predicted,
        n_bucket_miss_ticks=n_miss,
        tick_seconds=tick_seconds,
    )
    return report, state
