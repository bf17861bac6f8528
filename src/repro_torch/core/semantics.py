"""The pluggable semantics plane on torch: one ``SuspSemantics`` definition
compiled into the port's host oracle and its device engine.

The counterpart of ``repro.core.semantics``.  The numpy half — the dyadic
snap (``quantize_susp``), the batch-seeding rule (``seed_base`` /
``seed_vertices``), the host adapter (``host_metric``: scalar float64
hooks with ``xp = numpy`` and ``aux = None``, snapped by the metric
funnel of :mod:`repro_torch.core.metrics`) and the
``register``/``resolve``/``available`` registry with DG, DW and FD — is a
copy of the reference's, kept here so the port never imports ``repro``.
``batch_weights`` is ported to torch: the hooks receive the
:mod:`repro_torch.core.xp` shim as ``xp``.

Hook signatures (all vectorized; ``aux`` is the per-edge application
payload — the bundled service feeds the transaction timestamp — or
``None``):

* ``esusp(xp, src, dst, raw, in_deg_dst, aux) -> [E]``  edge suspiciousness
  (> 0), with ``in_deg_dst`` the destination in-degree at arrival time.
* ``vsusp(xp, ids, in_deg, aux) -> [V]``  vertex prior (>= 0), or ``None``.

Streamed tick weights stay raw float32, as in the reference.  FD's
``1/log`` differs from JAX's in the last bit on some lanes, so FD batch
weights agree with the reference to float32 ulps only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import xp as _xp
from repro_torch.graphstore.structs import scatter_drop

__all__ = [
    "SuspSemantics",
    "DG",
    "DW",
    "FD",
    "register",
    "resolve",
    "available",
    "quantize_susp",
    "quantize_susp_array",
]

# Dyadic grid (multiples of 2^-30).  Rationale (the host oracle's determinism contract,
# reference.py): the incremental reorder recovers peeling weights as
# Delta_old + edge terms while the from-scratch peel runs a running
# subtraction — different float64 summation orders.  Irrational semantics
# values (FD's 1/log) then drift by an ulp between the two runs and the
# (weight, id) tie-break resolves "equal" weights differently.  Grid values
# with magnitude below 2^23 sum *exactly* in float64 in any order, so ties
# are exact ties and the vertex-id tie-break is stable across incremental
# and scratch runs.  The 2^-30 (~1e-9 relative) snap is far below any
# fraud-semantics signal.
_QUANT_BITS = 30
_QUANTUM = math.ldexp(1.0, -_QUANT_BITS)


def quantize_susp(x: float) -> float:
    """Round a suspiciousness value to the shared dyadic grid."""
    return math.ldexp(round(math.ldexp(x, _QUANT_BITS)), -_QUANT_BITS)


def quantize_susp_array(x):
    """Vectorized :func:`quantize_susp` (numpy, float64 intermediate).

    ``np.rint`` rounds half-to-even exactly like the scalar ``round``, so
    host-plane per-edge quantization and device-plane batch seeding land
    on identical grid points — the single definition both planes share.
    """
    return np.ldexp(
        np.rint(np.ldexp(np.asarray(x, np.float64), _QUANT_BITS)), -_QUANT_BITS
    )


ESuspArrayFn = Callable[..., Any]  # (xp, src, dst, raw, in_deg_dst, aux) -> [E]
VSuspArrayFn = Callable[..., Any]  # (xp, ids, in_deg, aux) -> [V]


@dataclasses.dataclass(frozen=True)
class SuspSemantics:
    """A pluggable, engine-agnostic fraud-semantics definition.

    ``uses_degree`` declares that ``esusp`` reads ``in_deg_dst`` (FD-style
    column weighting): the streaming engines then maintain the arrival-time
    in-degree vector and resolve intra-batch arrival order; otherwise the
    (stale) stored degrees are passed and the update is elided from the
    tick program.  ``uses_aux`` declares that the hooks read ``aux``: the
    bundled services feed the transaction timestamp (base edges carry 0.0);
    planes without an aux channel (the host oracle's per-edge funnel) pass
    ``None`` — a semantics that *requires* aux is device-plane-only unless
    its hooks tolerate ``aux=None``.

    Instances are frozen and hashable by identity.
    """

    name: str
    esusp: ESuspArrayFn
    vsusp: VSuspArrayFn | None = None
    uses_degree: bool = False
    uses_aux: bool = False

    # -- the batch-seeding rule (host side, float64, snapped) ---------------

    def seed_base(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        raw: np.ndarray,
        n: int,
        aux: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Base-graph edge suspiciousness for a device-plane service.

        One definition shared by every service plane (single-device,
        mesh-sharded, workset), snapped to the dyadic grid at this boundary
        so stored weights cannot drift by an ulp between planes and weight
        ties stay exact ties.

        Degree-using semantics see the *loaded-graph* destination in-degree
        (the device plane seeds the whole base graph at once; per-arrival
        degrees start with the incremental stream via
        :meth:`batch_weights`).

        Returns ``(base_w float32 [m], in_deg int64 [n])`` — the in-degree
        vector doubles as the degree state the streaming ticks continue
        from.
        """
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        in_deg = np.zeros(n, np.int64)
        np.add.at(in_deg, dst, 1)
        raw64 = np.asarray(raw, np.float64)
        w = np.asarray(
            self.esusp(np, src, dst, raw64, in_deg[dst], aux), np.float64
        )
        w = np.broadcast_to(w, src.shape)
        # positive weights must stay positive through the snap
        w = np.maximum(quantize_susp_array(w), _QUANTUM)
        return w.astype(np.float32), in_deg

    def seed_vertices(
        self, n: int, in_deg: np.ndarray, aux: np.ndarray | None = None
    ) -> np.ndarray | None:
        """Vertex priors ``a_u`` for the base graph (snapped), or ``None``
        for the all-zero prior (lets services skip the buffer entirely)."""
        if self.vsusp is None:
            return None
        ids = np.arange(n, dtype=np.int64)
        a = np.asarray(self.vsusp(np, ids, np.asarray(in_deg, np.int64), aux),
                       np.float64)
        a = np.broadcast_to(a, (n,))
        if np.any(a < 0):
            raise ValueError(f"{self.name}: vsusp must be >= 0")
        return quantize_susp_array(a).astype(np.float32)

    # -- the streamed-tick rule (device side, torch) -----------------------

    def batch_weights(self, in_deg, src, dst, raw, valid, aux=None):
        """Weight one streamed batch on the batch's device.

        For ``uses_degree`` semantics each edge sees the destination degree
        *at its arrival* — stored degree plus earlier same-destination
        edges of the batch (exclusive running count, an exact integer
        B x B lower-triangle count) — and the degree vector advances by the
        batch.  Weights are raw float32; invalid lanes are zeroed.

        Returns ``(w float32 [B], new_in_deg)``.
        """
        if self.uses_degree:
            same = (dst[:, None] == dst[None, :]) & valid[None, :] & valid[:, None]
            earlier = torch.tril(same, diagonal=-1).sum(dim=1).to(torch.int32)
            deg = in_deg[dst] + earlier
            new_deg = scatter_drop(in_deg, dst, valid, valid.to(torch.int32),
                                   accumulate=True)
        else:
            deg = in_deg[dst]
            new_deg = in_deg
        w = self.esusp(_xp, src, dst, raw.to(torch.float32), deg, aux)
        w = torch.broadcast_to(torch.as_tensor(w, device=src.device), src.shape)
        w = torch.where(valid, w.to(torch.float32), 0.0)
        return w, new_deg

    # -- host-plane adapter -------------------------------------------------

    def host_metric(self):
        """Compile this semantics into the host oracle's per-edge form
        (a :class:`~repro_torch.core.metrics.DensityMetric`): scalar float64
        evaluation against the live :class:`AdjGraph`, snapped by the
        metric funnel.  The host plane has no aux channel — hooks receive
        ``aux = None``."""
        from .metrics import DensityMetric  # late: metrics imports this module

        sem = self

        def vsusp(u: int, g) -> float:
            if sem.vsusp is None:
                return 0.0
            deg = int(g.in_deg[u]) if u < g.n else 0
            out = sem.vsusp(np, np.asarray([u], np.int64),
                            np.asarray([deg], np.int64), None)
            return float(np.asarray(out, np.float64).reshape(-1)[0])

        def esusp(u: int, v: int, raw: float, g) -> float:
            deg = int(g.in_deg[v]) if v < g.n else 0
            out = sem.esusp(np, np.asarray([u], np.int64),
                            np.asarray([v], np.int64),
                            np.asarray([raw], np.float64),
                            np.asarray([deg], np.int64), None)
            return float(np.asarray(out, np.float64).reshape(-1)[0])

        return DensityMetric(name=sem.name, vsusp=vsusp, esusp=esusp)


# ---------------------------------------------------------------------------
# the registry: one table behind make_metric, the device seeding, and the
# service facade — registered names can never go stale in error messages
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, SuspSemantics] = {}


def register(sem: SuspSemantics, overwrite: bool = False) -> SuspSemantics:
    """Register a semantics under its (case-insensitive) name; returns it,
    so it doubles as a definition-site decorator-ish helper."""
    key = sem.name.upper()
    if key in _REGISTRY and not overwrite and _REGISTRY[key] is not sem:
        raise ValueError(f"semantics {sem.name!r} already registered")
    _REGISTRY[key] = sem
    return sem


def available() -> tuple[str, ...]:
    """Registered semantics names (sorted)."""
    return tuple(sorted(_REGISTRY))


def resolve(semantics: SuspSemantics | str) -> SuspSemantics:
    """Look up a semantics by name, or pass an instance through."""
    if isinstance(semantics, SuspSemantics):
        return semantics
    try:
        return _REGISTRY[str(semantics).upper()]
    except KeyError:
        raise KeyError(
            f"unknown semantics {semantics!r}; choose from "
            f"{'/'.join(available())} or pass a SuspSemantics"
        ) from None


# ---------------------------------------------------------------------------
# paper instances (Appendix F), registered
# ---------------------------------------------------------------------------

DG = register(SuspSemantics(
    name="DG",
    # Charikar [6]: unweighted — every transaction counts 1
    esusp=lambda xp, src, dst, raw, deg, aux: xp.ones_like(raw),
))

DW = register(SuspSemantics(
    name="DW",
    # Gudapati et al. [18]: transaction amount (clamped positive)
    esusp=lambda xp, src, dst, raw, deg, aux: xp.maximum(raw, 1e-12),
))

_FD_C = 5.0

FD = register(SuspSemantics(
    name="FD",
    # Fraudar (Hooi [19]) column weighting: 1/log(x + C), x the destination
    # degree at arrival time
    esusp=lambda xp, src, dst, raw, deg, aux: 1.0 / xp.log(deg + _FD_C),
    uses_degree=True,
))
