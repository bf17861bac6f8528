"""Host-plane density metrics: the per-edge compiled form of a semantics.

A *density metric* is ``g(S) = f(S)/|S|`` with
``f(S) = Σ a_i + Σ c_ij`` (Eq. 1).  Spade supports any metric expressible
through two user hooks (Property 3.1: arithmetic density, ``a_i ≥ 0``,
``c_ij > 0``):

* ``vsusp(u, graph) -> a_u``   — vertex suspiciousness (prior/side info)
* ``esusp(u, v, graph) -> c``  — edge suspiciousness, evaluated at edge
  arrival time (the paper's C++ snippet reads the live degree, so e.g.
  Fraudar's column weighting uses the destination degree *at insertion*).

The port's copy of ``repro.core.metrics``.  It is a **thin adapter** over
the pluggable semantics plane (:mod:`repro_torch.core.semantics`): the
canonical DG/DW/FD definitions live there as
:class:`~repro_torch.core.semantics.SuspSemantics` instances (one
definition compiled into every engine), and the host-plane objects below
are their :meth:`~repro_torch.core.semantics.SuspSemantics.host_metric`
projections.  ``DensityMetric`` remains the host oracle's per-edge funnel:
scalar evaluation plus the dyadic-grid snap (the quantization boundary —
see semantics.py for the determinism rationale).

One registry backs everything: :func:`make_metric` resolves through
``semantics.resolve``, so its error message can never drift from the set
of semantics the device planes accept.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .reference import AdjGraph
from .semantics import (
    _QUANTUM,
    SuspSemantics,
    quantize_susp,
    quantize_susp_array,
    resolve,
)
from .semantics import DG as DG_SEMANTICS
from .semantics import DW as DW_SEMANTICS
from .semantics import FD as FD_SEMANTICS

__all__ = ["DensityMetric", "DG", "DW", "FD", "make_fd", "make_metric",
           "quantize_susp", "quantize_susp_array"]

VSuspFn = Callable[[int, AdjGraph], float]
ESuspFn = Callable[[int, int, float, AdjGraph], float]


@dataclass(frozen=True)
class DensityMetric:
    """A host-plane fraud-semantics definition (the paper's VSusp/ESusp pair).

    ``esusp`` receives ``(src, dst, raw_weight, graph)`` where ``raw_weight``
    is the application payload on the transaction (e.g. amount); it must
    return a strictly positive suspiciousness.  ``vsusp`` receives
    ``(vertex, graph)`` and must return a nonnegative prior.
    """

    name: str
    vsusp: VSuspFn
    esusp: ESuspFn

    def vertex_susp(self, u: int, g: AdjGraph) -> float:
        a = float(self.vsusp(u, g))
        if a < 0:
            raise ValueError(f"{self.name}: vsusp must be >= 0, got {a}")
        return quantize_susp(a)

    def edge_susp(self, u: int, v: int, raw: float, g: AdjGraph) -> float:
        c = float(self.esusp(u, v, raw, g))
        if c <= 0:
            raise ValueError(f"{self.name}: esusp must be > 0, got {c}")
        # positive weights must stay positive through the snap
        return max(quantize_susp(c), _QUANTUM)


# ---------------------------------------------------------------------------
# Paper instances (host projections of the registered semantics)
# ---------------------------------------------------------------------------

DG = DG_SEMANTICS.host_metric()
DW = DW_SEMANTICS.host_metric()


def make_fd(vertex_prior: Callable[[int], float] | None = None) -> DensityMetric:
    """Fraudar with an optional per-vertex side-information prior."""
    base = FD_SEMANTICS.host_metric()
    if vertex_prior is None:
        return base
    return DensityMetric(
        name="FD",
        vsusp=lambda u, g: float(vertex_prior(u)),
        esusp=base.esusp,
    )


FD = make_fd()


def make_metric(
    metric: DensityMetric | SuspSemantics | str,
) -> DensityMetric:
    """Resolve a metric/semantics spec to the host-plane compiled form.

    Accepts a registered semantics name (``"DG"``/``"DW"``/``"FD"``/any
    user-registered name, case-insensitive), a :class:`SuspSemantics`
    (compiled via its host adapter), or a ready ``DensityMetric`` (passed
    through).  The name lookup and the error message both come from the
    single semantics registry, shared with the device-plane seeding.
    """
    if isinstance(metric, DensityMetric):
        return metric
    return resolve(metric).host_metric()
