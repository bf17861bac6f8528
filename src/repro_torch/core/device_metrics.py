"""DEPRECATED device-plane weighting helpers (legacy ``metric: str`` API;
port of ``repro/core/device_metrics.py``).

Every weight below delegates to the registered
:class:`repro_torch.core.semantics.SuspSemantics` instances, whose
``seed_base``/``batch_weights`` are the one definition every engine runs.
These wrappers exist only so legacy callers keep working; new code uses
the semantics object directly (``semantics=DW`` on
:class:`repro_torch.serve.SpadeService`, or ``sem.batch_weights(...)``).
Each call emits a :class:`~repro_torch._warnings.SpadeDeprecationWarning`.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch._warnings import SpadeDeprecationWarning
from repro_torch.core import semantics as _sem
from repro_torch.core import xp as _xp

__all__ = ["dg_weights", "dw_weights", "fd_weights", "fd_batch_weights",
           "seed_base_weights"]


def _warn(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} (repro_torch.core.semantics)",
        SpadeDeprecationWarning,
        stacklevel=3,
    )


def _paper_c(C: float) -> None:
    if C != 5.0:
        raise ValueError("legacy shim supports only the paper's C = 5.0")


def seed_base_weights(
    metric: str,
    src: np.ndarray,
    dst: np.ndarray,
    amt: np.ndarray,
    n: int,
    C: float = 5.0,
) -> tuple[np.ndarray, np.ndarray]:
    """DEPRECATED: ``resolve(metric).seed_base(...)``, the registry's
    batch-seeding rule (identical output, including the dyadic snap)."""
    _warn("seed_base_weights(metric=...)", "SuspSemantics.seed_base")
    _paper_c(C)
    return _sem.resolve(metric).seed_base(src, dst, amt, n)


def dg_weights(amounts: torch.Tensor) -> torch.Tensor:
    """DEPRECATED: DG semantics, every transaction counts 1."""
    _warn("dg_weights", "semantics.DG")
    return _sem.DG.esusp(_xp, None, None, amounts.to(torch.float32), None, None)


def dw_weights(amounts: torch.Tensor) -> torch.Tensor:
    """DEPRECATED: DW semantics, the transaction amount (clamped positive)."""
    _warn("dw_weights", "semantics.DW")
    return _sem.DW.esusp(_xp, None, None, amounts.to(torch.float32), None, None)


def fd_weights(in_deg_dst: torch.Tensor, C: float = 5.0) -> torch.Tensor:
    """DEPRECATED: FD column weighting given destination in-degrees."""
    _warn("fd_weights", "semantics.FD")
    _paper_c(C)
    return _sem.FD.esusp(_xp, None, None, None, in_deg_dst, None)


def fd_batch_weights(
    in_deg: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor, C: float = 5.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """DEPRECATED: ``FD.batch_weights``, the arrival-time degree weighting
    of one batch (identical output)."""
    _warn("fd_batch_weights", "SuspSemantics.batch_weights")
    _paper_c(C)
    zeros = torch.zeros(dst.shape[0], dtype=torch.float32, device=dst.device)
    return _sem.FD.batch_weights(in_deg, dst, dst, zeros, valid)
