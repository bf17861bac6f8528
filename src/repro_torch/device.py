"""Device resolution for the port's entry points.

The default is ``cuda``.  When no GPU is present and the caller did not
ask for the CPU, :func:`resolve_device` raises: the port never carries on
on the CPU in place of a GPU it was meant to use.  ``meta`` (shapes and
dtypes with no data, what the dry run traces) is taken only when the
caller names it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` and ``"meta"`` only when asked; raise
    if CUDA is requested (explicitly or by default) and unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
