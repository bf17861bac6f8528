"""Spade on PyTorch: the host plane of ``repro`` (the paper's Listing-1
``Spade`` API over the exact NumPy oracle), its device-plane streaming
engine and the serving half of its dense LMs and GNNs (``models/``,
``configs/``), with the device kernels ported to CUDA for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``graphstore/structs.py`` <->
``repro/graphstore/structs.py`` and so on) and imports neither ``jax`` nor
anything of ``repro``.  Device-plane entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a GPU and without that argument they
raise.  On CPU tensors each hand-written kernel is replaced by its plain
PyTorch version (``kernels/*/ref.py``); on CUDA tensors the kernel runs.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
