"""Argument checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

THREADS = 256  # spade::kThreads in csrc/common.cuh
_bound: dict[str, ctypes._CFuncPtr] = {}


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, numel: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (with ``numel`` elements, when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: {t.numel()} elements, expected {numel}")


def n_blocks(n: int, max_blocks: int) -> int:
    return max(1, min(-(-n // THREADS), max_blocks))


def bind(stem: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C launcher ``symbol`` of ``csrc/<stem>.cu`` with ``argtypes``,
    returning an ``int`` (a ``cudaError_t``)."""
    if symbol not in _bound:
        fn = getattr(_build.load(stem), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[symbol] = fn
    return _bound[symbol]


def check(err: int, symbol: str) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
