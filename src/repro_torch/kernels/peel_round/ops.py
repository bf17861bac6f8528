"""Wrapper of the fused peel-round kernel (K1, ``csrc/peel_round.cu``).

On CPU tensors it runs :func:`peel_round_ref`; on CUDA tensors it launches
the kernel or raises.  ``launches`` counts kernel launches (not CPU calls).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from .ref import peel_round_ref

__all__ = ["peel_round", "launches"]

launches = 0
_MAX_BLOCKS = 132 * 8  # one wave of 256-thread blocks on an H100


def peel_round(w, a, active, level, dw, thresh, round_):
    """Returns ``(w', active', level', peeled, partials[3])``.

    ``dw`` is the round's edge kernel's float64 [V] accumulator, rounded to
    float32 before the subtract and left all zero (ready for the peel's
    next round).
    ``thresh`` (float32) and ``round_`` (int32) are one-element tensors on
    the vertex arrays' device; on CUDA the kernel reads them by pointer, so
    the host never waits for them.
    """
    global launches
    dev = w.device
    if dev.type == "cpu":
        return peel_round_ref(w, a, active, level, dw, thresh, round_)
    if dev.type != "cuda":
        raise ValueError(f"peel_round: unsupported device {dev}")
    V = w.shape[0]
    for t, name, dt in ((w, "w", torch.float32), (a, "a", torch.float32),
                        (active, "active", torch.bool), (level, "level", torch.int32),
                        (dw, "dw", torch.float64)):
        _launch.require(t, name, dt, dev, numel=V)
    _launch.require(thresh, "thresh", torch.float32, dev, numel=1)
    _launch.require(round_, "round_", torch.int32, dev, numel=1)
    w2 = torch.empty_like(w)
    active2 = torch.empty_like(active)
    level2 = torch.empty_like(level)
    peeled = torch.empty_like(active)
    if V == 0:
        return w2, active2, level2, peeled, torch.zeros(3, device=dev)
    nb = _launch.n_blocks(V, _MAX_BLOCKS)
    partials = torch.empty((nb, 3), dtype=torch.float32, device=dev)
    fn = _launch.bind("peel_round", "peel_round_launch",
                      [ctypes.c_void_p] * 12 + [ctypes.c_int64, ctypes.c_int,
                                                 ctypes.c_void_p])
    err = fn(w.data_ptr(), a.data_ptr(), active.data_ptr(), level.data_ptr(),
             dw.data_ptr(), thresh.data_ptr(), round_.data_ptr(),
             w2.data_ptr(), active2.data_ptr(), level2.data_ptr(),
             peeled.data_ptr(), partials.data_ptr(), V, nb, _launch.stream_ptr(dev))
    _launch.check(err, "peel_round_launch")
    launches += 1
    return w2, active2, level2, peeled, partials.sum(0)
