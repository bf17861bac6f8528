"""Wrapper of the fused frontier SpMV (K2, ``csrc/frontier_spmv.cu``).

On CPU tensors it runs :func:`frontier_spmv_ref`; on CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches (not
CPU calls).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch
from .ref import frontier_spmv_ref

__all__ = ["frontier_spmv", "launches"]

launches = 0
_MAX_BLOCKS = 132 * 16  # two waves of 256-thread blocks on an H100


def frontier_spmv(src, dst, c, alive, peel):
    """Returns ``(dw [V] float32, drop_mass float32 scalar, alive' [E])``.

    ``src/dst`` int32 [E] endpoints in ``[0, V)``, ``c`` float32 [E],
    ``alive`` bool [E], ``peel`` bool [V] (the round's peel mask).
    """
    global launches
    dev = src.device
    if dev.type == "cpu":
        return frontier_spmv_ref(src, dst, c, alive, peel)
    if dev.type != "cuda":
        raise ValueError(f"frontier_spmv: unsupported device {dev}")
    E = src.shape[0]
    V = peel.shape[0]
    _launch.require(src, "src", torch.int32, dev, numel=E)
    _launch.require(dst, "dst", torch.int32, dev, numel=E)
    _launch.require(c, "c", torch.float32, dev, numel=E)
    _launch.require(alive, "alive", torch.bool, dev, numel=E)
    _launch.require(peel, "peel", torch.bool, dev, numel=V)
    dw = torch.zeros(V, dtype=torch.float32, device=dev)
    alive2 = torch.empty_like(alive)
    if E == 0:
        return dw, torch.zeros((), device=dev), alive2
    nb = _launch.n_blocks(E, _MAX_BLOCKS)
    partials = torch.empty(nb, dtype=torch.float32, device=dev)
    fn = _launch.function("frontier_spmv", "frontier_spmv_launch", 8)
    err = fn(src.data_ptr(), dst.data_ptr(), c.data_ptr(), alive.data_ptr(),
             peel.data_ptr(), dw.data_ptr(), alive2.data_ptr(),
             partials.data_ptr(), E, nb, _launch.stream_ptr(dev))
    _launch.check(err, "frontier_spmv_launch")
    launches += 1
    return dw, partials.sum(), alive2
