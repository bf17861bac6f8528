"""Plain PyTorch version of the round's edge half — exactly the
reference's ``segment_sum`` form of ``repro/core/peel.py:201-210``: two
scatter-adds, a masked sum and the liveness update (the CPU path of
:func:`repro_torch.kernels.frontier_spmv.ops.frontier_spmv`, and the
yardstick the CUDA kernel is held against)."""

from __future__ import annotations

import torch


def frontier_spmv_ref(src, dst, c, alive, peel):
    """Returns ``(dw [V], drop_mass, alive')`` for peel mask ``peel [V]``:
    ``dw[v]`` sums the live weight of edges with exactly one peeled end
    ``u != v``; ``drop_mass`` sums the live weight of edges with at least
    one peeled end; those edges leave ``alive``."""
    e_ps = peel[src]
    e_pd = peel[dst]
    cm = torch.where(alive, c, 0.0)
    hit = e_ps | e_pd
    drop_mass = torch.where(hit, cm, 0.0).sum()
    z = torch.zeros(peel.shape[0], dtype=torch.float32, device=c.device)
    dw = z.index_add(0, dst, torch.where(e_ps & ~e_pd, cm, 0.0)) + z.index_add(
        0, src, torch.where(e_pd & ~e_ps, cm, 0.0)
    )
    return dw, drop_mass, alive & ~hit
