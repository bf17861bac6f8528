"""Plain PyTorch versions of K2's two entries (the CPU paths of
:mod:`repro_torch.kernels.frontier_spmv.ops`, and the yardsticks the CUDA
kernels are held against).

* :func:`frontier_spmv_ref` — the reference's ``segment_sum`` form of the
  round's edge half (``repro/core/peel.py:201-210``): two float32
  scatter-adds, a masked sum and the liveness update, which it makes in
  place as the kernel does; ``dw`` comes in the kernel's float64
  accumulator, which holds the float32 sums exactly, so the round's
  float32 ``dw`` is the reference's.
* :func:`suffix_init_ref` — the warm peel's prologue
  (``repro/core/peel.py:324-329``), the induced weights of the restricted
  set.
"""

from __future__ import annotations

import torch


def frontier_spmv_ref(src, dst, c, alive, peel, dw):
    """Returns ``(dw [V], drop_mass)`` for peel mask ``peel [V]``:
    ``dw[v]`` sums the live weight of edges with exactly one peeled end
    ``u != v``; ``drop_mass`` sums the live weight of edges with at least
    one peeled end; those edges leave ``alive``, which is updated in place
    (``alive &= ~hit``).  The float32 sums are added into ``dw``, a float64
    accumulator holding zeros."""
    e_ps = peel[src]
    e_pd = peel[dst]
    cm = torch.where(alive, c, 0.0)
    hit = e_ps | e_pd
    drop_mass = torch.where(hit, cm, 0.0).sum()
    z = torch.zeros(peel.shape[0], dtype=torch.float32, device=c.device)
    sums = z.index_add(0, dst, torch.where(e_ps & ~e_pd, cm, 0.0)) + z.index_add(
        0, src, torch.where(e_pd & ~e_ps, cm, 0.0)
    )
    alive &= ~hit
    dw += sums
    return dw, drop_mass


def suffix_init_ref(src, dst, c, edge_mask, live, a, acc=None):
    """Returns ``(w0 [V], f0, both [E])`` of the vertex set ``live``:
    ``both`` marks the live edges with both ends in it, ``w0[v]`` is
    ``a[v]`` plus the weight of its ``both`` edges (``v`` in ``live``, else
    0) and ``f0`` is the set's total weight.

    The float64 mode (``acc``, float64 [V + 1]) writes the weight of each
    vertex's ``both`` edges, summed in float64, into ``acc[:V]`` and the
    float32 sum of the ``both``-masked ``c`` into ``acc[V]``, and returns
    ``(acc, the float32 sum of where(live, a, 0), both)``."""
    both = live[src] & live[dst] & edge_mask
    cm = torch.where(both, c, 0.0)
    if acc is not None:
        V = live.shape[0]
        cm64 = cm.to(torch.float64)
        acc.zero_()
        acc[:V].index_add_(0, src, cm64).index_add_(0, dst, cm64)
        acc[V] = cm.sum()
        return acc, torch.where(live, a, 0.0).sum(), both
    w0 = torch.where(live, a, 0.0)
    z = torch.zeros_like(w0)
    w0 = (w0 + z.index_add(0, src, cm)) + z.index_add(0, dst, cm)
    f0 = torch.where(live, a, 0.0).sum() + cm.sum()
    return w0, f0, both
