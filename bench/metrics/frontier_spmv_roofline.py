"""frontier_spmv_roofline (layer: kernels): K2's share, in percent, of its
roofline over the traced stretch: the least time the round's edge half
needs (the larger of its bytes at the memory rate and its operations at
the float32 rate, a launch at a time) over the device time of the same
launches (``frontier_spmv_kernel``, from the profiler).

What a round needs, whatever kernel does it, for slots ``src``, ``dst``,
``c``, liveness ``alive`` and the round's peel mask ``peel``: every
slot's liveness byte read; both ends (int32) of each live slot; the
weight (float32) of each live slot with a peeled end (a hit) and its
liveness byte written back; the peel byte of each distinct end of a live
slot; one float32 sum written for each vertex that takes a contribution
(the other end of a hit with exactly one peeled end); the dropped mass.
Operations: an add a hit (the dropped mass) and an add a contribution.
The count is taken on the device during a replay of the traced ticks.
"""

import torch

ENTRIES = ("repro_torch.core.peel:frontier_spmv",)
KERNELS = ("frontier_spmv_kernel",)


def work(src, dst, c, alive, peel, dw):
    E, V = src.shape[0], peel.shape[0]
    ps, pd = peel[src.long()], peel[dst.long()]
    hit = alive & (ps | pd)
    to_dst, to_src = alive & ps & ~pd, alive & pd & ~ps
    targets = torch.zeros(V + 1, dtype=torch.bool, device=src.device)
    targets[torch.where(to_dst, dst.long(), V)] = True
    targets[torch.where(to_src, src.long(), V)] = True
    ends = torch.zeros(V + 1, dtype=torch.bool, device=src.device)
    ends[torch.where(alive, src.long(), V)] = True
    ends[torch.where(alive, dst.long(), V)] = True
    n_hit = hit.sum()
    nbytes = (E + 8 * alive.sum() + 5 * n_hit + ends[:V].sum() + 4 * targets[:V].sum() + 4)
    ops = n_hit + to_dst.sum() + to_src.sum()
    return nbytes, ops


def read(r):
    return r.roofline("frontier_spmv_roofline", KERNELS)
