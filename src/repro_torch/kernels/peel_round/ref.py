"""Plain PyTorch version of the fused peel-round update (the CPU path of
:func:`repro_torch.kernels.peel_round.ops.peel_round`, and the yardstick
the CUDA kernel is held against)."""

from __future__ import annotations

import torch


def peel_round_ref(w, a, active, level, dw, thresh, round_):
    """Returns ``(w', active', level', peeled, partials[3])`` with partials
    ``[sum(peeled a), sum(peeled w), n_peeled]`` (pre-update ``w``).  The
    float64 accumulator ``dw`` is rounded to float32 and left all zero."""
    peeled = active & (w <= thresh)
    w2 = w - dw.to(torch.float32)
    dw.zero_()
    active2 = active & ~peeled
    level2 = torch.where(peeled, round_, level)
    pf = peeled.to(torch.float32)
    partials = torch.stack([(pf * a).sum(), (pf * w).sum(), pf.sum()])
    return w2, active2, level2, peeled, partials
