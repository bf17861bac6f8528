"""Shared neural building blocks of the LM (port of ``repro/models/layers.py``).

The f32 internals are those of the reference: ``rms_norm`` and
``apply_rope`` compute in float32 and cast back to the input's dtype;
``swiglu``'s matrix products stay in the weights' dtype.  ``maybe_scan``
has no counterpart (the model loops over its layers in Python), and the
reference's ``Initializer`` becomes :func:`normal_init` on an explicit
``torch.Generator``.

Each also runs on DTensors (:mod:`repro_torch.dist.sharding`), the last
dim sharded or not: ``rms_norm`` all-reduces its sum of squares over a
sharded hidden dim, ``apply_rope`` gathers a sharded head dim by a named
redistribute (its halves pair across shards) and puts it back, and
``swiglu`` all-reduces its gate and up products' partial sums (a
sharded input dim) before the activation.  On plain tensors nothing
changes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist.sharding import redistribute, replicate_as, settle

__all__ = ["rms_norm", "rope_angles", "apply_rope", "matmul", "swiglu", "normal_init"]


def _last_dim_sharded(x: torch.Tensor) -> bool:
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim % x.dim() == x.dim() - 1 for p in x.placements)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    if _last_dim_sharded(x):
        # each shard sums its part of the squares; one all-reduce adds them
        var = settle((x * x).sum(dim=-1, keepdim=True)) / x.shape[-1]
    else:
        var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def rope_angles(positions: torch.Tensor, d_head: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given absolute positions; shapes [..., d_head/2]."""
    half = d_head // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                     -ar / half)
    ang = positions.float()[..., None] * replicate_as(freq, positions)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (split-half convention).  x: [..., S, H, D]; cos/sin
    broadcastable to [..., S, 1, D/2]."""
    if _last_dim_sharded(x):
        # the halves pair across shards: gather the head dim, rotate, and
        # keep this rank's part again (a local slice)
        whole = [Replicate() if isinstance(p, Shard) and p.dim % x.dim() == x.dim() - 1
                 else p for p in x.placements]
        return redistribute(apply_rope(redistribute(x, whole), cos, sin), x.placements)
    cos, sin = replicate_as(cos, x), replicate_as(sin, x)
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``, through ``torch.mm`` where both are 2-D (the kernel that
    ``@`` calls for them, so the same bits): DTensor caches the sharding
    of ``mm``, but under inference mode works out that of ``matmul``
    anew at every call (torch 2.11), which took most of a sharded decode
    step's host time."""
    return torch.mm(a, b) if a.dim() == 2 and b.dim() == 2 else a @ b


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(settle(matmul(x, w_gate))) * settle(matmul(x, w_up))
    return matmul(h, w_down)


def normal_init(shape, fan_in: int, dtype: torch.dtype, device: torch.device,
                generator: torch.Generator) -> torch.Tensor:
    """Fan-in-scaled normal weights: ``N(0, 1) / sqrt(fan_in)`` drawn in
    float32 from ``generator`` (which must live on ``device``), cast to
    ``dtype``."""
    w = torch.randn(shape, dtype=torch.float32, device=device, generator=generator)
    return w.div_(math.sqrt(fan_in)).to(dtype)
