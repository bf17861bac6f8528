"""Array-namespace shim: lets ``SuspSemantics`` hooks written against
``xp`` (numpy-style calls) run on torch tensors.

Covers what the registered semantics and the README's time-decayed
example call: ``maximum`` with a Python scalar (which ``torch.maximum``
refuses), ``where``, ``log``, ``exp``, ``ones_like``, ``zeros_like`` and
``asarray``.  ``**`` and the arithmetic operators work on tensors as
they are.  A Python scalar becomes a 0-dim tensor of torch's default
dtype on the other operand's device, so ``maximum(f32, 1e-12)`` stays
float32, as ``jnp.maximum`` keeps it.
"""

from __future__ import annotations

import torch

log = torch.log
exp = torch.exp
ones_like = torch.ones_like
zeros_like = torch.zeros_like


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=like.device)


def _pair(a, b) -> tuple[torch.Tensor, torch.Tensor]:
    like = a if isinstance(a, torch.Tensor) else b
    if not isinstance(like, torch.Tensor):
        raise TypeError("xp: at least one operand must be a tensor")
    return _as_tensor(a, like), _as_tensor(b, like)


def maximum(a, b) -> torch.Tensor:
    return torch.maximum(*_pair(a, b))


def where(cond, a, b) -> torch.Tensor:
    return torch.where(cond, a, b)


def asarray(x, dtype=None, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)
