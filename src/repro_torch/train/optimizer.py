"""AdamW and the training state (port of ``repro/train/optimizer.py``).

:class:`TrainState` holds ``params``, ``m``, ``v``, ``step`` and ``err``
as the reference's does.  ``params`` is the tree the loss reads, in the
port's own layout: an LM's :class:`~repro_torch.models.TransformerLM`
module (one tensor a layer; ``m``, ``v`` and ``err`` are then dicts keyed
by its parameter names), or a tree of tensors such as a GNN's
``GNN.params()``, which is keyed as the reference's pytree is.
:mod:`repro_torch.convert` maps an LM's state to the reference's stacked
layout and back (``train_state_to_numpy``, ``train_state_from_numpy``).
``step`` is a 0-d int32 tensor on the parameters' device.

The update is the reference's, in float32, leaf by leaf: the gradient
clipped by ``min(1, clip / (|g| + 1e-9))``, the moments, the bias
corrections ``1 - b ** step`` on a float32 step, ``delta = mh / (sqrt(vh)
+ eps) + wd * p`` and ``p - lr * delta`` cast back to the parameter's
dtype.  It is not ``torch.optim.AdamW`` (which decays before the step and
arranges the bias correction otherwise).  It runs **in place**, over
chunks of :data:`CHUNK` elements of a leaf, so the temporaries of one
update stay a few hundred MB whatever the leaf's size; the state passed
in is the state returned, updated (the reference donates it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch import pytree
from repro_torch.dist import sharding

__all__ = ["AdamConfig", "TrainState", "init_train_state", "adamw_update", "global_norm",
           "cosine_lr", "CHUNK"]

CHUNK = 1 << 25  # elements of a leaf updated at once (float32 temporaries of 128 MB)


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    m: Any
    v: Any
    step: torch.Tensor
    err: Any = None  # gradient-compression error-feedback buffers (optional)


def init_train_state(params: Any, with_error_feedback: bool = False) -> TrainState:
    """Zero float32 moments (and residuals) beside ``params``, step 0: a
    DTensor parameter's in its placements (each rank allocating its
    shard).  ``step`` is a plain tensor, which every rank holds."""
    first = pytree.leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p.detach(), dtype=torch.float32,
                                       memory_format=torch.contiguous_format)
    return TrainState(
        params=params,
        m=pytree.tree_map(zeros, params),
        v=pytree.tree_map(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        err=pytree.tree_map(zeros, params) if with_error_feedback else None,
    )


def _chunks(t: torch.Tensor):
    """Views of ``CHUNK`` elements of a contiguous tensor, in order."""
    flat = t.view(-1)
    return (flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK))


def global_norm(tree: Any) -> torch.Tensor:
    """``sqrt(sum of squares)`` of every leaf, in float32.

    On DTensor leaves each rank sums the squares of its shards, then one
    all-reduce over the mesh dims that shard some leaf adds the ranks'
    sums; a leaf whole along one of those dims is counted by the ranks at
    coordinate 0 along it only, so once.  Plain leaves, or no mesh dim
    splitting any: the unsharded sum, in the same order."""
    import torch.distributed._functional_collectives as funcol

    xs = pytree.leaves(tree)
    dims = sorted({i for x in xs for i in sharding.split_dims(x)})
    mesh = next((x.device_mesh for x in xs if isinstance(x, DTensor)), None)
    coord = mesh.get_coordinate() if dims else None
    total = 0
    for x in xs:
        if any(coord[i] for i in dims if i not in sharding.split_dims(x)):
            continue  # another rank counts this leaf's copy
        total = total + sum(torch.sum(torch.square(c.float()))
                            for c in _chunks(sharding.local(x.detach())))
    if dims:
        if not isinstance(total, torch.Tensor):
            total = torch.zeros((), dtype=torch.float32, device=sharding.local(xs[0]).device)
        total = funcol.wait_tensor(funcol.all_reduce(total, "sum",
                                                     sharding.mesh_group(mesh, dims)))
    return torch.sqrt(total)


def cosine_lr(cfg: AdamConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine to 0 at ``total_steps``."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def _update(p, g, m, v, scale, lr, bc1, bc2, cfg: AdamConfig) -> None:
    """One chunk of the reference's ``upd``, in place, in its order of
    operations (each product and sum rounded where the reference rounds)."""
    g = g.float() * scale
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    gg = g * (1 - cfg.b2)
    v.mul_(cfg.b2).add_(gg.mul_(g))
    den = (v / bc2).sqrt_().add_(cfg.eps)
    delta = (m / bc1).div_(den)
    pf = p.float()
    delta.add_(pf * cfg.weight_decay)
    p.copy_(pf - lr * delta)


@torch.no_grad()
def adamw_update(state: TrainState, grads: Any, cfg: AdamConfig
                 ) -> tuple[TrainState, dict]:
    """One AdamW step, in place: ``(state, {"grad_norm", "lr"})``.
    ``grads`` has ``state.params``' structure (a module's as the dict of
    its parameter names).  DTensor leaves: the gradient, ``m`` and ``v``
    placed as their parameter, each rank updating its shards (the same
    chunks, in the same order of roundings), with the clip's norm summed
    over the ranks (:func:`global_norm`); ``step`` plain."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state.step.add_(1)
    lr = cosine_lr(cfg, state.step)
    sf = state.step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, sf)
    bc2 = 1.0 - torch.pow(cfg.b2, sf)
    paths = [p for p, _ in pytree.leaves_with_path(state.params)]
    for name, tree in (("grads", grads), ("m", state.m), ("v", state.v)):
        if [p for p, _ in pytree.leaves_with_path(tree)] != paths:
            raise ValueError(f"adamw_update: {name} does not match the params' structure")
    for path, p, g, m, v in zip(paths, pytree.leaves(state.params), pytree.leaves(grads),
                                pytree.leaves(state.m), pytree.leaves(state.v)):
        if isinstance(p, DTensor):
            for name, t in (("grads", g), ("m", m), ("v", v)):
                if not isinstance(t, DTensor) or tuple(t.placements) != tuple(p.placements):
                    raise ValueError(f"adamw_update: {name} {pytree.keystr(path)} is not "
                                     f"placed as its parameter ({p.placements})")
        p, g, m, v = (sharding.local(t) for t in (p, g, m, v))
        g = g.contiguous()
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m), _chunks(v)):
            _update(pc, gc, mc, vc, scale, lr, bc1, bc2, cfg)
    return state, {"grad_norm": gnorm, "lr": lr}
