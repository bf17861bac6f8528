"""The train-step factory (port of ``repro/train/train_step.py``): the
gradient of the loss (optionally accumulated over microbatches), optional
int8 error-feedback gradient compression, then the AdamW update.

Gradients come from ``torch.autograd.grad`` over the leaves of
``state.params``; on the card the LM's forward runs through K3 and the
GCN's through K4, each an ``autograd.Function``.  Microbatches run in
order and accumulate in float32 as ``gsum + g.float() / microbatches``,
as the reference's ``lax.scan`` does.  Nothing here picks a device: the
step runs where the state and the batch are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch import pytree
from repro_torch.dist import sharding
from repro_torch.dist.compression import ef_compress_tree
from repro_torch.models.transformer import reference_groups
from repro_torch.train.optimizer import AdamConfig, TrainState, adamw_update

__all__ = ["make_train_step"]


def _grads(loss_fn, params, batch):
    """``(loss, metrics, grads)``, grads a list in the order of
    ``pytree.leaves(params)``.  A DTensor leaf's gradient comes back in
    the leaf's placements: a weight's from the backward of its FSDP
    gather (reduce-scattered), a replicated leaf's partial sums over the
    batch shards settled by one named redistribute (an all-reduce)."""
    leaves = pytree.leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        # a leaf the loss does not read gets zeros, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    grads = [sharding.redistribute(g, p.placements) if isinstance(g, DTensor) else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
                    adam: AdamConfig, *, microbatches: int = 1, compress: bool = False,
                    batch_logical: Any = None):
    """``loss_fn(params, batch) -> (scalar loss, metrics dict)``.

    Returns ``train_step(state, batch) -> (state', metrics)``; ``state'``
    holds ``state``'s params, moments and step, updated in place.  With
    ``microbatches > 1`` every batch leaf's leading dimension is split into
    that many microbatches and their gradients summed in float32 in order;
    the metrics are the last microbatch's, with ``loss`` (the
    microbatches' mean), ``grad_norm`` and ``lr``.  With ``compress`` the
    gradients go through
    :func:`~repro_torch.dist.compression.ef_compress_tree`, one scale per
    reference leaf (:func:`repro_torch.models.transformer.reference_groups`).

    Sharded (the state's leaves DTensors, :func:`repro_torch.launch.cells.
    shard_cell`, under ``use_axis_env``): ``batch`` is the whole batch,
    which every rank holds, and ``batch_logical`` names its leaves' dims;
    each microbatch (the reference's rows ``[i B / microbatches, (i + 1) B
    / microbatches)``) is placed by those names, every rank keeping its
    rows, with no collective.  Outside an env, or with ``batch_logical``
    None, the batch is used as it is.
    """

    def accumulate(params, batch):
        def split(x):
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(f"batch of {b} does not split into {microbatches} microbatches")
            return x.reshape(microbatches, b // microbatches, *x.shape[1:])

        mb = pytree.tree_map(split, batch)
        gsum, lsum = None, 0.0
        for i in range(microbatches):
            loss, metrics, grads = _grads(loss_fn, params,
                                          placed(pytree.tree_map(lambda x: x[i], mb), params))
            if gsum is None:
                gsum = [torch.zeros_like(g, dtype=torch.float32) for g in grads]
            gsum = [a + g.float() / microbatches for a, g in zip(gsum, grads)]
            lsum = lsum + loss / microbatches
        return lsum, metrics, gsum

    def placed(batch, params):
        if batch_logical is None or sharding.axis_env() is None or not isinstance(
                pytree.leaves(params)[0], DTensor):
            return batch
        return sharding.shard_tree(batch, batch_logical)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        fn = accumulate if microbatches > 1 else lambda p, b: _grads(loss_fn, p, placed(b, p))
        loss, metrics, flat = fn(state.params, batch)
        it = iter(flat)
        grads = pytree.tree_map(lambda _: next(it), state.params)
        if compress:
            grads, err = ef_compress_tree(grads, state.err, reference_groups(state.params))
            state = dataclasses.replace(state, err=err)
        state, opt_metrics = adamw_update(state, grads, adam)
        # a sharded step's scalars are whole on every rank: its local values
        return state, {k: v.to_local() if isinstance(v, DTensor) and all(
            p.is_replicate() for p in v.placements) else v
            for k, v in {"loss": loss, **metrics, **opt_metrics}.items()}

    return train_step
