"""Error-feedback int8 gradient compression (port of
``repro/dist/compression.py``): the wire format of a compressed gradient
all-reduce.

    deq, err' = EF(g, err):   x = g + err
                              q = round(x / s) in int8,  s = max|x| / 127
                              deq = q * s;   err' = x - deq

The residual ``err'`` is re-injected before the next quantization, so the
running sum of the dequantized gradients tracks the true one to within one
quantum.  ``torch.round`` rounds half to even, as ``jnp.round`` does, so on
equal inputs ``q``, the scale, ``deq`` and ``err'`` are the reference's bit
for bit.

The scale is one ``max|x|`` per *reference leaf*.  The reference stacks an
LM's layers into ``[L, ...]`` leaves, where the port holds one tensor a
layer; :func:`ef_compress_tree` takes ``groups`` (a leaf's key to its
reference leaf, :func:`repro_torch.models.transformer.reference_groups`) and gives the
tensors of one group one scale, the largest ``|x|`` over all of them.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch import pytree
from repro_torch.dist.sharding import local, mesh_group, split_dims

__all__ = ["quantize_int8", "dequantize_int8", "compress_grads", "ef_compress_tree"]


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    safe = torch.where(scale > 0.0, scale, 1.0)
    return torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: ``(q int8, scale f32)``."""
    x = x.float()
    scale = x.abs().max() / 127.0
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _compress(g: torch.Tensor, err: torch.Tensor, scale: torch.Tensor | None = None):
    x = g.float() + err.float()
    if scale is None:
        scale = x.abs().max() / 127.0
    deq = dequantize_int8(_quantize(x, scale), scale)
    return deq.to(g.dtype), x - deq


def compress_grads(g: torch.Tensor, err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One EF step on one tensor: ``(deq in g's dtype, err' float32)``."""
    return _compress(g, err)


def _peaks_over_ranks(peak: dict, leaves: list) -> dict:
    """Each group's ``max|x|`` over its shards on every rank: one
    all-reduce (max) of the groups' local peaks over the mesh dims that
    shard some leaf (a max is exact in any order,
    and a copy counted twice changes nothing).  No such dim: ``peak``."""
    import torch.distributed._functional_collectives as funcol

    mesh = next((x.device_mesh for x in leaves if isinstance(x, DTensor)), None)
    dims = sorted({i for x in leaves for i in split_dims(x)})
    if not dims:
        return peak
    keys = list(peak)
    local = torch.stack([peak[k] for k in keys])
    whole = funcol.wait_tensor(funcol.all_reduce(local, "max", mesh_group(mesh, dims)))
    return dict(zip(keys, whole.unbind()))


def _sharded(fn, g: torch.Tensor, e: torch.Tensor, scale: torch.Tensor):
    """``fn(g, e, scale)`` on this rank's shards of DTensor ``g`` and
    ``e`` (placed alike), its outputs in their placements; plain tensors
    as they are."""
    if not isinstance(g, DTensor):
        return fn(g, e, scale)
    if not isinstance(e, DTensor) or tuple(e.placements) != tuple(g.placements):
        raise ValueError(f"ef_compress_tree: a residual is not placed as its gradient "
                         f"({g.placements})")
    wrap = lambda t: DTensor.from_local(t, g.device_mesh, g.placements, run_check=False,
                                        shape=g.shape, stride=g.stride())
    return tuple(wrap(t) for t in fn(g.to_local(), e.to_local(), scale))


def ef_compress_tree(grads, err=None, groups: dict | None = None):
    """EF compression over a gradient tree: ``(deq_tree, err_tree)``.

    ``err`` matches ``grads``' structure (None starts from zero residuals).
    ``groups`` maps a leaf's :func:`~repro_torch.pytree.keystr` path to the
    reference leaf it belongs to; leaves of one group share one scale.
    Leaves it does not name (or all, when None) are groups of their own.
    DTensor leaves (a sharded step's gradients, placed as their
    parameters): ``err`` placed alike, each rank compressing its shards
    with its group's scale, the peak all-reduced (max) over the shards.
    """
    items = pytree.leaves_with_path(grads)
    if err is None:
        errs = [torch.zeros_like(g, dtype=torch.float32, memory_format=torch.contiguous_format)
                for _, g in items]
    else:
        errs = pytree.leaves(pytree.tree_map(lambda _, e: e, grads, err))
    keys = [pytree.keystr(p) for p, _ in items]
    group = [(groups or {}).get(k, k) for k in keys]
    peak: dict = {}
    for gk, (_, g), e in zip(group, items, errs):
        m = (local(g).float() + local(e).float()).abs().max()
        peak[gk] = m if gk not in peak else torch.maximum(peak[gk], m)
    peak = _peaks_over_ranks(peak, [g for _, g in items])
    out = {k: _sharded(_compress, g, e, peak[gk] / 127.0)
           for k, gk, (_, g), e in zip(keys, group, items, errs)}
    it_deq = iter(out[k][0] for k in keys)
    it_err = iter(out[k][1] for k in keys)
    return (pytree.tree_map(lambda _: next(it_deq), grads),
            pytree.tree_map(lambda _: next(it_err), grads))
