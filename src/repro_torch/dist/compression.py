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

from repro_torch import pytree

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


def ef_compress_tree(grads, err=None, groups: dict | None = None):
    """EF compression over a gradient tree: ``(deq_tree, err_tree)``.

    ``err`` matches ``grads``' structure (None starts from zero residuals).
    ``groups`` maps a leaf's :func:`~repro_torch.pytree.keystr` path to the
    reference leaf it belongs to; leaves of one group share one scale.
    Leaves it does not name (or all, when None) are groups of their own.
    """
    items = pytree.leaves_with_path(grads)
    if err is None:
        errs = [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for _, g in items]
    else:
        errs = pytree.leaves(pytree.tree_map(lambda _, e: e, grads, err))
    keys = [pytree.keystr(p) for p, _ in items]
    group = [(groups or {}).get(k, k) for k in keys]
    peak: dict = {}
    for gk, (_, g), e in zip(group, items, errs):
        m = (g.float() + e.float()).abs().max()
        peak[gk] = m if gk not in peak else torch.maximum(peak[gk], m)
    out = {k: _compress(g, e, peak[gk] / 127.0)
           for k, gk, (_, g), e in zip(keys, group, items, errs)}
    it_deq = iter(out[k][0] for k in keys)
    it_err = iter(out[k][1] for k in keys)
    return (pytree.tree_map(lambda _: next(it_deq), grads),
            pytree.tree_map(lambda _: next(it_err), grads))
