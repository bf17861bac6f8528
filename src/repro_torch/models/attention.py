"""Attention of the LM (port of ``repro/models/attention.py``): the
blocked causal / sliding-window GQA forward and the KV-cache decode.

:func:`flash_attention` takes the model layout and hands strided views to
K3's ``autograd.Function``
(:class:`repro_torch.kernels.flash_attention.ops.FlashAttention`): K3 on
CUDA tensors (its tensor-core body for bf16 at head dims 64 and 128, its
SIMT body for the rest), its plain version on CPU tensors, and the plain
blocked gradient in the backward.  Queries are
left-aligned (query i at position i) there, as in the reference.
:func:`decode_attention` is plain PyTorch, as it is plain jnp in the
reference.  The reference's right-aligned ``dense_attention`` has no
caller on this path; the dense oracle is
:func:`repro_torch.kernels.flash_attention.attention_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

__all__ = ["flash_attention", "decode_attention"]

_NEG = -1e30


def flash_attention(q, k, v, *, causal=True, window=None, q_block=512,
                    kv_block=1024):
    """Blocked online-softmax attention.

    q: [B, S, Hkv, G, D] (GQA groups folded in), k/v: [B, Skv, Hkv, D] ->
    [B, S, Hkv, G, D].  q is read as the ``[B, Hq, S, D]`` view of
    ``[B, S, Hq, D]`` (q head ``h = kv * G + g``), k/v as ``[B, Hkv, Skv, D]``
    views: nothing is copied or repeated per group.  ``q_block``/``kv_block``
    tile the plain CPU forward; ``q_block`` also tiles the backward.
    """
    B, S, Hkv, G, D = q.shape
    qh = q.reshape(B, S, Hkv * G, D).permute(0, 2, 1, 3)
    o = fa_ops.FlashAttention.apply(qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                                    causal, window, q_block, kv_block)
    return o.permute(0, 2, 1, 3).reshape(B, S, Hkv, G, D)


def decode_attention(q, k_cache, v_cache, pos, *, window=None, rolling=False):
    """One-token attention over a KV cache.

    q: [B, Hkv, G, D]; caches: [B, W, Hkv, D]; pos: [B] absolute position of
    the query token.  ``rolling`` caches store position t at slot t % W.
    """
    B, W, Hkv, D = k_cache.shape
    dev = q.device
    scale = (1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))).to(dev)
    slots = torch.arange(W, device=dev)
    pos = pos.to(torch.int64)
    if rolling:
        # absolute position held by each slot given current pos p
        abs_pos = pos[:, None] - torch.remainder(pos[:, None] - slots[None, :], W)
    else:
        abs_pos = slots[None, :].expand(B, W)
    ok = (abs_pos >= 0) & (abs_pos <= pos[:, None])
    if window is not None:
        ok &= abs_pos > pos[:, None] - window
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k_cache.float()) * scale
    s = s + torch.where(ok, 0.0, _NEG).float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v_cache.float()).to(q.dtype)
