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

On DTensors (the sharded serving cells) both run under
``torch.distributed.tensor.experimental.local_map``, each rank on its
shards: :func:`flash_attention` launches K3 on its local q (a block of
the sequence, with that block's offset into it as K3's ``q_offset``, or a
block of the q heads) over k and v gathered along the sequence by a named
redistribute; :func:`decode_attention` is flash-decode over a cache whose
slots are sharded: each rank's max, sum and weighted sum over its slots,
combined by one all-reduce of the max and one of the two sums, in
float32.  A layout these do not take raises.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.dist.sharding import all_reduce, redistribute, shard_span
from repro_torch.kernels.flash_attention import ops as fa_ops

__all__ = ["flash_attention", "decode_attention"]

_NEG = -1e30


def flash_attention(q, k, v, *, causal=True, window=None, q_block=512,
                    kv_block=1024):
    """Blocked online-softmax attention.

    q: [B, S, Hkv, G, D] (GQA groups folded in) or [B, S, Hq, D], k/v:
    [B, Skv, Hkv, D] -> q's shape.  q is read as the ``[B, Hq, S, D]`` view
    of ``[B, S, Hq, D]`` (q head ``h = kv * G + g``), k/v as ``[B, Hkv, Skv,
    D]`` views: nothing is copied or repeated per group.  ``q_block``/
    ``kv_block`` tile the plain CPU forward; ``q_block`` also tiles the
    backward.  DTensors: :func:`_sharded_flash_attention`.
    """
    if isinstance(q, DTensor):
        return _sharded_flash_attention(q, k, v, causal, window, q_block, kv_block)
    return _attention(q, k, v, causal, window, q_block, kv_block, 0)


def _attention(q, k, v, causal, window, q_block, kv_block, q_offset):
    B, S = q.shape[:2]
    D = q.shape[-1]
    qh = q.reshape(B, S, -1, D).permute(0, 2, 1, 3)
    o = fa_ops.FlashAttention.apply(qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                                    causal, window, q_block, kv_block, q_offset)
    return o.permute(0, 2, 1, 3).reshape(q.shape)


def _local_kv_heads(k, v, h0: int, n: int, G: int):
    """k/v [B, Skv, Hkv, D] cut to the kv heads of q heads [h0, h0 + n)
    (kv head ``h // G``): a slice of whole groups where the heads hold
    them, else one kv head a q head."""
    if h0 % G == 0 and n % G == 0:
        return k[:, :, h0 // G:(h0 + n) // G], v[:, :, h0 // G:(h0 + n) // G]
    if h0 // G == (h0 + n - 1) // G:
        return k[:, :, h0 // G:h0 // G + 1], v[:, :, h0 // G:h0 // G + 1]
    idx = torch.arange(h0, h0 + n, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def _sharded_flash_attention(q, k, v, causal, window, q_block, kv_block):
    """Each rank attends its q shard over whole k and v: q may be sharded
    on its batch dim, its sequence dim (dim 1: K3 gets the shard's offset
    as ``q_offset``) and, in the ``[B, S, Hq, D]`` layout, its heads (dim
    2: each rank takes the kv heads its q heads read).  k and v keep q's
    batch sharding and are gathered along everything else by one named
    redistribute each (an all-gather where they were sharded).  With a
    gradient (K3's Function, its plain backward), dq keeps q's placements
    and dk, dv are partial sums over the mesh dims that split q's heads or
    sequence (each rank's share, zero on the kv heads it does not read),
    which the backward of their gather reduce-scatters."""
    mesh = q.device_mesh
    for p in q.placements:
        if not (isinstance(p, Replicate) or (isinstance(p, Shard) and (
                p.dim in (0, 1) or (p.dim == 2 and q.dim() == 4)))):
            raise ValueError(f"flash_attention: q placements {q.placements} of shape "
                             f"{tuple(q.shape)}: the batch, the sequence or (as [B, S, Hq, D]) "
                             f"the heads may be sharded")
    kv_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
             for p in q.placements]
    k = redistribute(k, kv_pl)
    v = redistribute(v, kv_pl)
    q_offset = shard_span(q, 1)[0]
    h0, n = shard_span(q, 2) if q.dim() == 4 else (0, 0)
    G = q.shape[2] // k.shape[2] if q.dim() == 4 else 0

    # a rank that holds some of q's heads or rows reads k and v whole, and
    # its dk and dv are its share of their sums: partial over those dims
    kv_grad = [Partial() if isinstance(p, Shard) and p.dim in (1, 2) else k_p
               for p, k_p in zip(q.placements, kv_pl)]

    def local(ql, kl, vl):
        if G:
            kl, vl = _local_kv_heads(kl, vl, h0, n, G)
        return _attention(ql, kl, vl, causal, window, q_block, kv_block, q_offset)

    return local_map(local, out_placements=list(q.placements),
                     in_placements=(q.placements, kv_pl, kv_pl),
                     in_grad_placements=(q.placements, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


def decode_attention(q, k_cache, v_cache, pos, *, window=None, rolling=False):
    """One-token attention over a KV cache.

    q: [B, Hkv, G, D]; caches: [B, W, Hkv, D]; pos: [B] absolute position of
    the query token.  ``rolling`` caches store position t at slot t % W.
    DTensors: :func:`_sharded_decode_attention`.
    """
    if isinstance(q, DTensor):
        return _sharded_decode_attention(q, k_cache, v_cache, pos, window, rolling)
    return _decode(q, k_cache, v_cache, pos, window, rolling)


def _decode(q, k_cache, v_cache, pos, window, rolling):
    s, ok = _decode_scores(q, k_cache, pos, window, rolling, 0, k_cache.shape[1])
    s = s + torch.where(ok, 0.0, _NEG).float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v_cache.float()).to(q.dtype)


def _decode_scores(q, k_cache, pos, window, rolling, w0: int, W: int):
    """Scores [B, Hkv, G, n] of q against cache slots ``w0 .. w0 + n`` of a
    W-slot cache (``k_cache`` holds those n slots), and which are live."""
    n, D = k_cache.shape[1], k_cache.shape[-1]
    dev = q.device
    scale = (1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))).to(dev)
    slots = torch.arange(w0, w0 + n, device=dev)
    pos = pos.to(torch.int64)
    if rolling:
        # absolute position held by each slot given current pos p
        abs_pos = pos[:, None] - torch.remainder(pos[:, None] - slots[None, :], W)
    else:
        abs_pos = slots[None, :].expand(pos.shape[0], n)
    ok = (abs_pos >= 0) & (abs_pos <= pos[:, None])
    if window is not None:
        ok &= abs_pos > pos[:, None] - window
    return torch.einsum("bhgd,bshd->bhgs", q.float(), k_cache.float()) * scale, ok


def _sharded_decode_attention(q, k_cache, v_cache, pos, window, rolling):
    """Flash-decode: the caches' slot dim (1) may be sharded, their batch
    dim (0) sharded as q's and pos's; q holds every head on every rank.
    Each rank scores its slots; the row max is one all-reduce (max) over
    the mesh dims that shard the slots, and the softmax's sum beside the
    weighted sum of v one all-reduce (sum), in float32: ``o = sum_s
    exp(s - m) v / sum_s exp(s - m)``, the reference's softmax with its
    sums split by rank.  Where no mesh dim of more than one rank splits
    the slots, each rank runs the plain version on its (whole) caches."""
    mesh = q.device_mesh
    W = k_cache.shape[1]
    slot_dims = [i for i, p in enumerate(k_cache.placements)
                 if isinstance(p, Shard) and p.dim == 1]
    for t, name in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache")):
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and not (p.dim == 0 or (t is not q and i in slot_dims)):
                raise ValueError(f"decode_attention: {name} placements {t.placements}: only "
                                 f"the batch and the caches' slots may be sharded")
    if tuple(v_cache.placements) != tuple(k_cache.placements):
        raise ValueError(f"decode_attention: k_cache {k_cache.placements} and v_cache "
                         f"{v_cache.placements} are placed differently")
    w0 = shard_span(k_cache, 1)[0]
    groups = [(mesh, i) for i in slot_dims if mesh.size(i) > 1]

    def local(ql, kl, vl, pl):
        if not groups:
            return _decode(ql, kl, vl, pl, window, rolling)
        s, ok = _decode_scores(ql, kl, pl, window, rolling, w0, W)
        s = s + torch.where(ok, 0.0, _NEG).float()[:, None, None, :]
        m = all_reduce(s.amax(dim=-1, keepdim=True), "max", groups)
        p = torch.exp(s - m)
        acc = torch.einsum("bhgs,bshd->bhgd", p, vl.float())
        both = all_reduce(torch.cat([acc, p.sum(dim=-1, keepdim=True)], dim=-1), "sum",
                          groups)
        return (both[..., :-1] / both[..., -1:]).to(ql.dtype)

    return local_map(local, out_placements=list(q.placements),
                     in_placements=(q.placements, k_cache.placements, v_cache.placements,
                                    pos.placements), device_mesh=mesh)(q, k_cache, v_cache, pos)
