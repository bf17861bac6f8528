"""Plain PyTorch versions of the flash-attention forward: the CPU path of
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` and the
yardsticks the CUDA kernel (K3) is held against on the card.

Layout ``[B, H, S, D]`` (any strides), as ``repro/kernels/flash_attention``.
Queries are left-aligned (query i sits at position i), masked scores are
-1e30, and the kv head of q head ``h`` is ``h // G``.

* :func:`attention_ref` is dense (the S x S scores in float32), a copy of
  ``repro/kernels/flash_attention/ref.py``.
* :func:`flash_attention_ref` is the blocked online softmax of
  ``repro/models/attention.py: flash_attention`` in float32, with memory
  bounded by one (q block, kv block) tile, so it also checks the kernel at
  long sequences.  Tiles masked for every row are skipped: such a tile adds
  exactly nothing after a row's first live key (``exp(-1e30 - m) = 0``),
  and before it the reference's correction ``exp(-1e30 - m) = 0`` wipes
  what it added, so skipping changes no result.
* :func:`flash_attention_bwd_ref` is the gradient of that function (dq,
  dk, dv) in float32, blocked over query rows: each block recomputes its
  probabilities over the keys it can see, so memory is one block's
  ``[B, Hq, block_q, keys]``.  ``repro`` trains through autodiff of its
  plain blocked attention and has no backward kernel; this is the port's
  form of that autodiff (the backward of K3's ``autograd.Function``).
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "flash_attention_ref", "flash_attention_bwd_ref"]

_NEG = -1e30


def _ok(q_pos, k_pos, causal, window, kv_len=None):
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        ok &= k_pos[None, :] < kv_len
    return ok


def attention_ref(q, k, v, *, causal=True, window=None):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D]."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / (D ** 0.5)
    dev = q.device
    ok = _ok(torch.arange(Sq, device=dev), torch.arange(Skv, device=dev), causal, window)
    s = torch.where(ok, s, torch.tensor(_NEG, dtype=torch.float32, device=dev))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=None, block_q=512,
                        block_k=1024):
    """Blocked online-softmax attention in float32.

    q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D] (contiguous,
    q's dtype).  Each output row is ``acc / max(l, 1e-30)``.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bq, bk = min(block_q, Sq), min(block_k, Skv)
    dev = q.device
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32, device=dev)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=dev)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    qg = q.reshape(B, Hkv, G, Sq, D)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        q_pos = torch.arange(q0, q1, device=dev)
        qi = qg[:, :, :, q0:q1].float()
        m = torch.full((B, Hkv, G, q1 - q0), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, q1 - q0, D), dtype=torch.float32, device=dev)
        for k0 in range(0, Skv, bk):
            k1 = min(k0 + bk, Skv)
            if causal and k0 > q1 - 1:
                break
            if window is not None and k1 - 1 <= q0 - window:
                continue
            ki = k[:, :, k0:k1].float()
            vi = v[:, :, k0:k1].float()
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, ki) * scale
            ok = _ok(q_pos, torch.arange(k0, k1, device=dev), causal, window)
            s = torch.where(ok, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vi)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, :, q0:q1] = o.reshape(B, Hq, q1 - q0, D).to(q.dtype)
    return out


def flash_attention_bwd_ref(q, k, v, do, *, causal=True, window=None, block_q=512):
    """The gradient of the attention at q: [B, Hq, Sq, D], k/v: [B, Hkv,
    Skv, D] with respect to each of them, given ``do`` (the output's
    gradient, q's shape): ``(dq, dk, dv)`` in the inputs' dtypes.

    Per block of ``block_q`` query rows, over the keys the block sees (no
    key past its last row when causal, none at or before its first row
    less the window): ``p = softmax(s)``, ``dv += p^T do``, ``dp = do
    v^T``, ``ds = p * (dp - rowsum(p * dp))``, ``dq = ds k / sqrt(D)``,
    ``dk += ds^T q / sqrt(D)``, the G q heads of a kv head summed into its
    dk and dv.  All in float32.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    scale = 1.0 / D ** 0.5
    qg = q.reshape(B, Hkv, G, Sq, D)
    dog = do.reshape(B, Hkv, G, Sq, D)
    kf, vf = k.float(), v.float()
    dq = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Hkv, Skv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        k0 = max(0, q0 - window + 1) if window is not None else 0
        k1 = min(Skv, q1) if causal else Skv
        if k1 <= k0:
            continue
        qi = qg[:, :, :, q0:q1].float()
        doi = dog[:, :, :, q0:q1].float()
        ki, vi = kf[:, :, k0:k1], vf[:, :, k0:k1]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qi, ki) * scale
        ok = _ok(torch.arange(q0, q1, device=dev), torch.arange(k0, k1, device=dev),
                 causal, window)
        p = torch.softmax(torch.where(ok, s, neg), dim=-1)
        del s
        dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", p, doi)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", doi, vi)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        del p, dp
        dq[:, :, :, q0:q1] = torch.einsum("bhgqk,bhkd->bhgqd", ds, ki) * scale
        dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qi) * scale
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
