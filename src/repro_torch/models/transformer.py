"""Decoder-only transformer LM, serving half (port of
``repro/models/transformer.py``): GQA attention with optional qk-norm and
sliding window, dense SwiGLU FFN, and two entry points:

* :func:`prefill`      — forward over a prompt + KV-cache construction
* :func:`decode_step`  — one token against a (rolling) KV cache

Prefill attention goes through :func:`repro_torch.models.attention.flash_attention`
(the K3 kernel on CUDA, its plain version on the CPU); decode attention is
plain PyTorch, as it is plain jnp in the reference.  Parameters keep the
reference's ``x @ w`` layout, one :class:`DecoderLayer` per layer in place
of the reference's stacked ``[L, ...]`` leaves (:mod:`repro_torch.convert`
carries them across).  ``forward``/``lm_loss`` and the MoE FFN belong to the
training slice and are not here yet (ROADMAP A.11).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.layers import apply_rope, normal_init, rms_norm, rope_angles, swiglu

__all__ = ["KVCache", "cache_window", "DecoderLayer", "TransformerLM", "prefill",
           "decode_step"]


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, W, Hkv, Dh]
    v: torch.Tensor  # [L, B, W, Hkv, Dh]


def cache_window(cfg: LMConfig, seq_len: int) -> tuple[int, bool]:
    """(cache width W, rolling?) — SWA models cap the cache at the window."""
    if cfg.sliding_window is not None and cfg.sliding_window < seq_len:
        return cfg.sliding_window, True
    return seq_len, False


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _weight(shape, fan_in, dtype, device, generator) -> nn.Parameter:
    """Drawn from ``generator``, or left uninitialised when it is None."""
    if generator is None:
        return _frozen(torch.empty(shape, dtype=dtype, device=device))
    return _frozen(normal_init(shape, fan_in, dtype, device, generator))


class DecoderLayer(nn.Module):
    """One layer's weights: ``attn_norm``, ``wq/wk/wv/wo``, optional
    ``q_norm``/``k_norm``, ``mlp_norm`` and the SwiGLU ``w_gate/w_up/w_down``."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        w = lambda shape, fan_in: _weight(shape, fan_in, dtype, device, generator)
        ones = lambda n: _frozen(torch.ones(n, dtype=dtype, device=device))
        self.attn_norm = ones(D)
        self.mlp_norm = ones(D)
        self.wq = w((D, Hq * Dh), D)
        self.wk = w((D, Hkv * Dh), D)
        self.wv = w((D, Hkv * Dh), D)
        self.wo = w((Hq * Dh, D), Hq * Dh)
        if cfg.qk_norm:
            self.q_norm = ones(Dh)
            self.k_norm = ones(Dh)
        self.w_gate = w((D, F), D)
        self.w_up = w((D, F), D)
        self.w_down = w((F, D), F)


class TransformerLM(nn.Module):
    """The LM's weights on one device.

    ``device=None`` means ``cuda`` (raising without a GPU; pass ``"cpu"``
    for the plain path).  Weights are fan-in-scaled normals drawn in
    float32 from ``generator`` (a ``torch.Generator`` on ``device``; one
    seeded with 0 when None) and cast to ``cfg.dtype``; norm scales are
    ones.  ``init=False`` leaves the weights uninitialised, for loading
    (:func:`repro_torch.convert.lm_params_from_numpy`).
    """

    def __init__(self, cfg: LMConfig, device: str | torch.device | None = None,
                 generator: torch.Generator | None = None, init: bool = True):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: the MoE FFN is not ported yet (ROADMAP A.11)")
        dev = resolve_device(device)
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        if init and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        gen = generator if init else None
        D, V = cfg.d_model, cfg.vocab
        w = lambda shape, fan_in: _weight(shape, fan_in, dtype, dev, gen)
        self.embed = w((V, D), D)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, dev, gen)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _frozen(torch.ones(D, dtype=dtype, device=dev))
        self.head = w((D, V), D)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _qkv(x, lp: DecoderLayer):
    h = rms_norm(x, lp.attn_norm)
    return h @ lp.wq, h @ lp.wk, h @ lp.wv


def _ffn(x, lp: DecoderLayer):
    h = rms_norm(x, lp.mlp_norm)
    return x + swiglu(h, lp.w_gate, lp.w_up, lp.w_down)


def prefill(model: TransformerLM, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, KVCache]:
    """tokens [B, S] -> (logits of the last position [B, V] f32, KVCache).

    The cache is ``[L, B, W, Hkv, Dh]`` with ``W = S`` when the model has no
    window shorter than S (else W = window, rolling): position t lives at
    slot ``t % W``, as in the reference.
    """
    cfg = model.cfg
    B, S = tokens.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = Hq // Hkv
    W, _ = cache_window(cfg, S)
    dev = model.device
    with torch.inference_mode():
        tokens = tokens.to(dev)
        x = model.embed[tokens]
        cos, sin = rope_angles(torch.arange(S, device=dev), Dh, cfg.rope_theta)
        kc = torch.zeros((cfg.n_layers, B, W, Hkv, Dh), dtype=x.dtype, device=dev)
        vc = torch.zeros_like(kc)
        slots = torch.arange(S - W, S, device=dev) % W
        for li, lp in enumerate(model.layers):
            q, k, v = _qkv(x, lp)
            q = q.reshape(B, S, Hkv, G, Dh)
            k = k.reshape(B, S, Hkv, Dh)
            v = v.reshape(B, S, Hkv, Dh)
            if cfg.qk_norm:
                q = rms_norm(q, lp.q_norm)
                k = rms_norm(k, lp.k_norm)
            q = apply_rope(q, cos[None, :, None, None, :], sin[None, :, None, None, :])
            k = apply_rope(k, cos[None, :, None, :], sin[None, :, None, :])
            o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                                q_block=cfg.q_block, kv_block=cfg.kv_block)
            x = x + o.reshape(B, S, Hq * Dh) @ lp.wo
            x = _ffn(x, lp)
            # the last W positions go to cache slots t % W
            kc[li][:, slots] = k[:, S - W:]
            vc[li][:, slots] = v[:, S - W:]
        x = rms_norm(x[:, -1], model.final_norm)
        logits = (x @ model.head).float()
    return logits, KVCache(k=kc, v=vc)


def decode_step(model: TransformerLM, cache: KVCache, token: torch.Tensor,
                pos: torch.Tensor) -> tuple[torch.Tensor, KVCache]:
    """One decode step.  token [B] int, pos [B] absolute positions.
    Returns (logits [B, V] f32, cache).

    Writes the new keys and values into ``cache`` IN PLACE (slot
    ``pos % W`` of every layer) and returns the same cache: the reference
    donates its cache for the same effect.  After an S-token prefill
    without a window W = S, so the first decode step overwrites slot 0
    (position 0), as the reference does.
    """
    cfg = model.cfg
    B = token.shape[0]
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = Hq // Hkv
    dev = model.device
    with torch.inference_mode():
        token = token.to(dev)
        pos = pos.to(dev)
        x = model.embed[token]
        cos, sin = rope_angles(pos, Dh, cfg.rope_theta)
        W = cache.k.shape[2]
        rows = torch.arange(B, device=dev)
        slots = pos.to(torch.int64) % W
        for li, lp in enumerate(model.layers):
            q, k, v = _qkv(x, lp)
            q = q.reshape(B, Hkv, G, Dh)
            k = k.reshape(B, Hkv, Dh)
            v = v.reshape(B, Hkv, Dh)
            if cfg.qk_norm:
                q = rms_norm(q, lp.q_norm)
                k = rms_norm(k, lp.k_norm)
            q = apply_rope(q, cos[:, None, None, :], sin[:, None, None, :])
            k = apply_rope(k, cos[:, None, :], sin[:, None, :])
            cache.k[li][rows, slots] = k
            cache.v[li][rows, slots] = v
            # position t lives at slot t % W, so rolling=True is exact for
            # full caches too (W == S_max)
            o = decode_attention(q, cache.k[li], cache.v[li], pos,
                                 window=cfg.sliding_window, rolling=True)
            x = x + o.reshape(B, Hq * Dh) @ lp.wo
            x = _ffn(x, lp)
        x = rms_norm(x, model.final_norm)
        logits = (x @ model.head).float()
    return logits, cache
