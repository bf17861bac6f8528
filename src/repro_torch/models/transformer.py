"""Decoder-only transformer LM (port of ``repro/models/transformer.py``):
GQA attention with optional qk-norm and sliding window, a dense SwiGLU or
a MoE FFN (:mod:`repro_torch.models.moe`), and four entry points:

* :func:`forward`      — the scoring forward (causal): logits and the
  router's aux loss
* :func:`lm_loss`      — next-token loss over :func:`forward`
* :func:`prefill`      — forward over a prompt + KV-cache construction
* :func:`decode_step`  — one token against a (rolling) KV cache

Prefill and forward attention go through
:func:`repro_torch.models.attention.flash_attention` (the K3 kernel on
CUDA, its plain version on the CPU); decode attention is plain PyTorch, as
it is plain jnp in the reference.  Parameters keep the reference's ``x @
w`` layout, one :class:`DecoderLayer` per layer in place of the
reference's stacked ``[L, ...]`` leaves (:func:`reference_leaves` maps
one layout to the other, :mod:`repro_torch.convert` carries them across).
Parameters are trainable: ``forward`` and ``lm_loss`` build the autograd
graph when grad mode is on (call them under ``torch.no_grad()`` to score
without one), with each layer rematerialised in the backward (``forward``'s
``remat``, the reference's ``jax.checkpoint``) and
attention's gradient from K3's ``autograd.Function``; :mod:`repro_torch.train`
trains through them.  ``prefill`` and ``decode_step`` run under
``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree
from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.layers import apply_rope, normal_init, rms_norm, rope_angles, swiglu
from repro_torch.models.moe import moe_ffn

__all__ = ["KVCache", "cache_window", "DecoderLayer", "TransformerLM", "forward",
           "lm_loss", "prefill", "decode_step", "reference_leaves", "reference_groups"]


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, W, Hkv, Dh]
    v: torch.Tensor  # [L, B, W, Hkv, Dh]


def cache_window(cfg: LMConfig, seq_len: int) -> tuple[int, bool]:
    """(cache width W, rolling?) — SWA models cap the cache at the window."""
    if cfg.sliding_window is not None and cfg.sliding_window < seq_len:
        return cfg.sliding_window, True
    return seq_len, False


def _weight(shape, fan_in, dtype, device, generator) -> nn.Parameter:
    """Drawn from ``generator``, or left uninitialised when it is None."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    return nn.Parameter(normal_init(shape, fan_in, dtype, device, generator))


class DecoderLayer(nn.Module):
    """One layer's weights: ``attn_norm``, ``wq/wk/wv/wo``, optional
    ``q_norm``/``k_norm``, ``mlp_norm``, and the FFN: the SwiGLU ``w_gate
    [D, F]``, ``w_up [D, F]``, ``w_down [F, D]``, or with ``cfg.moe`` a
    ``router [D, E]`` in float32 (whatever ``cfg.dtype`` is, as in the
    reference) and the experts' ``w_gate``/``w_up [E, D, F]`` and
    ``w_down [E, F, D]``."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        w = lambda shape, fan_in, dt=dtype: _weight(shape, fan_in, dt, device, generator)
        ones = lambda n: nn.Parameter(torch.ones(n, dtype=dtype, device=device))
        self.attn_norm = ones(D)
        self.mlp_norm = ones(D)
        self.wq = w((D, Hq * Dh), D)
        self.wk = w((D, Hkv * Dh), D)
        self.wv = w((D, Hkv * Dh), D)
        self.wo = w((Hq * Dh, D), Hq * Dh)
        if cfg.qk_norm:
            self.q_norm = ones(Dh)
            self.k_norm = ones(Dh)
        if cfg.moe is None:
            self.w_gate = w((D, F), D)
            self.w_up = w((D, F), D)
            self.w_down = w((F, D), F)
        else:
            E, F = cfg.moe.n_experts, cfg.moe.d_ff_expert
            self.router = w((D, E), D, torch.float32)
            self.w_gate = w((E, D, F), D)
            self.w_up = w((E, D, F), D)
            self.w_down = w((E, F, D), F)


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
        self.final_norm = nn.Parameter(torch.ones(D, dtype=dtype, device=dev))
        self.head = w((D, V), D)

    @property
    def device(self) -> torch.device:
        return self.embed.device


_LAYER_LEAVES = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "q_norm", "k_norm")
_MLP_LEAVES = ("w_gate", "w_up", "w_down")
_MOE_LEAVES = ("router",) + _MLP_LEAVES


def reference_leaves(cfg: LMConfig) -> list[tuple[tuple[str, ...], list[str]]]:
    """``(reference path, port parameter names)`` of every leaf of the
    reference's LM pytree: one name for ``embed``, ``final_norm`` and
    ``head``; one a layer, stacked on a leading axis in the reference, for
    the ``layers`` leaves (a MoE layer's experts folded,
    :func:`repro_torch.convert.fold_experts`)."""
    per_layer = lambda n: [f"layers.{i}.{n}" for i in range(cfg.n_layers)]
    out = [(("embed",), ["embed"]), (("final_norm",), ["final_norm"]), (("head",), ["head"])]
    out += [(("layers", n), per_layer(n)) for n in _LAYER_LEAVES
            if cfg.qk_norm or n not in ("q_norm", "k_norm")]
    ffn, names = ("mlp", _MLP_LEAVES) if cfg.moe is None else ("moe", _MOE_LEAVES)
    return out + [(("layers", ffn, n), per_layer(n)) for n in names]


def reference_groups(params) -> dict | None:
    """For an LM module: ``{port leaf: reference leaf}``, each a
    :func:`~repro_torch.pytree.keystr` (``['layers.3.wq']`` ->
    ``['layers']['wq']``), the port's tensors that the reference stacks
    into one leaf (what int8 compression takes one scale over).  None for
    a tree keyed as the reference's already."""
    if not isinstance(params, TransformerLM):
        return None
    key = lambda path: pytree.keystr(tuple(("key", k) for k in path))
    return {key((n,)): key(path) for path, names in reference_leaves(params.cfg)
            for n in names}


def _attend(x, lp: DecoderLayer, cfg: LMConfig, cos, sin):
    """The attention block over a whole sequence, x [B, S, D]: returns x
    plus the attention output, and this layer's k, v [B, S, Hkv, Dh]."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, lp.attn_norm)
    q = (h @ lp.wq).reshape(B, S, Hkv, Hq // Hkv, Dh)
    k = (h @ lp.wk).reshape(B, S, Hkv, Dh)
    v = (h @ lp.wv).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp.q_norm)
        k = rms_norm(k, lp.k_norm)
    q = apply_rope(q, cos[None, :, None, None, :], sin[None, :, None, None, :])
    k = apply_rope(k, cos[None, :, None, :], sin[None, :, None, :])
    o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                        q_block=cfg.q_block, kv_block=cfg.kv_block)
    return x + o.reshape(B, S, Hq * Dh) @ lp.wo, k, v


def _ffn(x, lp: DecoderLayer, cfg: LMConfig) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x [B, S, D] or [B, D] -> (x + FFN(x), the router's aux loss, None
    for a dense layer).  The MoE FFN routes the flat [T, D] tokens."""
    h = rms_norm(x, lp.mlp_norm)
    if cfg.moe is None:
        return x + swiglu(h, lp.w_gate, lp.w_up, lp.w_down), None
    y, aux = moe_ffn(h.reshape(-1, cfg.d_model), lp.router, lp.w_gate, lp.w_up,
                     lp.w_down, cfg.moe)
    return x + y.reshape(h.shape), aux


def forward(model: TransformerLM, tokens: torch.Tensor, remat: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] f32, aux): the causal scoring
    forward, aux the router's load-balancing loss averaged over the layers
    (a dense layer adds 0).

    With grad mode on, the graph is built; ``remat`` then keeps only each
    layer's input and recomputes the layer in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).
    The layers are deterministic, so the recomputation repeats the
    forward's values (and a MoE layer its routing)."""
    cfg = model.cfg
    S = tokens.shape[1]
    dev = model.device
    tokens = tokens.to(dev)
    x = model.embed[tokens]
    cos, sin = rope_angles(torch.arange(S, device=dev), cfg.d_head, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=dev)

    def layer(x, lp):
        x, _, _ = _attend(x, lp, cfg, cos, sin)
        x, a = _ffn(x, lp, cfg)
        return x, (a if a is not None else torch.zeros((), device=dev))

    grad = torch.is_grad_enabled()
    for lp in model.layers:
        if remat and grad:
            x, a = checkpoint(layer, x, lp, use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = layer(x, lp)
        aux = aux + a
    x = rms_norm(x, model.final_norm)
    logits = (x @ model.head).float()
    return logits, aux / cfg.n_layers


def lm_loss(model: TransformerLM, tokens: torch.Tensor, labels: torch.Tensor,
            aux_weight: float = 0.01) -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL of ``labels`` [B, S] under :func:`forward`, plus
    ``aux_weight`` times the router's aux loss: ``(loss, {"nll", "aux"})``,
    differentiable when grad mode is on (the loss the train step takes),
    each layer rematerialised as :func:`forward` does by default."""
    logits, aux = forward(model, tokens)
    labels = labels.to(logits.device, torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None])[..., 0]
    nll = (lse - ll).mean()
    loss = nll + aux_weight * aux
    return loss, {"nll": nll, "aux": aux}


def prefill(model: TransformerLM, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, KVCache]:
    """tokens [B, S] -> (logits of the last position [B, V] f32, KVCache).

    The cache is ``[L, B, W, Hkv, Dh]`` with ``W = S`` when the model has no
    window shorter than S (else W = window, rolling): position t lives at
    slot ``t % W``, as in the reference.
    """
    cfg = model.cfg
    B, S = tokens.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
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
            x, k, v = _attend(x, lp, cfg, cos, sin)
            x, _ = _ffn(x, lp, cfg)
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
            h = rms_norm(x, lp.attn_norm)
            q = (h @ lp.wq).reshape(B, Hkv, G, Dh)
            k = (h @ lp.wk).reshape(B, Hkv, Dh)
            v = (h @ lp.wv).reshape(B, Hkv, Dh)
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
            x, _ = _ffn(x, lp, cfg)
        x = rms_norm(x, model.final_norm)
        logits = (x @ model.head).float()
    return logits, cache
