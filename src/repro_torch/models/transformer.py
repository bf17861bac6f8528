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

The models are mesh-agnostic, as the reference's are: they call
:func:`~repro_torch.dist.sharding.constrain` at the reference's points
(``x`` after the embedding and the blocks, the logits, the
sequence-sharded serving attention's q, k and v), which is a no-op on
plain tensors.  With its weights and inputs as DTensors
(:func:`repro_torch.launch.cells.shard_cell`) under ``use_axis_env``,
``prefill``, ``decode_step``, ``forward`` and ``lm_loss`` (without a
gradient) run sharded.  Where GSPMD infers a layout the port names it:
the row-parallel products' partial sums are all-reduced by a
``constrain`` on the product, q's column shards become whole heads or
sequence blocks by a ``constrain`` before the reshape, decode's q, k and
v are gathered whole, the KV cache's writes go to the rank that owns the
slot, and ``lm_loss`` takes its log-sum-exp over vocabulary shards with
one all-reduce of the max and one of the sums.  A MoE layer's FFN runs
:func:`~repro_torch.models.moe.moe_ffn`'s sharded path (token blocks
routed under ``local_map``, experts on ``expert``), and ``forward``'s aux
is the mean over the layers of each layer's loss over all the tokens.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree
from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.dist.sharding import axis_env, constrain, shard_span
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.layers import (apply_rope, matmul, normal_init, rms_norm, rope_angles,
                                       swiglu)
from repro_torch.models.moe import moe_ffn

__all__ = ["KVCache", "cache_window", "DecoderLayer", "TransformerLM", "forward",
           "lm_loss", "prefill", "decode_step", "reference_leaves", "port_logical",
           "reference_groups"]


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
        """Where the weights live (a DTensor's: its shard's device)."""
        e = self.embed
        return e.to_local().device if isinstance(e, DTensor) else e.device


def _on(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """An input on the model's device (a DTensor input is placed already)."""
    return t if isinstance(t, DTensor) else t.to(dev)


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


def port_logical(cfg: LMConfig, logical: dict) -> dict:
    """``{port parameter name: logical names}`` from the reference's LM
    logical tree (``launch.cells.lm_param_logical``): a ``layers`` leaf's names less
    its leading layer dim for each layer's tensor."""
    out = {}
    for path, names in reference_leaves(cfg):
        node = logical
        for key in path:
            node = node[key]
        for name in names:
            out[name] = tuple(node[1:]) if path[0] == "layers" else tuple(node)
    return out


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


def seq_sharded(cfg: LMConfig) -> bool:
    """Whether a prefill shards its attention over the sequence: the
    reference's rule, only where the q heads do not divide the production
    mesh's model dim (MODEL_AXIS), qwen3-14b's 40 and deepseek-coder-33b's
    56; the others keep the head-sharded layout.  The rule reads the
    production mesh, not the live one, so that a config takes one layout
    on every mesh; how a head-sharded q is split on the live mesh is
    :func:`_sharded_qkv`'s (whole heads where they divide its model dim)."""
    return cfg.n_heads % sharding.MODEL_AXIS != 0


def _sharded_qkv(q, k, v, cfg: LMConfig, seq: bool):
    """DTensor q, k, v [B, S, H * Dh] (their columns sharded on the model
    dim by the products) in the attention's layout: ``seq``: each as a
    block of the sequence (q [B, S, Hkv, G, Dh]); else q [B, S, Hq, Dh] with
    its column shards carried into whole heads where the heads divide (a
    whole q otherwise) and k, v whole.  Each change of layout is a
    ``constrain`` before the reshape, which then keeps its shards."""
    B, S, _ = q.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if seq:
        q, k, v = (constrain(t, "batch", "seq", None) for t in (q, k, v))
        return q.reshape(B, S, Hkv, Hq // Hkv, Dh), k.reshape(B, S, Hkv, Dh), v.reshape(
            B, S, Hkv, Dh)
    env = axis_env()
    if env is None or Hq % env.axis_size("model"):
        q = constrain(q, "batch", None, None)
    k, v = (constrain(t, "batch", None, None) for t in (k, v))
    return q.reshape(B, S, Hq, Dh), k.reshape(B, S, Hkv, Dh), v.reshape(B, S, Hkv, Dh)


def _attend(x, lp: DecoderLayer, cfg: LMConfig, cos, sin, seq: bool = False):
    """The attention block over a whole sequence, x [B, S, D]: returns x
    plus the attention output, and this layer's k, v [B, S, Hkv, Dh].
    ``seq``: the serving prefill's sequence-sharded attention (a no-op on
    plain tensors)."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, lp.attn_norm)
    q, k, v = h @ lp.wq, h @ lp.wk, h @ lp.wv
    if isinstance(q, DTensor):
        q, k, v = _sharded_qkv(q, k, v, cfg, seq)
    else:
        q = q.reshape(B, S, Hkv, Hq // Hkv, Dh)
        k = k.reshape(B, S, Hkv, Dh)
        v = v.reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp.q_norm)
        k = rms_norm(k, lp.k_norm)
    qs = (None, slice(None)) + (None,) * (q.dim() - 3)
    q = apply_rope(q, cos[qs], sin[qs])
    k = apply_rope(k, cos[None, :, None, :], sin[None, :, None, :])
    if seq:
        q = constrain(q, "batch", "seq", None, None, None)
        k = constrain(k, "batch", "seq", None, None)
        v = constrain(v, "batch", "seq", None, None)
    o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                        q_block=cfg.q_block, kv_block=cfg.kv_block)
    # wo's rows are the heads: o's heads shards, the product's partial sums
    o = constrain(o.reshape(B, S, Hq * Dh), "batch", None, "model")
    return x + constrain(_out_proj(o, lp.wo), "batch", None, None), k, v


def _out_proj(o, wo):
    """``o @ wo``, the attention's output projection: on DTensors a
    row-parallel product, whose partial sums the caller's ``constrain``
    all-reduces in o's dtype."""
    return matmul(o, wo)


def _ffn(x, lp: DecoderLayer, cfg: LMConfig) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x [B, S, D] or [B, D] -> (x + FFN(x), the router's aux loss, None
    for a dense layer).  The MoE FFN routes the flat [T, D] tokens."""
    h = rms_norm(x, lp.mlp_norm)
    if cfg.moe is None:
        # w_down's rows are sharded: its product's partial sums all-reduced
        y = constrain(swiglu(h, lp.w_gate, lp.w_up, lp.w_down), "batch",
                      *(None,) * (x.dim() - 1))
        return x + y, None
    y, aux = moe_ffn(h.reshape(-1, cfg.d_model), lp.router, lp.w_gate, lp.w_up,
                     lp.w_down, cfg.moe)
    return x + y.reshape(h.shape), aux


def _embed(tokens: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, embed)``.  On a DTensor table each rank looks
    up its rows: with the vocabulary (dim 0) split over ranks, a token
    another rank owns reads 0 and the output is a partial sum over those
    ranks (one of them non-zero: exact), which the caller's ``constrain``
    all-reduces; the table's gradient is each rank's rows, partial over
    the mesh dims that split the tokens (the batch), with no collective
    and no whole-table temporary."""
    if not isinstance(embed, DTensor):
        return F.embedding(tokens, embed)
    mesh = embed.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 and mesh.size(i) > 1
             for i, p in enumerate(embed.placements)]
    v0, n = shard_span(embed, 0)
    tok_pl = list(tokens.placements)
    out_pl, grad_pl = [], []
    for i, (w, t) in enumerate(zip(embed.placements, tok_pl)):
        if isinstance(w, Shard) and isinstance(t, Shard):
            raise ValueError(f"embedding: table {embed.placements} and tokens {tok_pl} are "
                             f"both split on mesh dim {i}")
        if isinstance(w, Shard):
            out_pl.append(Shard(tokens.dim()) if w.dim == 1 else Partial() if vocab[i]
                          else Replicate())
        else:
            out_pl.append(t)
        grad_pl.append(w if isinstance(w, Shard) else Partial() if isinstance(t, Shard)
                       else Replicate())

    def local(w, tok):
        if not any(vocab):
            return F.embedding(tok, w)
        own = (tok >= v0) & (tok < v0 + n)
        rows = F.embedding((tok - v0).clamp(0, max(n - 1, 0)), w)
        return torch.where(own[..., None], rows, 0.0)

    return local_map(local, out_placements=out_pl, in_placements=(embed.placements, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh)(embed, tokens)


def _fsdp_layer(lp: DecoderLayer):
    """The layer's weights for one use: under an env, each DTensor weight
    gathered along the ``fsdp`` mesh dims (its ``model`` shards kept), one
    named redistribute each, whose backward reduce-scatters its gradient;
    ``lp`` itself otherwise.  Called inside the rematerialised layer, the
    gathered copies live as long as the layer and are gathered again by
    the recomputation in the backward, as FSDP does."""
    env = axis_env()
    if env is None or not isinstance(lp.wq, DTensor):
        return lp
    return SimpleNamespace(**{n: sharding.unshard(p, "fsdp") for n, p in lp.named_parameters()})


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
    tokens = _on(tokens, dev)
    embed = sharding.unshard(model.embed, "fsdp")
    x = constrain(_embed(tokens, embed), "batch", None, None)
    cos, sin = rope_angles(torch.arange(S, device=dev), cfg.d_head, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=dev)

    def layer(x, lp):
        lp = _fsdp_layer(lp)
        x, _, _ = _attend(x, lp, cfg, cos, sin)
        x = constrain(x, "batch", None, None)
        x, a = _ffn(x, lp, cfg)
        x = constrain(x, "batch", None, None)
        return x, (a if a is not None else torch.zeros((), device=dev))

    grad = torch.is_grad_enabled()
    for lp in model.layers:
        if remat and grad:
            x, a = checkpoint(layer, x, lp, use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = layer(x, lp)
        aux = aux + a
    x = rms_norm(x, model.final_norm)
    logits = constrain((x @ sharding.unshard(model.head, "fsdp")).float(), "batch", None,
                       "model")
    return logits, aux / cfg.n_layers


class _VocabShardNll(torch.autograd.Function):
    """One rank's ``logsumexp(logits) - logits[label]`` over its vocabulary
    shard ``[v0, v0 + n)`` of the logits ``lg`` [B, S, n] (float32), the
    vocabulary split over the ``groups``: one all-reduce of the max, then
    one of the sum of ``exp(logit - max)`` beside the label's logit (which
    one shard holds, the others adding 0); ``torch.logsumexp``'s formula,
    its sum split by rank.  Backward, with no collective: each rank's
    shard of ``softmax - onehot(label)``, times the upstream gradient."""

    @staticmethod
    def forward(ctx, lg, lb, v0: int, n: int, groups):
        m = sharding.all_reduce(lg.amax(dim=-1), "max", groups)
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        s = (lg - m[..., None]).exp().sum(dim=-1)
        own = (lb >= v0) & (lb < v0 + n)
        at = (lb - v0).clamp(0, n - 1)[..., None]
        ll = lg.gather(-1, at)[..., 0]
        both = sharding.all_reduce(torch.stack([s, torch.where(own, ll, 0.0)]), "sum", groups)
        lse = both[0].log() + m
        ctx.save_for_backward(lg, lse, own, at)
        return lse - both[1]

    @staticmethod
    def backward(ctx, g):
        lg, lse, own, at = ctx.saved_tensors
        d = (lg - lse[..., None]).exp_()
        d.scatter_add_(-1, at, -own[..., None].to(d.dtype))
        return d.mul_(g[..., None]), None, None, None, None


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` over the last dim, [B, S]
    float32, differentiable.  On DTensor logits whose vocabulary is split
    over ranks, each rank takes its shard (:class:`_VocabShardNll`); the
    logits' gradient keeps their placements."""
    if not isinstance(logits, DTensor):
        lse = torch.logsumexp(logits, dim=-1)
        return lse - logits.gather(-1, labels[..., None])[..., 0]
    mesh = logits.device_mesh
    vocab = [(mesh, i) for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == 2 and mesh.size(i) > 1]
    for p in logits.placements:
        if isinstance(p, Shard) and p.dim not in (0, 2):
            raise ValueError(f"lm_loss: logits placements {logits.placements}: only the "
                             f"batch and the vocabulary may be sharded")
    out_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in logits.placements]
    labels = sharding.redistribute(labels, out_pl)
    v0, n = shard_span(logits, 2)

    def local(lg, lb):
        if not vocab:
            return _token_nll(lg, lb)
        return _VocabShardNll.apply(lg, lb, v0, n, vocab)

    return local_map(local, out_placements=list(out_pl), in_placements=(logits.placements, out_pl),
                     in_grad_placements=(logits.placements, out_pl), device_mesh=mesh)(logits,
                                                                                    labels)


def lm_loss(model: TransformerLM, tokens: torch.Tensor, labels: torch.Tensor,
            aux_weight: float = 0.01) -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL of ``labels`` [B, S] under :func:`forward`, plus
    ``aux_weight`` times the router's aux loss: ``(loss, {"nll", "aux"})``,
    differentiable when grad mode is on (the loss the train step takes),
    each layer rematerialised as :func:`forward` does by default.  On
    DTensors the mean is all-reduced over the batch shards (every rank
    holds the loss), and its gradient is the global mean's: each rank's
    tokens weigh ``1 / (B S)``."""
    logits, aux = forward(model, tokens)
    labels = _on(labels, logits.device).to(torch.int64)
    nll = sharding.settle(_token_nll(logits, labels).mean())
    loss = nll + aux_weight * aux
    return loss, {"nll": nll, "aux": aux}


def _cache_zeros(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    """The [L, B, W, Hkv, Dh] cache: on ``like``'s mesh, placed as the
    prefill cell's output (batch, and the slots on the model dim), when
    ``like`` is a DTensor."""
    if isinstance(like, DTensor):
        return sharding.zeros(shape, None, "batch", "model", None, None, dtype=dtype,
                              device=like.to_local().device)
    return torch.zeros(shape, dtype=dtype, device=like.device)


def _fill_cache(cache_layer: DTensor, k: torch.Tensor, S: int) -> None:
    """Prefill's write of one layer's keys (or values) k [B, S, Hkv, Dh]
    into its cache slots [B, W, Hkv, Dh], position t at slot t % W, each
    rank writing the slots it owns.  Where k's sequence is sharded as the
    slots are (W = S), those are its own rows; otherwise k is made whole
    along the sequence first (a named redistribute)."""
    W = cache_layer.shape[1]
    slot_pl = [isinstance(p, Shard) and p.dim == 1 for p in cache_layer.placements]
    seq_pl = [isinstance(p, Shard) and p.dim == 1 for p in k.placements]
    if not (W == S and slot_pl == seq_pl):
        k = sharding.redistribute(k, [Replicate() if isinstance(p, Shard) and p.dim == 1
                                      else p for p in k.placements])
    batch = lambda t: [isinstance(p, Shard) and p.dim == 0 for p in t.placements]
    if batch(k) != batch(cache_layer):
        raise ValueError(f"prefill: keys {k.placements} and cache {cache_layer.placements} "
                         f"split the batch differently")
    w0, n = shard_span(cache_layer, 1)
    s0 = shard_span(k, 1)[0]
    kl, cl = k.to_local(), cache_layer.to_local()
    # the position each of this rank's slots holds after the prefill
    pos = S - W + torch.remainder(torch.arange(w0, w0 + n, device=kl.device) - (S - W), W)
    cl.copy_(kl.index_select(1, pos - s0))


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
        tokens = _on(tokens, dev)
        x = constrain(F.embedding(tokens, model.embed), "batch", None, None)
        cos, sin = rope_angles(torch.arange(S, device=dev), Dh, cfg.rope_theta)
        kc = _cache_zeros((cfg.n_layers, B, W, Hkv, Dh), x.dtype, x)
        vc = _cache_zeros((cfg.n_layers, B, W, Hkv, Dh), x.dtype, x)
        slots = torch.arange(S - W, S, device=dev) % W
        for li, lp in enumerate(model.layers):
            x, k, v = _attend(x, lp, cfg, cos, sin, seq=seq_sharded(cfg))
            x, _ = _ffn(x, lp, cfg)
            x = constrain(x, "batch", None, None)
            # the last W positions go to cache slots t % W
            if isinstance(kc, DTensor):
                _fill_cache(_layer(kc, li), k, S)
                _fill_cache(_layer(vc, li), v, S)
            else:
                kc[li][:, slots] = k[:, S - W:]
                vc[li][:, slots] = v[:, S - W:]
        x = rms_norm(x[:, -1], model.final_norm)
        logits = matmul(x, model.head).float()
    return logits, KVCache(k=kc, v=vc)


def _layer(cache: torch.Tensor, li: int) -> torch.Tensor:
    """Layer ``li`` of a [L, B, W, Hkv, Dh] cache, a view: on a DTensor,
    the view of its shard wrapped at the same placements less the layer
    dim (so the cache need not have been made under inference mode)."""
    if not isinstance(cache, DTensor):
        return cache[li]
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in cache.placements]
    if any(isinstance(p, Shard) and p.dim < 0 for p in pl):
        raise ValueError(f"KV cache placements {cache.placements}: the layer dim is sharded")
    return DTensor.from_local(cache.to_local()[li], cache.device_mesh, pl, run_check=False,
                              shape=cache.shape[1:], stride=cache.stride()[1:])


def _write_slot(cache_layer: torch.Tensor, slots: torch.Tensor, new: torch.Tensor) -> None:
    """``cache_layer[b, slots[b]] = new[b]`` for every row b, in place:
    cache_layer [B, W, Hkv, Dh], slots [B], new [B, Hkv, Dh].  On DTensors
    each rank writes the rows of its batch shard whose slot it owns (new
    whole on every rank of a slot shard); no collective."""
    if not isinstance(cache_layer, DTensor):
        cache_layer[torch.arange(new.shape[0], device=new.device), slots] = new
        return
    w0, n = shard_span(cache_layer, 1)
    cl, sl, nl = cache_layer.to_local(), slots.to_local() - w0, new.to_local()
    if cl.shape[0] != nl.shape[0] or sl.shape[0] != nl.shape[0]:
        raise ValueError(f"decode_step: cache {cache_layer.placements}, slots "
                         f"{slots.placements} and keys {new.placements} split the batch "
                         f"differently")
    own = (sl >= 0) & (sl < n)
    rows = torch.arange(nl.shape[0], device=nl.device)
    at = sl.clamp(0, max(n - 1, 0))
    # rows whose slot another rank owns write back what they read
    cl[rows, at] = torch.where(own[:, None, None], nl, cl[rows, at])


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
        token = _on(token, dev)
        pos = _on(pos, dev)
        x = constrain(F.embedding(token, model.embed), "batch", None)
        cos, sin = rope_angles(pos, Dh, cfg.rope_theta)
        W = cache.k.shape[2]
        slots = pos.to(torch.int64) % W
        for li, lp in enumerate(model.layers):
            h = rms_norm(x, lp.attn_norm)
            # flash-decode takes every head on every rank of a slot shard
            q, k, v = (constrain(matmul(h, w), "batch", None) for w in (lp.wq, lp.wk, lp.wv))
            q = q.reshape(B, Hkv, G, Dh)
            k = k.reshape(B, Hkv, Dh)
            v = v.reshape(B, Hkv, Dh)
            if cfg.qk_norm:
                q = rms_norm(q, lp.q_norm)
                k = rms_norm(k, lp.k_norm)
            q = apply_rope(q, cos[:, None, None, :], sin[:, None, None, :])
            k = apply_rope(k, cos[:, None, :], sin[:, None, :])
            kl, vl = _layer(cache.k, li), _layer(cache.v, li)
            _write_slot(kl, slots, k)
            _write_slot(vl, slots, v)
            # position t lives at slot t % W, so rolling=True is exact for
            # full caches too (W == S_max)
            o = decode_attention(q, kl, vl, pos, window=cfg.sliding_window, rolling=True)
            o = constrain(o.reshape(B, Hq * Dh), "batch", "model")
            x = x + constrain(_out_proj(o, lp.wo), "batch", None)
            x, _ = _ffn(x, lp, cfg)
        x = rms_norm(x, model.final_norm)
        logits = matmul(x, model.head).float()
    return logits, cache
