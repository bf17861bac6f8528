"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): top-k routing
inside token blocks, capacity buffers per expert, and the router's
load-balancing loss.

The port computes the reference's function, drops included:

* **Token blocks.** ``TB = 32`` blocks if ``T % 32 == 0``, else one;
  blocks are contiguous runs of the flat ``[T]`` token order.
* **Capacity per block.** ``Cb = max(1, int(capacity_factor * tp * K /
  E))`` with ``tp = T // TB``: the floor, as the reference's code takes it.
  An assignment past its expert's ``Cb`` slots in its block is dropped:
  it adds nothing and its gate counts for nothing.
* **Router.** ``x.float() @ router.float()``, top-k in descending order,
  a softmax over the k values.
* **Slots.** An assignment's position in its expert's buffer is the
  number of earlier assignments to that expert in its block, in
  token-major, k-minor order (the reference's cumsum of the one-hot,
  here a stable sort); a kept one goes to slot ``e * Cb + pos``.

Two changes of layout, neither of which changes the function in exact
arithmetic:

* the reference's ``virtual_split`` stores expert e as ``vs`` virtual
  experts of ``F / vs`` columns each (a sharding device) and sums their
  partial ``w_down`` products; here each expert is held whole, ``[E, D,
  F]`` (:mod:`repro_torch.convert` folds and unfolds).  In bf16 that
  rounds the full product once where the reference rounds each partial
  and then their sum;
* the combine sums a token's K contributions with one reduction (they
  are adjacent in the assignment order), which rounds once, where XLA's
  bf16 scatter-add rounds after each add.  No atomic is used, so a run
  on the card gives the same bits every time.

Dispatch and combine are a scatter of token ids into each block's
``E * Cb`` slots (destinations unique but for one spare slot that takes
the drops) and row gathers.  The expert products are plain batched matrix
products, as they are plain einsums outside any Pallas kernel in the
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoESpec

__all__ = ["TOKEN_BLOCKS", "Routing", "moe_route", "moe_ffn", "router_aux_loss"]

TOKEN_BLOCKS = 32  # the reference's pod * data


class Routing(NamedTuple):
    """Where each of ``T * K`` assignments goes (``A = T // TB * K`` per
    block, token-major and k-minor)."""

    logits: torch.Tensor  # [T, E] float32 router logits
    topi: torch.Tensor    # [T, K] int64 chosen experts, best first
    gates: torch.Tensor   # [T, K] float32 softmax over the K logits
    slot: torch.Tensor    # [TB, A] int64 slot e * Cb + pos, or E * Cb if dropped
    keep: torch.Tensor    # [TB, A] bool, False where dropped
    capacity: int         # Cb


def moe_route(x: torch.Tensor, router: torch.Tensor, spec: MoESpec) -> Routing:
    """Route flat tokens ``x [T, D]`` through ``router [D, E]``."""
    T = x.shape[0]
    E, K = spec.n_experts, spec.top_k
    TB = TOKEN_BLOCKS if T % TOKEN_BLOCKS == 0 else 1
    tp = T // TB
    Cb = max(1, int(spec.capacity_factor * tp * K / E))
    # a float32 product: TF32 stays off here (PyTorch's default for
    # matmul), since a rounder logit would move near-tie tokens to
    # another expert
    logits = x.float() @ router.float()
    topv, topi = torch.topk(logits, K, dim=-1)
    gates = torch.softmax(topv, dim=-1)
    assign = topi.reshape(TB, tp * K)
    # an assignment's position among its block's assignments to the same
    # expert (what the reference's cumsum of the one-hot gives): its rank
    # in a stable sort by (block, expert) less its group's first rank
    key = (torch.arange(TB, device=x.device)[:, None] * E + assign).reshape(-1)
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(key.numel(), device=x.device)
    counts = torch.bincount(key, minlength=TB * E)
    pos = (rank - (torch.cumsum(counts, 0) - counts)[key]).view(TB, tp * K)
    keep = pos < Cb
    slot = torch.where(keep, assign * Cb + pos, E * Cb)
    return Routing(logits, topi, gates, slot, keep, Cb)


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, spec: MoESpec
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: ``[T, D]`` flat tokens; ``router [D, E]``, ``w_gate``/``w_up``
    ``[E, D, F]``, ``w_down [E, F, D]``.  Returns ``(out [T, D] in x's
    dtype, aux)``, aux the router's load-balancing loss (float32)."""
    T, D = x.shape
    E, K = spec.n_experts, spec.top_k
    r = moe_route(x, router, spec)
    Cb = r.capacity
    TB, A = r.slot.shape
    tp = A // K
    n_slots = E * Cb
    blocks = torch.arange(TB, device=x.device)
    tok = blocks[:, None] * tp + torch.arange(tp, device=x.device).repeat_interleave(K)
    # dispatch: the token that fills each slot (T, a zero row, for an empty
    # slot); the drops all land in the spare slot n_slots
    src = torch.full((TB, n_slots + 1), T, dtype=torch.int64, device=x.device)
    src.scatter_(1, r.slot, tok)
    src = src[:, :n_slots].view(TB, E, Cb).transpose(0, 1).reshape(-1)  # expert-major
    buf = torch.cat([x, x.new_zeros((1, D))]).index_select(0, src).view(E, TB * Cb, D)
    del src
    h = F.silu(torch.bmm(buf, w_gate), inplace=True)
    h.mul_(torch.bmm(buf, w_up))
    del buf
    # y's rows are (expert, block, position), and one zero row for the drops
    y = x.new_empty((E * TB * Cb + 1, D))
    y[-1].zero_()
    torch.bmm(h, w_down, out=y[:-1].view(E, TB * Cb, D))
    del h
    e, pos = r.slot // Cb, r.slot % Cb
    row = torch.where(r.keep, (e * TB + blocks[:, None]) * Cb + pos, E * TB * Cb)
    gk = (r.gates.reshape(TB, A) * r.keep).to(y.dtype)
    contrib = y.index_select(0, row.view(-1)).view(TB, A, D) * gk[..., None]
    out = contrib.view(TB, tp, K, D).sum(dim=2)
    aux = router_aux_loss(r.logits, r.topi, E)
    return out.reshape(T, D).to(x.dtype), aux


def router_aux_loss(logits: torch.Tensor, topi: torch.Tensor, n_experts: int
                    ) -> torch.Tensor:
    """Switch-style load-balancing loss: E * <frac_tokens, frac_probs>."""
    probs = torch.softmax(logits.float(), dim=-1)
    frac_probs = probs.mean(dim=0)
    counts = torch.bincount(topi.reshape(-1), minlength=n_experts).float()
    frac_tokens = counts / counts.sum().clamp_min(1.0)
    return n_experts * (frac_probs * frac_tokens).sum()
