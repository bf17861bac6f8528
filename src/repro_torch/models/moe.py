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
  and then their sum.  The sharded path (below) takes the reference's
  layout and its rounding;
* the combine sums a token's K contributions with one reduction (they
  are adjacent in the assignment order), which rounds once, where XLA's
  bf16 scatter-add rounds after each add.  No atomic is used, so a run
  on the card gives the same bits every time.

Dispatch and combine are a scatter of token ids into each block's
``E * Cb`` slots (destinations unique but for one spare slot that takes
the drops) and row gathers.  Without grad mode (serving) ``silu``, the
gate product and the down product run in place, to save memory; with it
(training) their out-of-place forms give the same values.  The gathers'
backward is an ``index_add_`` (float atomics on CUDA: a token's row is
gathered up to K times), so on the card the gradients do not repeat their
bits from run to run; the forward does.  The expert products are plain batched matrix
products, as they are plain einsums outside any Pallas kernel in the
reference.

**On a mesh** (``x`` a DTensor, its weights placed by
:func:`repro_torch.launch.cells.shard_cell`), :func:`moe_ffn` follows the
reference's sharded steps, each layout change a named
:func:`~repro_torch.dist.sharding.constrain` or ``redistribute``:

* each rank routes and dispatches its own token blocks under
  ``local_map`` (the reference's ``shard_map``): blocks are contiguous
  runs of the tokens, so where the token shards hold whole blocks the
  routing is the unsharded one block by block.  Where one block spans
  shards (``TB`` not divisible by the shards: decode at a small batch),
  the tokens are first gathered to every rank, which routes them all and
  keeps its own rows of the output;
* the buffer ``[E, TB, Cb, D]`` is constrained ``("expert", "batch",
  None, None)``: each rank runs the expert products on its experts and
  its blocks, on local tensors (the serving path's in-place forms); with
  ``expert_parallel=False`` the weights' ``F`` is sharded instead and the
  ``w_down`` products' partial sums are all-reduced;
* virtual experts (mixtral's ``virtual_split``): ``shard_cell`` places
  the unfolded ``[E vs, D, F / vs]`` leaves, the buffer is broadcast over
  ``vs`` and the partial ``w_down`` products are pair-summed, on the rank
  where both halves sit, else by one all-reduce over the ranks that hold
  them;
* the output ``y`` is gathered over the expert shards (``("batch", None,
  None)`` in the reference: an all-gather over ``model``) and each rank
  combines its blocks under ``local_map``;
* the aux loss is taken over the global tokens: one all-reduce of the
  router probabilities' sums and one of the expert counts.

DTensor has no sharding rule for ``topk``, the stable ``argsort``,
``scatter_``, ``index_select`` or ``index_add_``: they run on local
tensors only, in the forward and in the backward.  The sharded path also
trains (the FSDP train step, :func:`repro_torch.launch.cells.shard_cell`
on a MoE train cell; the layer gathers the experts' ``fsdp`` dim before
the FFN): each ``local_map`` states where its inputs' local gradients are
partial sums (the replicated router's and experts' over the token shards
that used them; the buffer's over the ``F`` shards without expert
parallelism), which the gathers' backward reduce-scatters; the buffer's
constraint gathers its gradient over ``model``, ``y``'s gather takes its
slice of a gradient that every rank holds whole, and the pair sum's
all-reduce hands each half the whole gradient.  The aux loss's
probability sums are all-reduced by :class:`_TokenSum`, whose backward is
the identity: the loss is whole on every rank, so each rank's tokens take
its gradient once.  The counts carry no gradient.  A rematerialised
layer's recomputation repeats its routing (the same inputs, the same
deterministic ops).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import MoESpec
from repro_torch.dist.sharding import all_reduce, constrain, redistribute

__all__ = ["TOKEN_BLOCKS", "Routing", "moe_route", "moe_ffn", "router_aux_loss"]

TOKEN_BLOCKS = 32  # the reference's pod * data


class Routing(NamedTuple):
    """Where each of ``T * K`` assignments goes (``A = T // TB * K`` per
    block, token-major and k-minor).  On a mesh, DTensors whose token
    (and block) dim is sharded as the routed tokens are."""

    logits: torch.Tensor  # [T, E] float32 router logits
    topi: torch.Tensor    # [T, K] int64 chosen experts, best first
    gates: torch.Tensor   # [T, K] float32 softmax over the K logits
    slot: torch.Tensor    # [TB, A] int64 slot e * Cb + pos, or E * Cb if dropped
    keep: torch.Tensor    # [TB, A] bool, False where dropped
    capacity: int         # Cb


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(ids, minlength=n)`` for ids in ``[0, n)``, as an integer
    ``index_add_`` (exact on every device), which a meta tensor (the dry
    run's trace) also runs."""
    ones = torch.ones_like(ids, dtype=torch.int64)
    return torch.zeros(n, dtype=torch.int64, device=ids.device).index_add_(0, ids, ones)


def _blocks(T: int, spec: MoESpec) -> tuple[int, int, int]:
    """(blocks TB, tokens a block tp, capacity Cb) of ``T`` flat tokens."""
    TB = TOKEN_BLOCKS if T % TOKEN_BLOCKS == 0 else 1
    tp = T // TB
    return TB, tp, max(1, int(spec.capacity_factor * tp * spec.top_k / spec.n_experts))


def _route(x: torch.Tensor, router: torch.Tensor, spec: MoESpec, tp: int, Cb: int
           ) -> Routing:
    """Route ``x [T, D]`` (whole blocks of ``tp`` tokens) through ``router``."""
    E, K = spec.n_experts, spec.top_k
    TB = x.shape[0] // tp
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
    counts = _counts(key, TB * E)
    pos = (rank - (torch.cumsum(counts, 0) - counts)[key]).view(TB, tp * K)
    keep = pos < Cb
    slot = torch.where(keep, assign * Cb + pos, E * Cb)
    return Routing(logits, topi, gates, slot, keep, Cb)


def moe_route(x: torch.Tensor, router: torch.Tensor, spec: MoESpec) -> Routing:
    """Route flat tokens ``x [T, D]`` through ``router [D, E]``.  On a
    DTensor each rank routes its own blocks (:func:`_aligned` tokens)."""
    if isinstance(x, DTensor):
        return _sharded_route(x, router, spec)
    _, tp, Cb = _blocks(x.shape[0], spec)
    return _route(x, router, spec, tp, Cb)


def _dispatch(x: torch.Tensor, slot: torch.Tensor, K: int, Cb: int, E: int, vs: int = 1
              ) -> torch.Tensor:
    """The capacity buffer ``[E vs, TB Cb, D]`` of tokens ``x [T, D]``
    (expert-major rows (expert, block, position), a zero row for an empty
    slot), each expert's rows repeated for its ``vs`` virtual experts."""
    T, D = x.shape
    TB, A = slot.shape
    tp = A // K
    n_slots = E * Cb
    tok = (torch.arange(TB, device=x.device)[:, None] * tp
           + torch.arange(tp, device=x.device).repeat_interleave(K))
    # the token that fills each slot (T, a zero row, for an empty slot);
    # the drops all land in the spare slot n_slots
    src = torch.full((TB, n_slots + 1), T, dtype=torch.int64, device=x.device)
    src.scatter_(1, slot, tok)
    src = src[:, :n_slots].view(TB, E, Cb).transpose(0, 1)  # expert-major
    if vs > 1:
        src = src.repeat_interleave(vs, dim=0)
    src = src.reshape(-1)
    return torch.cat([x, x.new_zeros((1, D))]).index_select(0, src).view(E * vs, TB * Cb, D)


def _products(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``(silu(buf @ w_gate) * (buf @ w_up)) @ w_down`` over the experts
    (batched): without grad mode the serving path's in-place forms, into
    ``out`` if given; with it the same values out of place (autograd keeps
    the product that ``silu`` would overwrite), ``out`` unused."""
    if torch.is_grad_enabled():
        return torch.bmm(F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up), w_down)
    h = F.silu(torch.bmm(buf, w_gate), inplace=True)
    h.mul_(torch.bmm(buf, w_up))
    return torch.bmm(h, w_down, out=out)


def _combine(y: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor, gates: torch.Tensor,
             Cb: int) -> torch.Tensor:
    """Each token's sum of its kept assignments' rows of ``y``, weighted by
    their gates: ``y`` holds rows (expert, block, position) and a zero row
    last (what a dropped assignment reads).  Returns ``[T, D]``."""
    TB, A = slot.shape
    K = gates.shape[1]
    D = y.shape[1]
    blocks = torch.arange(TB, device=y.device)
    e, pos = slot // Cb, slot % Cb
    row = torch.where(keep, (e * TB + blocks[:, None]) * Cb + pos, y.shape[0] - 1)
    gk = (gates.reshape(TB, A) * keep).to(y.dtype)
    contrib = y.index_select(0, row.view(-1)).view(TB, A, D) * gk[..., None]
    return contrib.view(TB, A // K, K, D).sum(dim=2).reshape(-1, D)


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, spec: MoESpec
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: ``[T, D]`` flat tokens; ``router [D, E]``, ``w_gate``/``w_up``
    ``[E, D, F]``, ``w_down [E, F, D]``.  Returns ``(out [T, D] in x's
    dtype, aux)``, aux the router's load-balancing loss (float32).  On
    DTensors: :func:`_sharded_moe_ffn` (the weights may be the unfolded
    virtual experts there)."""
    if isinstance(x, DTensor):
        return _sharded_moe_ffn(x, router, w_gate, w_up, w_down, spec)
    T, D = x.shape
    E = spec.n_experts
    if w_gate.shape[0] != E:
        raise ValueError(f"moe_ffn: {w_gate.shape[0]} experts held, the config has {E} "
                         f"(unfolded virtual experts run on a mesh only)")
    r = moe_route(x, router, spec)
    Cb = r.capacity
    TB = r.slot.shape[0]
    buf = _dispatch(x, r.slot, spec.top_k, Cb, E)
    # y's rows are (expert, block, position), and one zero row for the drops
    if torch.is_grad_enabled():
        y = torch.cat([_products(buf, w_gate, w_up, w_down).view(-1, D), x.new_zeros((1, D))])
    else:
        y = x.new_empty((E * TB * Cb + 1, D))
        y[-1].zero_()
        _products(buf, w_gate, w_up, w_down, out=y[:-1].view(E, TB * Cb, D))
    del buf
    out = _combine(y, r.slot, r.keep, r.gates, Cb)
    aux = router_aux_loss(r.logits, r.topi, E)
    return out.to(x.dtype), aux


def router_aux_loss(logits: torch.Tensor, topi: torch.Tensor, n_experts: int
                    ) -> torch.Tensor:
    """Switch-style load-balancing loss: E * <frac_tokens, frac_probs>.
    On DTensors sharded over the tokens, over all of them: the
    probabilities' sums and the counts all-reduced (one each), every rank
    holding the loss."""
    if isinstance(logits, DTensor):
        return _sharded_aux(logits, topi, n_experts)
    probs = torch.softmax(logits.float(), dim=-1)
    frac_probs = probs.mean(dim=0)
    counts = _counts(topi.reshape(-1), n_experts).float()
    frac_tokens = counts / counts.sum().clamp_min(1.0)
    return n_experts * (frac_probs * frac_tokens).sum()


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------


def _token_dims(x: DTensor) -> list[int]:
    """The mesh dims that shard the tokens of ``x [T, ...]``; raises on
    any other split."""
    out = []
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == 0:
            out.append(i)
        elif not isinstance(p, Replicate):
            raise ValueError(f"moe_ffn: x placements {x.placements} of shape "
                             f"{tuple(x.shape)}: only the tokens may be sharded")
    return out


def _aligned(x: DTensor, spec: MoESpec) -> DTensor:
    """``x`` whose token shards hold whole blocks: itself where the blocks
    divide over the shards, else gathered whole along the tokens (one
    named redistribute, an all-gather)."""
    TB, _, _ = _blocks(x.shape[0], spec)
    dims = _token_dims(x)
    if TB % math.prod(x.device_mesh.size(i) for i in dims) == 0:
        return x
    return redistribute(x, [Replicate() if i in dims else p
                            for i, p in enumerate(x.placements)])


def _sharded_route(x: DTensor, router: torch.Tensor, spec: MoESpec) -> Routing:
    """:func:`moe_route` of a DTensor: ``x`` aligned to whole blocks, each
    rank routes its blocks under ``local_map``; the routing's token and
    block dims keep the tokens' placements, ``router`` is replicated."""
    x = _aligned(x, spec)
    mesh = x.device_mesh
    _, tp, Cb = _blocks(x.shape[0], spec)
    rep = [Replicate()] * mesh.ndim
    if isinstance(router, DTensor) and tuple(router.placements) != tuple(rep):
        raise ValueError(f"moe_ffn: router placements {router.placements}: it must be "
                         f"replicated")
    tok_pl = list(x.placements)
    # the router's local gradient is this rank's tokens' part
    router_grad = [Partial() if isinstance(p, Shard) else Replicate() for p in tok_pl]
    out = local_map(lambda xl, rl: tuple(_route(xl, rl, spec, tp, Cb)[:5]),
                    out_placements=(tok_pl,) * 5, in_placements=(tok_pl, rep),
                    in_grad_placements=(tok_pl, router_grad), device_mesh=mesh)(x, router)
    return Routing(*out, Cb)


class _TokenSum(torch.autograd.Function):
    """A rank's sum over its tokens all-reduced (``sum``) over the mesh
    ``groups`` that split the tokens: the sum over all of them, which
    every rank holds.  Backward, the identity: what consumes the sum is
    replicated (the aux loss, whose gradient every rank holds whole), so
    each rank hands that gradient to its own tokens once; an all-reduce
    there would count it once a rank."""

    @staticmethod
    def forward(ctx, t, groups):
        return all_reduce(t, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sharded_aux(logits: DTensor, topi: DTensor, E: int) -> DTensor:
    """:func:`router_aux_loss` over every rank's tokens: the sums of the
    router probabilities (:class:`_TokenSum`, differentiable) and the
    expert counts (no gradient) all-reduced over the mesh dims that shard
    the tokens (one all-reduce each), the loss replicated; with no such
    dim, each rank's plain loss."""
    mesh = logits.device_mesh
    T = logits.shape[0]
    groups = [(mesh, i) for i in _token_dims(logits) if mesh.size(i) > 1]

    def local(lg, ti):
        if not groups:
            return router_aux_loss(lg, ti, E)
        frac_probs = _TokenSum.apply(torch.softmax(lg.float(), dim=-1).sum(dim=0), groups) / T
        counts = all_reduce(_counts(ti.reshape(-1), E).float(), "sum", groups)
        return E * (frac_probs * (counts / counts.sum().clamp_min(1.0))).sum()

    return local_map(local, out_placements=[Replicate()] * mesh.ndim,
                     in_placements=(logits.placements, topi.placements),
                     device_mesh=mesh)(logits, topi)


def _products_placements(buf: DTensor, w_gate: DTensor, w_up: DTensor, w_down: DTensor):
    """The placements of the expert products' output ``[Ev, TB, Cb, D]``:
    a mesh dim that shards the experts of the weights and of the buffer
    shards the output's; one that shards their ``F`` leaves partial sums;
    one that shards the buffer's blocks only shards the output's."""
    out = []
    for i, (b, g, u, d) in enumerate(zip(buf.placements, w_gate.placements,
                                         w_up.placements, w_down.placements)):
        if g == Shard(0) and u == Shard(0) and d == Shard(0) and b == Shard(0):
            out.append(Shard(0))
        elif g == Shard(2) and u == Shard(2) and d == Shard(1) and isinstance(b, Replicate):
            out.append(Partial())
        elif all(isinstance(p, Replicate) for p in (g, u, d)) and b != Shard(0):
            out.append(b)
        else:
            raise ValueError(f"moe_ffn: on mesh dim {i} the buffer is placed {b} and the "
                             f"weights {g}, {u}, {d}: experts must be split alike, F only "
                             f"where the buffer is whole")
    return out


def _products_grad_placements(buf: DTensor, weights, out_pl) -> tuple:
    """Where the expert products' local input gradients are partial sums:
    the buffer's over a mesh dim that splits ``F`` (where the output is a
    partial sum), a weight's over a mesh dim that splits the buffer's
    blocks while the weight is whole on it (each rank's blocks add their
    part); elsewhere each input's own placement."""
    grad_buf = [Partial() if isinstance(o, Partial) else b
                for b, o in zip(buf.placements, out_pl)]
    grad_w = [[Partial() if b == Shard(1) and isinstance(p, Replicate) else p
               for b, p in zip(buf.placements, w.placements)] for w in weights]
    return (grad_buf, *grad_w)


def _pair_sum(y: DTensor, vs: int) -> DTensor:
    """The virtual experts' partial ``w_down`` products ``[E vs, TB, Cb,
    D]`` summed into whole experts ``[E, TB, Cb, D]``: on the rank where
    an expert's ``vs`` halves sit together, a local sum; where each rank
    holds a part of one expert, the parts are added by one all-reduce over
    the ranks that split the experts (the result whole on them)."""
    mesh = y.device_mesh
    Ev = y.shape[0]
    E = Ev // vs
    dims = [i for i, p in enumerate(y.placements) if p == Shard(0)]
    m = math.prod(mesh.size(i) for i in dims)
    held = Ev // m
    if held % vs == 0:
        return local_map(lambda yl: yl.view(held // vs, vs, *yl.shape[1:]).sum(dim=1),
                         out_placements=list(y.placements), in_placements=(y.placements,),
                         device_mesh=mesh)(y)
    if vs % held:
        raise ValueError(f"moe_ffn: {held} virtual experts a rank do not split {vs}-way "
                         f"experts")
    coord = mesh.get_coordinate()
    flat = 0
    for i in dims:  # DTensor chunks a dim mesh dim by mesh dim, in mesh order
        flat = flat * mesh.size(i) + coord[i]
    e = flat * held // vs
    out_pl = [Partial() if i in dims else p for i, p in enumerate(y.placements)]

    def local(yl):
        whole = yl.new_zeros((E, *yl.shape[1:]))
        whole[e] = yl.sum(dim=0)
        return whole

    y = local_map(local, out_placements=out_pl, in_placements=(y.placements,),
                  device_mesh=mesh)(y)
    return redistribute(y, [Replicate() if i in dims else p for i, p in enumerate(out_pl)])


def _sharded_moe_ffn(x: DTensor, router, w_gate, w_up, w_down, spec: MoESpec
                     ) -> tuple[DTensor, DTensor]:
    """:func:`moe_ffn` on a mesh (the module docstring's steps): ``x [T,
    D]`` sharded over its tokens only, ``router`` replicated, the experts'
    weights placed by ``cell.in_logical`` (whole experts ``[E, ...]``, or
    the unfolded ``[E vs, ...]``).).  Out: ``x``'s placements; aux
    replicated.  Differentiable (the module docstring's gradients)."""
    mesh = x.device_mesh
    T, D = x.shape
    E, K, vs = spec.n_experts, spec.top_k, spec.virtual_split
    Ev = w_gate.shape[0]
    if Ev not in (E, E * vs):
        raise ValueError(f"moe_ffn: {Ev} experts held; the config has {E} "
                         f"(x{vs} virtual)")
    held_vs = Ev // E
    xa = _aligned(x, spec)
    r = moe_route(xa, router, spec)
    aux = router_aux_loss(r.logits, r.topi, E)
    Cb = r.capacity
    tok_pl = list(xa.placements)
    blk_pl = [Shard(1) if isinstance(p, Shard) else p for p in tok_pl]

    def dispatch(xl, sl):
        return _dispatch(xl, sl, K, Cb, E, held_vs).view(Ev, sl.shape[0], Cb, D)

    buf = local_map(dispatch, out_placements=blk_pl, in_placements=(tok_pl, tok_pl),
                    device_mesh=mesh)(xa, r.slot)
    # the reference's constraint: each rank its experts (or all of them,
    # F split, without expert parallelism) and its blocks
    axes = ("expert" if held_vs > 1 or spec.expert_parallel else None, "batch", None, None)
    buf = constrain(buf, *axes)

    def products(bl, gl, ul, dl):
        n, tb = bl.shape[:2]
        return _products(bl.reshape(n, tb * Cb, D), gl, ul, dl).view(n, tb, Cb, D)

    weights = (w_gate, w_up, w_down)
    out_pl = _products_placements(buf, *weights)
    y = local_map(products, out_placements=out_pl,
                  in_placements=(buf.placements, *(w.placements for w in weights)),
                  in_grad_placements=_products_grad_placements(buf, weights, out_pl),
                  device_mesh=mesh)(buf, *weights)
    del buf
    y = constrain(y, *axes)  # F's partial sums all-reduced (expert_parallel=False)
    if held_vs > 1:
        y = _pair_sum(y, held_vs)
    # back to the tokens' blocks, every expert on each rank: the all-gather
    # over the expert shards
    y = redistribute(y, blk_pl)

    def combine(yl, sl, kl, gl):
        rows = torch.cat([yl.reshape(-1, D), yl.new_zeros((1, D))])
        return _combine(rows, sl, kl, gl, Cb).to(x.dtype)

    out = local_map(combine, out_placements=tok_pl,
                    in_placements=(blk_pl, tok_pl, tok_pl, tok_pl),
                    device_mesh=mesh)(y, r.slot, r.keep, r.gates)
    if tuple(out.placements) != tuple(x.placements):  # each rank keeps its rows
        out = redistribute(out, x.placements)
    return out, aux
