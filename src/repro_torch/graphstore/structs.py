"""Device-resident graph structures (fixed-capacity COO buffers), on torch.

The counterpart of ``repro.graphstore.structs``.  The evolving transaction
graph lives in fixed-capacity COO buffers with validity masks; edge
insertion appends into pre-allocated slots.  Dtypes follow the reference:
int32 endpoints, float32 weights, bool masks.  Indices stay int32 on every
path: torch's gathers, ``index_add_``, ``index_put_`` and ``searchsorted``
take int32 indices, so the tick makes no int64 copy of an index array.

JAX's ``mode="drop"`` scatters have no torch counterpart.  Here every
scatter that may carry out-of-range lanes writes into a copy of its target
with one spare trailing slot, and those lanes are redirected to that slot
(:func:`scatter_drop`), never clamped onto a real one.  Boolean-mask
indexing would do the same job but costs a device->host sync on CUDA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.frontier_spmv import suffix_init

__all__ = ["DeviceGraph", "device_graph_from_coo", "compact_slots",
           "append_edges", "remove_edges", "scatter_drop", "csr_sort"]


def scatter_drop(
    target: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor | None,
    values: torch.Tensor, accumulate: bool = False,
) -> torch.Tensor:
    """Functional ``target.at[idx].set/add(values, mode="drop")``.

    Lanes with ``~ok`` (``ok=None``: none) or an index outside
    ``[0, len(target))`` land in a spare slot past the end and are
    discarded.  Returns a new tensor; ``target`` is not modified.
    """
    n = target.shape[0]
    out = torch.empty(n + 1, dtype=target.dtype, device=target.device)
    out[:n] = target
    out[n] = 0
    inside = (idx >= 0) & (idx < n)
    idx = torch.where(inside if ok is None else ok & inside, idx, n)
    values = values.to(target.dtype)
    if accumulate:
        out.index_add_(0, idx, values)
    else:
        out.index_put_((idx,), values)
    return out[:n]


def compact_slots(
    offset: torch.Tensor, valid: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compacted append slots: the k-th valid lane gets ``offset + k``.

    Returns ``(idx, ok)``; lanes with ``~ok`` (invalid, or past capacity)
    must be dropped by the caller.
    """
    slot = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    idx = offset + slot
    return idx, valid & (idx < capacity)


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Fixed-capacity COO transaction graph on one device.

    ``src[i] -> dst[i]`` with suspiciousness ``c[i]`` where ``edge_mask[i]``.
    Invalid slots carry ``src = dst = n_capacity - 1`` padding self-loops
    with ``c = 0``, so segment ops need no extra masking of indices.
    """

    src: torch.Tensor  # int32 [E_cap]
    dst: torch.Tensor  # int32 [E_cap]
    c: torch.Tensor  # float32 [E_cap]
    edge_mask: torch.Tensor  # bool [E_cap]
    a: torch.Tensor  # float32 [V_cap] vertex suspiciousness
    vertex_mask: torch.Tensor  # bool [V_cap]
    n_capacity: int
    e_capacity: int

    @property
    def device(self) -> torch.device:
        return self.src.device

    def f_total(self) -> torch.Tensor:
        """f(V): total graph suspiciousness (Eq. 1)."""
        return torch.where(self.vertex_mask, self.a, 0.0).sum() + torch.where(
            self.edge_mask, self.c, 0.0
        ).sum()

    def peel_weights(self) -> torch.Tensor:
        """w_u(S_0) for every vertex: a_u + incident suspiciousness.

        The static peel's own prologue (:func:`suffix_init` over every
        slot, as ``core.peel.bulk_peel`` calls it), so a state seeded from
        it holds the same bits as that peel's weights; on CUDA the sums are
        float64, rounded once, and repeat their bits run to run."""
        a = torch.where(self.vertex_mask, self.a, 0.0)
        return suffix_init(self.src, self.dst, self.c, self.edge_mask,
                           torch.ones_like(self.vertex_mask), a)[0]


def device_graph_from_coo(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    c: np.ndarray | None = None,
    a: np.ndarray | None = None,
    n_capacity: int | None = None,
    e_capacity: int | None = None,
    device: str | torch.device | None = None,
) -> DeviceGraph:
    """Build a DeviceGraph from host COO arrays (padding to capacity).

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the CPU.
    """
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    m = src.shape[0]
    c = np.ones(m, dtype=np.float32) if c is None else np.asarray(c, dtype=np.float32)
    n_cap = int(n_capacity or n)
    e_cap = int(e_capacity or max(m, 1))
    if n_cap < n or e_cap < m:
        raise ValueError("capacity smaller than graph")
    pad_e = e_cap - m
    pad_idx = np.full(pad_e, n_cap - 1, dtype=np.int32)
    av = np.zeros(n_cap, dtype=np.float32)
    if a is not None:
        av[:n] = np.asarray(a, dtype=np.float32)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return DeviceGraph(
        src=put(np.concatenate([src, pad_idx])),
        dst=put(np.concatenate([dst, pad_idx])),
        c=put(np.concatenate([c, np.zeros(pad_e, np.float32)])),
        edge_mask=put(np.concatenate([np.ones(m, bool), np.zeros(pad_e, bool)])),
        a=put(av),
        vertex_mask=put(np.arange(n_cap) < n),
        n_capacity=n_cap,
        e_capacity=e_cap,
    )


def append_edges(
    g: DeviceGraph,
    offset: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    c: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> DeviceGraph:
    """Write a batch of edges into consecutive slots from ``offset``.

    ``offset`` is the current edge count (a device scalar).  Valid entries
    are *compacted*: the k-th valid edge lands in slot ``offset + k``, even
    when invalid entries sit between valid ones.  Out-of-capacity writes
    are dropped.  Returns a new graph; ``g``'s buffers are not modified.
    """
    B = src.shape[0]
    v = torch.ones(B, dtype=torch.bool, device=src.device) if valid is None else valid
    idx, ok = compact_slots(offset, v, g.e_capacity)
    true = torch.ones(B, dtype=torch.bool, device=src.device)
    return dataclasses.replace(
        g,
        src=scatter_drop(g.src, idx, ok, src),
        dst=scatter_drop(g.dst, idx, ok, dst),
        c=scatter_drop(g.c, idx, ok, c),
        edge_mask=scatter_drop(g.edge_mask, idx, ok, true),
    )


def remove_edges(
    g: DeviceGraph, drop: torch.Tensor
) -> tuple[DeviceGraph, torch.Tensor]:
    """Tombstone the slots where ``drop`` holds and compact the survivors.

    The k-th surviving edge (in slot order) moves to slot ``k``, so the
    live region stays a prefix; freed slots revert to the inert padding.
    The compaction is a **gather**: output slot ``k`` pulls the k-th
    survivor, located by binary search over the survivor-count prefix sum.
    (The scatter form was refuted in the reference: it cost ~4x the gather
    at 400k edges.)

    Returns ``(graph, n_removed)`` with ``n_removed`` the number of *live*
    edges dropped, as an int32 device scalar.
    """
    E = g.e_capacity
    dev = g.src.device
    survive = g.edge_mask & ~drop
    csum = torch.cumsum(survive.to(torch.int32), 0, dtype=torch.int32)
    n_survive = csum[E - 1]
    slots = torch.arange(1, E + 1, dtype=torch.int32, device=dev)
    idx = torch.searchsorted(csum, slots, out_int32=True)
    live = slots <= n_survive  # 0-based slot k < n_survive
    idx = torch.where(live, idx, E - 1)  # clamp dead lanes (values masked)
    n_removed = (g.edge_mask & drop).sum().to(torch.int32)
    pad = g.n_capacity - 1
    return (
        dataclasses.replace(
            g,
            src=torch.where(live, g.src[idx], pad),
            dst=torch.where(live, g.dst[idx], pad),
            c=torch.where(live, g.c[idx], 0.0),
            edge_mask=live,
        ),
        n_removed,
    )


def csr_sort(g: DeviceGraph) -> DeviceGraph:
    """Sort edge slots by (src, dst) for locality (host-side utility).

    The sort is ``np.lexsort`` on the host, as in the reference; the sorted
    buffers go back to the graph's device.
    """
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    order = torch.from_numpy(np.lexsort((dst, src))).to(g.device)
    return dataclasses.replace(
        g,
        src=g.src[order],
        dst=g.dst[order],
        c=g.c[order],
        edge_mask=g.edge_mask[order],
    )
