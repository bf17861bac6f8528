"""Segment-op substrate of the port (port of
``repro/graphstore/segment_ops.py``): the message-passing primitive for
GNNs and embedding bags, built on ``index_add_`` / ``scatter_reduce``.

Semantics are the reference's: segment ids index the leading dimension of
the output and must lie in ``[0, num_segments)``; an empty segment sums to
0, averages to 0 and has the maximum ``-inf`` (the dtype's minimum for an
integer dtype), as ``jax.ops.segment_max`` gives.  ``gather_scatter_sum``
is the COO form of the contract that the SpMM kernel
(:mod:`repro_torch.kernels.gather_segsum`) computes from destination rows.
``PaddedCSR`` / ``build_padded_csr`` are a numpy copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_softmax",
    "gather_scatter_sum",
    "embedding_bag",
    "PaddedCSR",
    "build_padded_csr",
]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_mean(data, segment_ids, num_segments, eps: float = 1e-9):
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids, num_segments)
    return s / torch.clamp(cnt, min=eps)[(...,) + (None,) * (data.dim() - 1)]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    lowest = (-torch.inf if data.is_floating_point() else torch.iinfo(data.dtype).min)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), lowest)
    idx = segment_ids.long().view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, "amax", include_self=False)


def segment_softmax(logits, segment_ids, num_segments):
    """Numerically-stable softmax over variable-length segments (edge
    softmax for GAT)."""
    m = segment_max(logits, segment_ids, num_segments)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ids = segment_ids.long()
    z = torch.exp(logits - m[ids])
    denom = segment_sum(z, segment_ids, num_segments)
    return z / (denom[ids] + 1e-9)


def gather_scatter_sum(x, src_idx, dst_idx, num_segments, edge_weight=None):
    """The GNN aggregation: out[d] = sum_{edges e: dst=d} w_e * x[src_e]."""
    msgs = x[src_idx.long()]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    return segment_sum(msgs, dst_idx, num_segments)


def embedding_bag(table, indices, offsets_ids, num_bags, weights=None, combine="sum"):
    """EmbeddingBag from gather + segment ops.  ``indices``: flat lookups
    into ``table``; ``offsets_ids``: bag id per lookup; ``combine`` in
    {sum, mean}."""
    rows = table[indices.long()]
    if weights is not None:
        rows = rows * weights[:, None]
    if combine == "sum":
        return segment_sum(rows, offsets_ids, num_bags)
    if combine == "mean":
        return segment_mean(rows, offsets_ids, num_bags)
    raise ValueError(f"combine={combine}")


# ---------------------------------------------------------------------------
# padded CSR blocking (numpy, host side)
# ---------------------------------------------------------------------------


class PaddedCSR(NamedTuple):
    """Fixed-shape CSR blocks: ``rows x nnz_per_block`` column indices.

    ``col[b, j]`` is the source index of the j-th nonzero handled by block
    b; ``row[b, j]`` its destination row; padding entries point at row
    ``num_rows`` (dropped).  Long rows are split across consecutive blocks.
    """

    col: np.ndarray  # int32 [n_blocks, nnz_per_block]
    row: np.ndarray  # int32 [n_blocks, nnz_per_block]
    val: np.ndarray  # float32 [n_blocks, nnz_per_block]
    num_rows: int
    nnz_per_block: int


def build_padded_csr(dst, src, val, num_rows: int, nnz_per_block: int = 1024) -> PaddedCSR:
    """Pack COO (sorted by dst) into fixed-size blocks."""
    dst = np.asarray(dst, np.int32)
    src = np.asarray(src, np.int32)
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    v = (np.ones(dst.shape[0], np.float32) if val is None
         else np.asarray(val, np.float32)[order])
    nnz = dst.shape[0]
    n_blocks = max(1, (nnz + nnz_per_block - 1) // nnz_per_block)
    pad = n_blocks * nnz_per_block - nnz
    col = np.concatenate([src, np.zeros(pad, np.int32)]).reshape(n_blocks, -1)
    row = np.concatenate([dst, np.full(pad, num_rows, np.int32)]).reshape(n_blocks, -1)
    vv = np.concatenate([v, np.zeros(pad, np.float32)]).reshape(n_blocks, -1)
    return PaddedCSR(col=col, row=row, val=vv, num_rows=num_rows,
                     nnz_per_block=nnz_per_block)
