"""Plain PyTorch versions of the SpMM ``out = A x`` (K4's yardsticks and
its CPU path).

* :func:`spmm_ref` — the COO oracle (port of
  ``repro/kernels/gather_segsum/ref.py``): ``out[d] = sum_{e: dst_e = d}
  val_e * x[src_e]``, the contract of ``segment_ops.gather_scatter_sum``.
* :func:`spmm_rows_ref` — the same function over the destination-sorted
  rows (:class:`~repro_torch.kernels.gather_segsum.ops.BlockRows`) that K4
  reads: gather, multiply, ``index_add_`` over the row ids.  The CPU path.
* :func:`block_spmm_ref` — the same function at the level of the
  reference's dense tiles: one batched product per tile, then
  ``index_add_`` of the products over destination blocks in tile order.
  The parity side with ``repro``'s Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["spmm_ref", "spmm_rows_ref", "block_spmm_ref"]


def spmm_ref(src, dst, val, x, n_out):
    """out[d] = sum_{e: dst_e = d} val_e * x[src_e].  x: [N, F]."""
    msgs = x[src.long()] * val[:, None]
    return x.new_zeros((n_out, x.shape[1])).index_add_(0, dst.long(), msgs)


def spmm_rows_ref(rows, x):
    """``out[r] = sum_{e in row r} val[e] * x[col[e]]`` -> ``[rows.n_out, F]``;
    rows of x past its end (up to ``rows.n_src``) read as 0."""
    nnz = rows.col.shape[0]
    if x.shape[0] < rows.n_src:
        x = F.pad(x, (0, 0, 0, rows.n_src - x.shape[0]))
    row_id = torch.repeat_interleave(
        torch.arange(rows.n_out, device=x.device), rows.row_ptr.diff(), output_size=nnz)
    msgs = x[rows.col.long()] * rows.val[:, None]
    return x.new_zeros((rows.n_out, x.shape[1])).index_add_(0, row_id, msgs)


def block_spmm_ref(tiles, tile_src, tile_dst, first_visit, x, n_out_blocks):
    """``out[tile_dst[t]] += tiles[t] @ x[tile_src[t]]`` over all tiles ->
    ``[n_out_blocks * bs, F]``.

    ``tiles [T, bs, bs]``; x rows past its end read as 0 (x is padded here
    to whole blocks).  The output starts at zero, which is what
    ``first_visit`` asks of every visited block; blocks no tile visits stay
    zero.
    """
    del first_visit  # the zero start covers it
    T, bs, _ = tiles.shape
    n, f = x.shape
    xb = F.pad(x, (0, 0, 0, -n % bs)).view(-1, bs, f)
    prod = torch.bmm(tiles, xb[tile_src.long()])  # [T, bs, F]
    out = x.new_zeros((n_out_blocks, bs, f)).index_add_(0, tile_dst.long(), prod)
    return out.view(n_out_blocks * bs, f)
