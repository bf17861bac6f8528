"""Plain PyTorch versions of the block-sparse SpMM (K4's yardsticks and
its CPU path).

* :func:`spmm_ref` — the COO oracle (port of
  ``repro/kernels/gather_segsum/ref.py``): ``out[d] = sum_{e: dst_e = d}
  val_e * x[src_e]``, the contract of ``segment_ops.gather_scatter_sum``.
* :func:`block_spmm_ref` — the same function at the tile level: one batched
  product per tile, then ``index_add_`` of the products over destination
  blocks in tile order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["spmm_ref", "block_spmm_ref"]


def spmm_ref(src, dst, val, x, n_out):
    """out[d] = sum_{e: dst_e = d} val_e * x[src_e].  x: [N, F]."""
    msgs = x[src.long()] * val[:, None]
    return x.new_zeros((n_out, x.shape[1])).index_add_(0, dst.long(), msgs)


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
