"""The sparse formats and the wrapper of the destination-row SpMM kernel
(K4, ``csrc/gather_segsum.cu``), port of ``repro/kernels/gather_segsum/ops.py``.

:func:`build_rows` gives a sparse matrix as :class:`BlockRows`, its
destination-sorted CSR form, which K4 reads.  :func:`build_tiles` buckets
the same edges into the reference's dense 128x128 tiles (the arrays of
``repro``'s ``build_tiles``, bit for bit) for parity with its Pallas kernel;
:func:`rows_from_tiles` gives the matrix of such tiles as rows.  Both build
on the tensors' own device, with no Python loop per row or tile and no host
copy.  :func:`gather_segsum` runs K4 on CUDA tensors (or raises) and its
plain version :func:`spmm_rows_ref` on CPU tensors.  On ``meta`` tensors
(the dry run's trace) :func:`build_rows` gives the shapes only.  ``launches`` counts
kernel launches (not CPU calls).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _launch
from .ref import spmm_rows_ref

__all__ = ["BlockRows", "BlockTiles", "build_rows", "build_tiles", "rows_from_tiles",
           "gather_segsum", "check_kernel_args", "launches", "BLOCK"]

launches = 0
BLOCK = 128  # the reference's tile edge
_FILL_THREADS = 2 * 132 * 128  # two of K4's CTAs on each SM of an H100
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]


@dataclass
class BlockRows:
    """A sparse ``[n_out, n_src]`` matrix in destination-sorted CSR form:
    the entries of row ``r`` are ``[row_ptr[r], row_ptr[r + 1])``, in edge
    order (duplicate edges kept, not summed)."""

    row_ptr: torch.Tensor  # [n_out + 1] i64
    col: torch.Tensor  # [nnz] i32, the source row of each entry
    val: torch.Tensor  # [nnz] f32
    n_out: int
    n_src: int


@dataclass
class BlockTiles:
    """Dense tiles of a sparse matrix sorted by destination block: the
    reference's ``BlockTiles``."""

    tiles: torch.Tensor  # [T, bs, bs] f32, A[dst_local, src_local]
    tile_src: torch.Tensor  # [T] i32
    tile_dst: torch.Tensor  # [T] i32 (sorted)
    first_visit: torch.Tensor  # [T] i32
    n_out_blocks: int
    n_src_blocks: int
    block_size: int
    occupancy: float  # nnz / (T * bs * bs) — tile density diagnostic


def _device(src, device) -> torch.device:
    if isinstance(src, torch.Tensor) and device is None:
        return src.device
    return resolve_device(device)


def _as(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(a).to(device=dev, dtype=dtype)


def _edges(src, dst, val, device, index_dtype=torch.int64):
    dev = _device(src, device)
    src, dst = _as(src, index_dtype, dev), _as(dst, index_dtype, dev)
    val = (torch.ones(src.shape[0], dtype=torch.float32, device=dev) if val is None
           else _as(val, torch.float32, dev))
    return src, dst, val, dev


def build_rows(src, dst, val, n_dst: int, n_src: int,
               device: str | torch.device | None = None) -> BlockRows:
    """Edges ``src -> dst`` with weights ``val`` (ones when None) as
    destination rows: one stable sort by ``dst``, then ``bincount`` and
    ``cumsum`` for ``row_ptr``.  Runs on ``src``'s device when it is a
    tensor, else on ``device`` (default ``cuda``), on int32 indices (half
    the transient memory of int64 at ogbn-products' 61.9M edges); raises on
    a ``dst`` outside ``[0, n_dst)``."""
    src, dst, val, dev = _edges(src, dst, val, device, torch.int32)
    dst, order = torch.sort(dst, stable=True)
    if dev.type == "meta":  # the dry run's trace: shapes only
        counts = torch.empty(n_dst, dtype=torch.int64, device=dev)
    else:
        counts = torch.bincount(dst, minlength=n_dst)
    if counts.shape[0] != n_dst:
        raise ValueError(f"build_rows: a destination lies past n_dst = {n_dst}")
    row_ptr = torch.zeros(n_dst + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    return BlockRows(row_ptr, src[order], val[order], n_dst, n_src)


def build_tiles(src, dst, val, n_dst: int, n_src: int, block_size: int = BLOCK,
                device: str | torch.device | None = None) -> BlockTiles:
    """Edges ``src -> dst`` with weights ``val`` (ones when None) as dense
    tiles: stable-sorted by ``dst_block * n_src_blocks + src_block``, one
    tile per distinct key (duplicate edges summed in edge order), a zero
    tile (``tile_src = 0``) appended for each destination block with no
    edge, then stable-sorted by ``tile_dst``.  Runs on ``src``'s device
    when it is a tensor, else on ``device`` (default ``cuda``)."""
    src, dst, val, dev = _edges(src, dst, val, device)
    bs = block_size
    n_db, n_sb = -(-n_dst // bs), -(-n_src // bs)
    key, order = torch.sort((dst // bs) * n_sb + src // bs, stable=True)
    src, dst, val = src[order], dst[order], val[order]
    uniq, inverse = torch.unique_consecutive(key, return_inverse=True)
    # every destination block gets a tile (a zero one if need be) so that
    # its first visit happens
    present = torch.zeros(n_db, dtype=torch.bool, device=dev)
    present[uniq // n_sb] = True
    missing = torch.nonzero(~present).squeeze(1)
    t_dst = torch.cat([uniq // n_sb, missing])
    t_src = torch.cat([uniq % n_sb, torch.zeros_like(missing)])
    t_dst, reorder = torch.sort(t_dst, stable=True)
    t_src = t_src[reorder]
    T = int(t_dst.shape[0])
    pos = torch.empty_like(reorder)
    pos[reorder] = torch.arange(T, device=dev)
    flat = (pos[inverse] * bs + dst % bs) * bs + src % bs
    tiles = torch.zeros(T * bs * bs, dtype=torch.float32, device=dev)
    tiles.index_put_((flat,), val, accumulate=True)
    first = torch.ones(T, dtype=torch.int32, device=dev)
    first[1:] = (t_dst[1:] != t_dst[:-1]).to(torch.int32)
    t_dst = t_dst.to(torch.int32)
    occ = float(val.shape[0]) / float(T * bs * bs)
    return BlockTiles(tiles.view(T, bs, bs), t_src.to(torch.int32), t_dst, first,
                      n_db, n_sb, bs, occ)


def rows_from_tiles(bt: BlockTiles) -> BlockRows:
    """The matrix of ``bt`` as rows (``n_out_blocks * bs`` by
    ``n_src_blocks * bs``): its nonzeros in tile order, so each row's
    entries keep the order in which the tiles add them."""
    bs = bt.block_size
    t, r, c = torch.nonzero(bt.tiles, as_tuple=True)
    dst = bt.tile_dst.long()[t] * bs + r
    src = bt.tile_src.long()[t] * bs + c
    return build_rows(src, dst, bt.tiles[t, r, c], bt.n_out_blocks * bs,
                      bt.n_src_blocks * bs)


def check_kernel_args(rows: BlockRows, x, n_out: int) -> None:
    """Raise unless K4 covers these arguments: contiguous float32 ``x
    [n >= 1, F]``, int64 ``row_ptr [n_out + 1]``, int32 ``col [nnz]`` and
    float32 ``val [nnz]``, all on x's device, and ``0 <= n_out <=
    rows.n_out``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"gather_segsum: x must be a tensor, got {type(x).__name__}")
    dev = x.device
    _launch.require(x, "gather_segsum: x", torch.float32, dev)
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"gather_segsum: x must be [n >= 1, F], got {tuple(x.shape)}")
    _launch.require(rows.row_ptr, "gather_segsum: row_ptr", torch.int64, dev, rows.n_out + 1)
    _launch.require(rows.col, "gather_segsum: col", torch.int32, dev)
    if rows.col.dim() != 1:
        raise ValueError(f"gather_segsum: col must be [nnz], got {tuple(rows.col.shape)}")
    _launch.require(rows.val, "gather_segsum: val", torch.float32, dev, rows.col.shape[0])
    if not 0 <= n_out <= rows.n_out:
        raise ValueError(f"gather_segsum: n_out {n_out} outside [0, {rows.n_out}]")


def _lanes_per_edge(F: int) -> int:
    """Lanes that share one edge's x row, 4 columns each: 1, 2, 4 or 8 at
    F <= 32; past that a warp, looping over 128-column chunks."""
    need = -(-F // 4)
    return next((g for g in (1, 2, 4, 8) if need <= g), 32)


def _edges_per_row(lanes: int, nnz: int, n_out: int) -> int:
    """Edges of one row in flight at once (the groups of ``lanes`` lanes on
    one row), a power of two within a warp: the largest at most a quarter
    of the mean row length (each group keeps 4 more in flight), raised
    until the launch has two 128-thread CTAs per SM of an H100."""
    e = 1
    while 2 * e * lanes <= 32 and (8 * e * n_out <= nnz or e * lanes * n_out < _FILL_THREADS):
        e *= 2
    return e


def gather_segsum(rows: BlockRows, x: torch.Tensor, n_out: int) -> torch.Tensor:
    """``out[r] = sum_{e in row r} val[e] * x[col[e]]`` for the first
    ``n_out`` rows -> ``[n_out, F]``; rows of x past its end read as 0.

    On CUDA, K4 gives each row a team of lanes (:func:`_lanes_per_edge` x
    :func:`_edges_per_row`), sums each group's edges in order and the
    groups with a fixed shuffle tree, and writes the row once: no atomics,
    the same bits every run.
    """
    global launches
    dev = getattr(x, "device", None)
    if dev is not None and dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_segsum: unsupported device {dev}")
    check_kernel_args(rows, x, n_out)
    if dev.type == "cpu":
        return spmm_rows_ref(rows, x)[:n_out]
    n, f = x.shape
    out = torch.empty((n_out, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    g = _lanes_per_edge(f)
    e = _edges_per_row(g, rows.col.shape[0], n_out)
    vec = int(f % 4 == 0 and x.data_ptr() % 16 == 0)
    fn = _launch.bind("gather_segsum", "gather_segsum_launch", _ARGTYPES)
    err = fn(rows.row_ptr.data_ptr(), rows.col.data_ptr(), rows.val.data_ptr(),
             x.data_ptr(), out.data_ptr(), n_out, n, f, g, e, vec,
             _launch.stream_ptr(x.device))
    _launch.check(err, "gather_segsum_launch")
    launches += 1
    return out
