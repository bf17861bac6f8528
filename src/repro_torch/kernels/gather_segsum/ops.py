"""Block tiling and the wrapper of the block-sparse SpMM kernel (K4,
``csrc/gather_segsum.cu``), port of ``repro/kernels/gather_segsum/ops.py``.

:func:`build_tiles` buckets COO edges into dense 128x128 tiles on the
tensors' own device (no Python loop per tile, no host copy of the tiles)
and returns the same arrays as the reference's ``build_tiles``.
:func:`gather_segsum` runs :func:`block_spmm`: on CPU tensors its plain
version :func:`block_spmm_ref`, on CUDA tensors the kernel (or it raises).
``launches`` counts kernel launches (not CPU calls).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _launch
from .ref import block_spmm_ref

__all__ = ["BlockTiles", "build_tiles", "block_spmm", "gather_segsum", "check_kernel_args",
           "launches", "BLOCK"]

launches = 0
BLOCK = 128  # the kernel's tile edge
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_void_p]


@dataclass
class BlockTiles:
    """Dense tiles of a sparse matrix, sorted by destination block.

    Construction checks that ``tile_dst`` is sorted (one read of the device,
    once per tile set) and derives ``run_start``: the tiles of output block
    ``b`` are ``[run_start[b], run_start[b + 1])``, the run K4 walks.
    """

    tiles: torch.Tensor  # [T, bs, bs] f32, A[dst_local, src_local]
    tile_src: torch.Tensor  # [T] i32
    tile_dst: torch.Tensor  # [T] i32 (sorted)
    first_visit: torch.Tensor  # [T] i32
    n_out_blocks: int
    n_src_blocks: int
    block_size: int
    occupancy: float  # nnz / (T * bs * bs) — tile density diagnostic
    run_start: torch.Tensor = field(init=False, repr=False)  # [n_out_blocks + 1] i64

    def __post_init__(self):
        d = self.tile_dst
        if d.shape[0] > 1 and bool((d[1:] < d[:-1]).any()):
            raise ValueError("BlockTiles: tile_dst is not sorted")
        bounds = torch.arange(self.n_out_blocks + 1, dtype=d.dtype, device=d.device)
        self.run_start = torch.searchsorted(d, bounds)


def _as(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(a).to(device=dev, dtype=dtype)


def build_tiles(src, dst, val, n_dst: int, n_src: int, block_size: int = BLOCK,
                device: str | torch.device | None = None) -> BlockTiles:
    """Edges ``src -> dst`` with weights ``val`` (ones when None) as dense
    tiles: stable-sorted by ``dst_block * n_src_blocks + src_block``, one
    tile per distinct key (duplicate edges summed in edge order), a zero
    tile (``tile_src = 0``) appended for each destination block with no
    edge, then stable-sorted by ``tile_dst``.  Runs on ``src``'s device
    when it is a tensor, else on ``device`` (default ``cuda``)."""
    dev = src.device if isinstance(src, torch.Tensor) and device is None \
        else resolve_device(device)
    src, dst = _as(src, torch.int64, dev), _as(dst, torch.int64, dev)
    val = (torch.ones(src.shape[0], dtype=torch.float32, device=dev) if val is None
           else _as(val, torch.float32, dev))
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


def check_kernel_args(bt: BlockTiles, x) -> None:
    """Raise unless K4 covers these arguments: contiguous float32 ``tiles
    [T, 128, 128]`` and ``x [n, F]`` with ``n >= 1``, contiguous int32
    ``tile_src [T]`` and int64 ``run_start [n_out_blocks + 1]``, all on one
    device."""
    tiles = bt.tiles
    dev = tiles.device if isinstance(tiles, torch.Tensor) else None
    if dev is None or tiles.dim() != 3:
        raise ValueError("block_spmm: tiles must be a [T, bs, bs] tensor")
    if tuple(tiles.shape[1:]) != (BLOCK, BLOCK):
        raise ValueError(f"block_spmm: tile shape {tuple(tiles.shape[1:])}; the kernel "
                         f"takes block_size {BLOCK} only")
    _launch.require(tiles, "block_spmm: tiles", torch.float32, dev)
    _launch.require(bt.tile_src, "block_spmm: tile_src", torch.int32, dev, tiles.shape[0])
    _launch.require(bt.run_start, "block_spmm: run_start", torch.int64, dev,
                    bt.n_out_blocks + 1)
    _launch.require(x, "block_spmm: x", torch.float32, dev)
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"block_spmm: x must be [n >= 1, F], got {tuple(x.shape)}")


def block_spmm(bt: BlockTiles, x: torch.Tensor) -> torch.Tensor:
    """``out[tile_dst[t]] += tiles[t] @ x[tile_src[t]]`` over all tiles ->
    ``[n_out_blocks * 128, F]``; x is read in place, rows past its end as 0.

    On CUDA, one CTA of K4 per (output block, column tile) walks the block's
    run of tiles (``bt.run_start``), so each output block is written once
    and ``first_visit`` is implied.
    """
    global launches
    if x.device.type == "cpu":
        return block_spmm_ref(bt.tiles, bt.tile_src, bt.tile_dst, bt.first_visit, x,
                              bt.n_out_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"block_spmm: unsupported device {x.device}")
    check_kernel_args(bt, x)
    n, f = x.shape
    out = torch.empty((bt.n_out_blocks * BLOCK, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    fn = _launch.bind("gather_segsum", "gather_segsum_launch", _ARGTYPES)
    err = fn(bt.tiles.data_ptr(), bt.tile_src.data_ptr(), bt.run_start.data_ptr(),
             x.data_ptr(), out.data_ptr(), bt.n_out_blocks, n, f, out.shape[0],
             _launch.stream_ptr(x.device))
    _launch.check(err, "gather_segsum_launch")
    launches += 1
    return out


def gather_segsum(bt: BlockTiles, x: torch.Tensor, n_out: int) -> torch.Tensor:
    """``out[d] = sum_e val_e * x[src_e]`` over the tiled edges -> ``[n_out, F]``."""
    return block_spmm(bt, x)[:n_out]
