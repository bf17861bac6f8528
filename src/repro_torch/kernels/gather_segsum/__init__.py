from .ops import (BlockRows, BlockTiles, build_rows, build_tiles, check_kernel_args,
                  gather_segsum, rows_from_tiles)
from .ref import block_spmm_ref, spmm_ref, spmm_rows_ref

__all__ = ["BlockRows", "BlockTiles", "build_rows", "build_tiles", "check_kernel_args",
           "gather_segsum", "rows_from_tiles", "block_spmm_ref", "spmm_ref", "spmm_rows_ref"]
