from .ops import BlockTiles, block_spmm, build_tiles, check_kernel_args, gather_segsum
from .ref import block_spmm_ref, spmm_ref

__all__ = ["BlockTiles", "block_spmm", "build_tiles", "check_kernel_args", "gather_segsum",
           "block_spmm_ref", "spmm_ref"]
