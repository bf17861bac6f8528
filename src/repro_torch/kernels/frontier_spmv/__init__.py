from .ops import frontier_spmv, suffix_init
from .ref import frontier_spmv_ref, suffix_init_ref

__all__ = ["frontier_spmv", "frontier_spmv_ref", "suffix_init", "suffix_init_ref"]
