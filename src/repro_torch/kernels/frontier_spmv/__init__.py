from .ops import frontier_spmv
from .ref import frontier_spmv_ref

__all__ = ["frontier_spmv", "frontier_spmv_ref"]
