from .ops import check_kernel_args, flash_attention, tma_fields
from .ref import attention_ref, flash_attention_ref

__all__ = ["flash_attention", "check_kernel_args", "tma_fields", "attention_ref",
           "flash_attention_ref"]
