from .ops import FlashAttention, check_kernel_args, flash_attention, tma_fields
from .ref import attention_ref, flash_attention_bwd_ref, flash_attention_ref

__all__ = ["FlashAttention", "flash_attention", "check_kernel_args", "tma_fields",
           "attention_ref", "flash_attention_bwd_ref", "flash_attention_ref"]
