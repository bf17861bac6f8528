"""LM models of the port (serving half): attention, layers, transformer."""

from .attention import decode_attention, flash_attention
from .transformer import (DecoderLayer, KVCache, TransformerLM, cache_window,
                          decode_step, prefill)

__all__ = ["decode_attention", "flash_attention", "DecoderLayer", "KVCache",
           "TransformerLM", "cache_window", "decode_step", "prefill"]
