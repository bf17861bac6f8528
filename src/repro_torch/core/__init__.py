"""Spade core on PyTorch: bulk peeling, incremental maintenance and the
fraud-semantics registry (device plane only; the host oracle is still to
be ported)."""
