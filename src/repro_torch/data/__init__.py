"""Data pipeline: synthetic token batches, transaction streams (see
repro_torch.graphstore.generators), graph batches (see
repro_torch.launch.cells)."""
