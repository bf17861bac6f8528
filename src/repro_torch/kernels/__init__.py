"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

* ``peel_round`` — the elementwise half of a bulk-peeling round (port of
  the Pallas ``repro.kernels.peel_round`` kernel).
* ``frontier_spmv`` — the round's edge half: the SpMV over the peeled
  frontier, the dropped edge mass and the edge-liveness update, in one
  pass over the edge slots.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built from ``csrc/`` at first use) or raises.
"""
