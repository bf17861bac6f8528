"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

* ``peel_round`` — the elementwise half of a bulk-peeling round (port of
  the Pallas ``repro.kernels.peel_round`` kernel).
* ``frontier_spmv`` — the peel's edge pass, two entries: the round's edge
  half (the SpMV over the peeled frontier, the dropped edge mass and the
  edge-liveness update in place, one pass over the edge slots) and
  ``suffix_init``, every peel's prologue (the restricted set's weights,
  total and induced edges).
* ``flash_attention`` — the causal / sliding-window GQA attention forward
  of the LM (port of the Pallas ``repro.kernels.flash_attention`` kernel),
  bf16 on the tensor cores.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built from ``csrc/`` at first use) or raises.
"""
