"""suffix_init_roofline (layer: kernels): ``suffix_init``'s share, in
percent, of its roofline over the traced stretch: the least time the
entry needs (the larger of its bytes at the memory rate and its
operations at the float32 rate, a launch at a time) over the device time
of the same launches (its three kernels, ``suffix_init_count``,
``_scatter`` and ``_bins``, from the profiler).  Its launches in a tick:
the warm peel's prologue and the ``w0`` bookkeeping.

What the entry needs, whatever kernel does it, for slots ``src``,
``dst``, ``c``, ``edge_mask`` and the vertex set ``live`` with priors
``a``: every slot's mask byte read; both ends (int32) of each masked
slot; the weight (float32) of each slot with both ends in the set; the
output ``both`` (a byte a slot) written; the set's byte of every vertex
read, the prior of each vertex in it read; the output weights (float32 a
vertex; float64 sums with ``acc``) and the total written.  Operations:
two adds an induced slot (one at each end), one more for the total, and
one a vertex in the set.
"""

ENTRIES = ("repro_torch.core.peel:suffix_init", "repro_torch.core.incremental:suffix_init")
KERNELS = ("suffix_init_count", "suffix_init_scatter", "suffix_init_bins")


def work(src, dst, c, edge_mask, live, a, acc=None):
    E, V = src.shape[0], live.shape[0]
    both = live[src.long()] & live[dst.long()] & edge_mask
    n_both, n_live = both.sum(), live.sum()
    out_bytes = 8 * (V + 1) if acc is not None else 4 * V + 4
    nbytes = E + 8 * edge_mask.sum() + 4 * n_both + E + V + 4 * n_live + out_bytes
    ops = 3 * n_both + n_live
    return nbytes, ops


def read(r):
    return r.roofline("suffix_init_roofline", KERNELS)
