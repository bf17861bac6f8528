"""Wrappers of K2 (``csrc/frontier_spmv.cu``), the peel's edge pass.

* :func:`frontier_spmv` — a round's edge half.  It updates ``alive`` in
  place: the slots that leave the restricted set are cleared and no other
  byte is written.  The reference (``repro/core/peel.py:201-210``) is
  pure; here each peel owns its liveness tensor (``core/peel.py`` makes it
  once per peel) and every round updates that one tensor.  ``dw`` is a
  float64 accumulator: the kernel scatters into it, which makes its
  float32 rounding (done by the round's elementwise kernel) the same on
  every run; the plain version adds its float32 sums into it.  A peel
  passes its own accumulator, which the elementwise kernel leaves zeroed,
  so a round needs no memset.
* :func:`suffix_init` — the warm peel's prologue, the induced weights of
  the restricted set (``repro/core/peel.py:324-329``): a count pass, a
  scatter of (vertex, c) pairs binned by vertex range, and one CTA a bin
  adding its pairs in shared memory.  Its bins (:func:`bin_shift`) and its
  pair buffer (:func:`prologue_scratch_bytes`, kept per device and grown to
  the largest E seen) are sized here.  Its float64 mode (``acc=``) hands
  back the sums before ``a`` is added and before rounding, so an
  edge-sharded peel (``repro_torch.dist.graph``) adds the ranks' sums in
  float64 and rounds once.

On CPU tensors each runs its plain version (:mod:`.ref`), which keeps the
same contract; on CUDA tensors each launches its kernel or raises.
``launches`` and ``suffix_init_launches`` count kernel launches (not CPU
calls).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from .ref import frontier_spmv_ref, suffix_init_ref

__all__ = ["frontier_spmv", "suffix_init", "launches", "suffix_init_launches", "bin_shift",
           "prologue_scratch_bytes"]

launches = 0
suffix_init_launches = 0
# how K2's round launches split their slots (_vector_split): the slots
# before alive's first 16-byte boundary, on the scalar path, and the
# launches whose word arrays were off the vector alignment (all scalar)
head_slots = 0
unaligned_launches = 0
_SLOTS = 16  # edge slots per thread on the vector path (one 16-byte alive load)
_CAP = 4096  # most blocks of one launch: room for their partial sums
_VEC = 16  # bytes of one vector load
_MAX_SHIFT = 13  # the prologue's bins hold at most 2^13 vertices (64 KB of float64)
_MIN_SHIFT = 8
_MAX_BINS = 8192  # csrc kMaxBins: so V <= 2^26
_PAIR_BYTES = 8  # a (vertex, c) pair of the prologue's scatter
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ROUND_ARGS = [_P] * 9 + [_I64] * 3 + [ctypes.c_int, _P]
_SUFFIX_ARGS = [_P] * 17 + [_I64] * 3 + [ctypes.c_int] * 3 + [_P]


def _vector_split(n: int, alive_ptr: int, *word_ptrs: int) -> tuple[int, int]:
    """``(head, n_groups)``: the slots before alive's first 16-byte boundary
    take the scalar path, then groups of 16 slots are read as vectors, if
    every int32/float32 array is 16-byte aligned there; else no group."""
    head = min((-alive_ptr) % _VEC, n)
    if any((p + 4 * head) % _VEC for p in word_ptrs):
        return 0, 0
    return head, (n - head) // _SLOTS


_tickets: dict[torch.device, torch.Tensor] = {}


def _ticket(dev) -> torch.Tensor:
    """The round kernel's block ticket on ``dev``: zeroed once, and left 0
    by every launch (its last block resets it)."""
    if dev not in _tickets:
        _tickets[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _tickets[dev]


def bin_shift(V: int) -> int:
    """log2 of the prologue's bin: ``2**shift`` consecutive vertices whose
    float64 sums one CTA keeps in shared memory: bins of at least 256
    vertices, 65 to 128 bins from V = 2^15 to 2^20, bins of 8,192 vertices
    from there on; raises past ``8192 * 2**13`` vertices (the kernel's most
    bins)."""
    if V < 1:
        raise ValueError(f"suffix_init: {V} vertices")
    shift = min(_MAX_SHIFT, max(_MIN_SHIFT, (V - 1).bit_length() - 7))
    if -(-V // (1 << shift)) > _MAX_BINS:
        raise ValueError(f"suffix_init: {V} vertices exceed the kernel's "
                         f"{_MAX_BINS} bins of {1 << _MAX_SHIFT}")
    return shift


def prologue_scratch_bytes(E: int) -> int:
    """Bytes of the prologue's pair buffer for E slots: room for two
    (vertex, c) pairs a slot, what every slot being induced would need."""
    return 2 * _PAIR_BYTES * max(E, 1)


class _Scratch:
    """The prologue's scratch on one device: the pair buffer, and the
    per-bin counts, region starts and cursors with the two tickets (the
    counts and tickets hold zeros between calls; the kernels leave them
    so), and the block partials."""

    def __init__(self, dev: torch.device, E: int):
        self.pairs = torch.empty(prologue_scratch_bytes(E), dtype=torch.uint8, device=dev)
        # bin_count | ticket x 2 | bin_start (n + 1) | cursor
        self.bins = torch.zeros(3 * _MAX_BINS + 3, dtype=torch.int32, device=dev)
        self.partials = torch.empty(_CAP + _MAX_BINS, dtype=torch.float32, device=dev)

    def ptrs(self) -> list[int]:
        b = self.bins
        return [self.pairs.data_ptr(), b.data_ptr(), b[_MAX_BINS + 2:].data_ptr(),
                b[2 * _MAX_BINS + 3:].data_ptr(), b[_MAX_BINS:].data_ptr(),
                self.partials.data_ptr(), self.partials[_CAP:].data_ptr()]


_scratch: dict[torch.device, _Scratch] = {}


def _prologue_scratch(dev, E: int) -> _Scratch:
    """The prologue's scratch on ``dev``, made once and remade only when a
    larger E needs a larger pair buffer."""
    s = _scratch.get(dev)
    if s is None or s.pairs.numel() < prologue_scratch_bytes(E):
        _scratch.pop(dev, None)
        s = _scratch[dev] = _Scratch(dev, E)
    return s


def frontier_spmv(src, dst, c, alive, peel, dw):
    """Returns ``(dw, drop_mass float32 scalar)``: adds the round's ``dw``
    into ``dw``, a float64 [V] accumulator holding zeros, and clears, in
    place, the ``alive`` bytes of live slots with a peeled end.

    ``src/dst`` int32 [E] endpoints in ``[0, V)``, ``c`` float32 [E],
    ``alive`` bool [E] (updated), ``peel`` bool [V] (the round's peel mask).
    Views are taken as they are; slots before alive's first 16-byte
    boundary run on the kernel's scalar path.
    """
    global launches, head_slots, unaligned_launches
    dev = src.device
    if dev.type == "cpu":
        return frontier_spmv_ref(src, dst, c, alive, peel, dw)
    if dev.type != "cuda":
        raise ValueError(f"frontier_spmv: unsupported device {dev}")
    E, V = src.shape[0], peel.shape[0]
    _launch.require(src, "src", torch.int32, dev, numel=E)
    _launch.require(dst, "dst", torch.int32, dev, numel=E)
    _launch.require(c, "c", torch.float32, dev, numel=E)
    _launch.require(alive, "alive", torch.bool, dev, numel=E)
    _launch.require(peel, "peel", torch.bool, dev, numel=V)
    _launch.require(dw, "dw", torch.float64, dev, numel=V)
    if E == 0:
        return dw, torch.zeros((), dtype=torch.float32, device=dev)
    drop = torch.empty((), dtype=torch.float32, device=dev)
    partials = torch.empty(_CAP, dtype=torch.float32, device=dev)
    head, n_groups = _vector_split(E, alive.data_ptr(), src.data_ptr(), dst.data_ptr())
    fn = _launch.bind("frontier_spmv", "frontier_spmv_launch", _ROUND_ARGS)
    err = fn(src.data_ptr(), dst.data_ptr(), c.data_ptr(), alive.data_ptr(),
             peel.data_ptr(), dw.data_ptr(), partials.data_ptr(), _ticket(dev).data_ptr(),
             drop.data_ptr(), E, head, n_groups, _CAP, _launch.stream_ptr(dev))
    _launch.check(err, "frontier_spmv_launch")
    launches += 1
    head_slots += head
    unaligned_launches += n_groups == 0 and E - head >= _SLOTS
    return dw, drop


def suffix_init(src, dst, c, edge_mask, live, a, acc=None):
    """Returns ``(w0 [V] float32, f0 float32 scalar, both [E] bool)``:
    ``both = live[src] & live[dst] & edge_mask``; ``w0`` is
    ``where(live, a, 0)`` plus the ``both``-masked ``c`` scattered to both
    ends; ``f0`` sums ``where(live, a, 0)`` and the ``both``-masked ``c``.

    ``src/dst`` int32 [E], ``c`` float32 [E], ``edge_mask`` bool [E],
    ``live`` bool [V], ``a`` float32 [V].  ``both`` is a fresh tensor.

    The float64 mode: given ``acc``, a float64 [V + 1] tensor, writes the
    ``both``-masked ``c`` at each vertex into ``acc[:V]`` (float64, no
    ``a``, not rounded) and the edge part of ``f0`` into ``acc[V]`` (the
    float32 sum, widened), and returns ``(acc, vsum, both)`` with ``vsum``
    the float32 sum of ``where(live, a, 0)``.  Then
    ``where(live, float(double(a) + acc[:V]), 0)`` is ``w0`` and
    ``float(double(vsum) + acc[V])`` is ``f0``, bit for bit.
    """
    global suffix_init_launches
    dev = src.device
    if dev.type == "cpu":
        return suffix_init_ref(src, dst, c, edge_mask, live, a, acc=acc)
    if dev.type != "cuda":
        raise ValueError(f"suffix_init: unsupported device {dev}")
    E, V = src.shape[0], live.shape[0]
    _launch.require(src, "src", torch.int32, dev, numel=E)
    _launch.require(dst, "dst", torch.int32, dev, numel=E)
    _launch.require(c, "c", torch.float32, dev, numel=E)
    _launch.require(edge_mask, "edge_mask", torch.bool, dev, numel=E)
    _launch.require(live, "live", torch.bool, dev, numel=V)
    _launch.require(a, "a", torch.float32, dev, numel=V)
    if acc is not None:
        _launch.require(acc, "acc", torch.float64, dev, numel=V + 1)
    if E >= 1 << 31:
        raise ValueError(f"suffix_init: {E} slots; the pair buffer is indexed by uint32")
    shift = bin_shift(V)
    scratch = _prologue_scratch(dev, E)
    w0 = torch.empty(V, dtype=torch.float32, device=dev) if acc is None else acc
    f0 = torch.empty((), dtype=torch.float32, device=dev)
    both = torch.empty(E, dtype=torch.bool, device=dev)
    aligned = all(t.data_ptr() % _VEC == 0 for t in (src, dst, edge_mask, both))
    n_groups = E // _VEC if aligned else 0
    vec = int(aligned and c.data_ptr() % _VEC == 0)
    fn = _launch.bind("frontier_spmv", "suffix_init_launch", _SUFFIX_ARGS)
    err = fn(src.data_ptr(), dst.data_ptr(), c.data_ptr(), edge_mask.data_ptr(),
             live.data_ptr(), a.data_ptr(), None if acc is not None else w0.data_ptr(),
             both.data_ptr(), *scratch.ptrs(), f0.data_ptr(),
             None if acc is None else acc.data_ptr(), E, V, n_groups, vec, shift, _CAP,
             _launch.stream_ptr(dev))
    _launch.check(err, "suffix_init_launch")
    suffix_init_launches += 1
    return w0, f0, both
