"""Wrapper of the flash-attention forward kernel (K3, ``csrc/flash_attention.cu``).

On CPU tensors it runs :func:`flash_attention_ref`; on CUDA tensors it
launches the kernel or raises (:func:`check_kernel_args` says what the
kernel covers).  ``launches`` counts kernel launches (not CPU calls).
The kernel reads q, k and v through TMA tensor maps; :func:`tma_fields`
computes each map's dims, byte strides and box here, and the C launcher
encodes them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _launch
from .ref import flash_attention_ref

__all__ = ["flash_attention", "check_kernel_args", "tma_fields", "smem_bytes", "launches",
           "HEAD_DIMS", "TILE_Q", "TILE_K", "BOX_COLS"]

launches = 0
HEAD_DIMS = (64, 128)
TILE_Q = 128  # query rows per CTA (csrc/flash_attention.cu kBM)
TILE_K = 128  # keys per kv tile (kBN)
BOX_COLS = 64  # head-dim columns per TMA box: 128 bytes, the swizzle span
_ENCODE_ERROR = 10000  # the launcher's code for a tensor map that will not encode
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_uint64)] + [ctypes.c_int] * 6
             + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_void_p])


def tma_fields(t: torch.Tensor, rows: int) -> tuple[int, ...]:
    """The TMA tensor-map fields of a bf16 ``[B, H, S, D]`` tensor read in
    place: dims ``(D, S, H, B)``, the byte strides of S, H and B, and the
    box ``(BOX_COLS, rows)``.  Raises unless the last stride is 1, the data
    is 16-byte aligned and every other stride is a multiple of 16 bytes
    (what TMA takes)."""
    if t.dim() != 4:
        raise ValueError(f"tma_fields: expected [B, H, S, D], got {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"tma_fields: strides {t.stride()} need a unit last stride")
    if t.data_ptr() % 16:
        raise ValueError("tma_fields: data is not 16-byte aligned")
    B, H, S, D = t.shape
    sb, sh, ss = (x * t.element_size() for x in t.stride()[:3])
    for name, x in (("sequence", ss), ("head", sh), ("batch", sb)):
        if x % 16 or x >= 1 << 40:
            raise ValueError(f"tma_fields: {name} stride of {x} bytes is not a "
                             f"multiple of 16 below 2**40")
    return (D, S, H, B, ss, sh, sb, BOX_COLS, rows)


def smem_bytes(D: int) -> int:
    """Dynamic shared memory of one K3 CTA at head dim ``D`` (builds the
    kernels on first use)."""
    fn = _launch.bind("flash_attention", "flash_attention_smem_bytes", [ctypes.c_int])
    return fn(D)


def check_kernel_args(q, k, v, window=None) -> None:
    """Raise unless K3 covers these arguments: bf16 q/k/v on one device,
    ``q [B, Hq, Sq, D]`` and ``k/v [B, Hkv, Skv, D]`` with ``D`` in
    :data:`HEAD_DIMS` and ``Hq % Hkv == 0``, a unit last stride, the other
    strides multiples of 8 elements and 16-byte aligned data (what the
    kernel's TMA tensor maps take), and ``window`` None or >= 1."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be a 4-d tensor")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the kernel "
                            f"takes torch.bfloat16 only")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} strides {t.stride()} need a "
                             f"unit last stride and the others multiples of 8")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} data is not 16-byte aligned")
    B, Hq, Sq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"flash_attention: {Hq} q heads over {k.shape[1]} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")


def flash_attention(q, k, v, *, causal=True, window=None, block_q=512, block_k=1024):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D].

    Any strides with a unit last stride; on CUDA the output has q's
    strides (``empty_like``), so a permuted view of the model layout
    ``[B, S, Hq, D]`` comes back as one.  ``block_q``/``block_k`` tile the
    plain CPU path only; the kernel's tiles are fixed (TILE_Q x TILE_K).
    """
    global launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   block_q=block_q, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_kernel_args(q, k, v, window)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.stride(-1) != 1 or any(s % 8 for s in out.stride()[:3]):
        raise ValueError(f"flash_attention: output strides {out.stride()} unusable")
    if out.numel() == 0:
        return out
    maps = (ctypes.c_uint64 * 27)(*tma_fields(q, TILE_Q), *tma_fields(k, TILE_K),
                                  *tma_fields(v, TILE_K))
    fn = _launch.bind("flash_attention", "flash_attention_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), maps,
             B, Hq, Hkv, Sq, Skv, D, out.stride(0), out.stride(1), out.stride(2),
             int(bool(causal)), 0 if window is None else int(window),
             math.log2(math.e) / math.sqrt(D), _launch.stream_ptr(q.device))
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"flash_attention_launch: cuTensorMapEncodeTiled failed "
                           f"with CUresult {err - _ENCODE_ERROR}")
    _launch.check(err, "flash_attention_launch")
    launches += 1
    return out
