"""Wrapper of the flash-attention forward kernel (K3, ``csrc/flash_attention.cu``).

On CPU tensors it runs :func:`flash_attention_ref`; on CUDA tensors it
launches one of K3's two bodies or raises (:func:`check_kernel_args` says
what K3 covers): bf16 with a head dim in :data:`HEAD_DIMS` runs the
tensor-core body, any other float32, float16 or bf16 input up to
:data:`MAX_HEAD_DIM` the SIMT body (f32 FFMA), as the Pallas kernel takes
any float dtype and head dim.  ``launches`` counts the tensor-core body's
launches and ``simt_launches`` the SIMT body's (not CPU calls).  The
tensor-core body reads q, k and v through TMA tensor maps;
:func:`tma_fields` computes each map's dims, byte strides and box here,
and the C launcher encodes them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _launch
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["FlashAttention", "flash_attention", "check_kernel_args", "tma_fields", "smem_bytes",
           "launches", "simt_launches", "HEAD_DIMS", "MAX_HEAD_DIM", "TILE_Q", "TILE_K",
           "BOX_COLS"]

launches = 0
simt_launches = 0
HEAD_DIMS = (64, 128)  # the tensor-core body's head dims (bf16)
MAX_HEAD_DIM = 256  # the SIMT body's largest head dim
_SIMT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TILE_Q = 128  # query rows per CTA (csrc/flash_attention.cu kBM)
TILE_K = 128  # keys per kv tile (kBN)
BOX_COLS = 64  # head-dim columns per TMA box: 128 bytes, the swizzle span
_ENCODE_ERROR = 10000  # the launcher's code for a tensor map that will not encode
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_uint64)] + [ctypes.c_int] * 6
             + [ctypes.c_int64] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
_SIMT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int64)]
                  + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])


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


def tensor_core_body(q) -> bool:
    """Whether K3 runs ``q`` (and its k, v) on its tensor-core body: bf16
    with a head dim in :data:`HEAD_DIMS`."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in HEAD_DIMS


def check_kernel_args(q, k, v, window=None, q_offset=0) -> None:
    """Raise unless K3 covers these arguments: q/k/v of one dtype (float32,
    float16 or bf16) on one device, ``q [B, Hq, Sq, D]`` and
    ``k/v [B, Hkv, Skv, D]`` with ``1 <= D <=`` :data:`MAX_HEAD_DIM` and
    ``Hq % Hkv == 0``, a unit last stride, ``window`` None or >= 1 and
    ``0 <= q_offset < 2**31 - Sq``.
    For the tensor-core body (:func:`tensor_core_body`) the other strides
    must be multiples of 8 elements and the data 16-byte aligned (what its
    TMA tensor maps take)."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be a 4-d tensor")
        if t.dtype not in _SIMT_DTYPES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the kernel takes "
                            f"torch.float32, torch.float16 or torch.bfloat16")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} strides {t.stride()} need a "
                             f"unit last stride")
        if tensor_core_body(q):
            if any(s % 8 for s in t.stride()[:3]):
                raise ValueError(f"flash_attention: {name} strides {t.stride()} need "
                                 f"multiples of 8 for the tensor-core body")
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} data is not 16-byte aligned")
    B, Hq, Sq, D = q.shape
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} not in [1, {MAX_HEAD_DIM}]")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"flash_attention: {Hq} q heads over {k.shape[1]} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if not 0 <= q_offset < 2 ** 31 - Sq:
        raise ValueError(f"flash_attention: q_offset {q_offset} not in [0, 2**31 - {Sq})")


def flash_attention(q, k, v, *, causal=True, window=None, block_q=512, block_k=1024,
                    q_offset=0):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D], query
    row i at position ``i + q_offset`` for the causal and window masks (the
    rows of one shard of a sequence-sharded q; 0: the reference's
    left-aligned queries).

    Any strides with a unit last stride; on CUDA the output has q's
    strides (``empty_like``), so a permuted view of the model layout
    ``[B, S, Hq, D]`` comes back as one.  ``block_q``/``block_k`` tile the
    plain CPU path only; the kernel's tiles are fixed.
    """
    global launches, simt_launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   block_q=block_q, block_k=block_k, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_kernel_args(q, k, v, window, q_offset)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if not tensor_core_body(q):
        strides = (ctypes.c_int64 * 12)(*(x for t in (q, k, v, out) for x in t.stride()[:3]))
        fn = _launch.bind("flash_attention", "flash_attention_simt_launch", _SIMT_ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                 B, Hq, Hkv, Sq, Skv, D, _SIMT_DTYPES[q.dtype], int(bool(causal)),
                 0 if window is None else int(window), int(q_offset), 1.0 / D ** 0.5,
                 _launch.stream_ptr(q.device))
        _launch.check(err, "flash_attention_simt_launch")
        simt_launches += 1
        return out
    if out.stride(-1) != 1 or any(s % 8 for s in out.stride()[:3]):
        raise ValueError(f"flash_attention: output strides {out.stride()} unusable")
    maps = (ctypes.c_uint64 * 27)(*tma_fields(q, TILE_Q), *tma_fields(k, TILE_K),
                                  *tma_fields(v, TILE_K))
    fn = _launch.bind("flash_attention", "flash_attention_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), maps,
             B, Hq, Hkv, Sq, Skv, D, out.stride(0), out.stride(1), out.stride(2),
             int(bool(causal)), 0 if window is None else int(window), int(q_offset),
             math.log2(math.e) / math.sqrt(D), _launch.stream_ptr(q.device))
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"flash_attention_launch: cuTensorMapEncodeTiled failed "
                           f"with CUresult {err - _ENCODE_ERROR}")
    _launch.check(err, "flash_attention_launch")
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, window, block_q, block_k,
    q_offset)``: :func:`flash_attention` with a gradient for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, block_q=512, block_k=1024,
                q_offset=0):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, block_q, q_offset)
        # a meta tensor (the dry run's trace) holds no data to launch K3
        # on: it takes the plain version, for shapes and operation counts
        fwd = flash_attention_ref if q.device.type == "meta" else flash_attention
        return fwd(q, k, v, causal=causal, window=window, block_q=block_q, block_k=block_k,
                   q_offset=q_offset)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, block_q, q_offset = ctx.args
        with torch.profiler.record_function("flash_attention_backward"):
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, do, causal=causal, window=window,
                                                 block_q=block_q, q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None
