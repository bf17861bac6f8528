"""Wrapper of the flash-attention forward kernel (K3, ``csrc/flash_attention.cu``).

On CPU tensors it runs :func:`flash_attention_ref`; on CUDA tensors it
launches the kernel or raises (:func:`check_kernel_args` says what the
kernel covers).  ``launches`` counts kernel launches (not CPU calls).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from .ref import flash_attention_ref

__all__ = ["flash_attention", "check_kernel_args", "launches", "HEAD_DIMS"]

launches = 0
HEAD_DIMS = (64, 128)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def check_kernel_args(q, k, v, window=None) -> None:
    """Raise unless K3 covers these arguments: bf16 q/k/v on one device,
    ``q [B, Hq, Sq, D]`` and ``k/v [B, Hkv, Skv, D]`` with ``D`` in
    :data:`HEAD_DIMS` and ``Hq % Hkv == 0``, a unit last stride, the other
    strides multiples of 8 elements and 16-byte aligned data (the kernel
    copies 16-byte chunks), and ``window`` None or >= 1."""
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
    plain CPU path only; the kernel's tiles are fixed (64 x 64).
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
    fn = _launch.bind("flash_attention", "flash_attention_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Hq, Hkv, Sq, Skv, D,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(1), out.stride(2),
             int(bool(causal)), 0 if window is None else int(window),
             1.0 / D ** 0.5, _launch.stream_ptr(q.device))
    _launch.check(err, "flash_attention_launch")
    launches += 1
    return out
