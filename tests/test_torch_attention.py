"""The port's attention (plain versions, on the CPU) and LM layers against
the JAX package on the same numpy inputs.

* ``repro_torch.kernels.flash_attention``: ``attention_ref``,
  ``flash_attention_ref`` and the wrapper's CPU path against
  ``repro.kernels.flash_attention.ref.attention_ref`` and the Pallas
  ``flash_attention_fwd`` in interpret mode (as ``tests/test_kernels.py``
  runs it), over the GQA, window, ragged and bf16 cases of its sweep.
* ``repro_torch.models.attention`` against ``repro.models.attention``:
  the blocked ``flash_attention`` in the model layout ``[B, S, Hkv, G, D]``
  and ``decode_attention`` (rolling and not).
* ``repro_torch.models.layers`` against ``repro.models.layers``.
* the argument check K3's wrapper runs before a launch, and the TMA
  tensor-map fields it computes for the kernel.

Tolerances: float32 at atol = rtol = 2e-5 (sums in another order), bf16
at 2e-2 (the tolerance ``tests/test_kernels.py`` gives the Pallas kernel in
bf16: one bf16 rounding of the output, and of the inputs to the matrix
products).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_ref, check_kernel_args,  # noqa: E402
                                                 flash_attention, flash_attention_ref,
                                                 tma_fields)
from repro_torch.kernels.flash_attention import ops as k3_ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2

# the GQA, window, ragged and bf16 cases of tests/test_kernels.py ATTN_SWEEP
ATTN_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window, dtype)
    (2, 4, 2, 256, 256, 64, True, None, "float32"),   # GQA
    (1, 4, 4, 384, 384, 64, True, 128, "float32"),    # sliding window
    (1, 2, 2, 200, 200, 64, True, None, "float32"),   # ragged (padding)
    (1, 2, 2, 128, 128, 64, True, None, "bfloat16"),
    # the edges of K3's 128 x 128 tiles: G = 5 (qwen3) with a window
    # narrower than a kv tile, S just past a tile in bf16 at D = 128, and
    # fewer queries than a tile over more keys, not causal
    (1, 10, 2, 200, 200, 64, True, 50, "float32"),
    (1, 4, 2, 129, 129, 128, True, None, "bfloat16"),
    (1, 4, 4, 70, 300, 64, False, None, "float32"),
]
IDS = ["gqa", "window", "ragged", "bf16", "g5-window-lt-tile", "d128-past-tile",
       "sq-lt-tile-not-causal"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round float32 to bf16 (nearest even) and return the bits as uint16."""
    return torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        bits = _bf16_bits(x)
        return (jnp.asarray(bits).view(jnp.bfloat16),
                torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, dtype):
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _qkv(B, Hq, Hkv, Sq, Skv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32))


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window,dtype", ATTN_CASES, ids=IDS)
def test_plain_attention_matches_jax(B, Hq, Hkv, Sq, Skv, D, causal, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in _qkv(B, Hq, Hkv, Sq, Skv, D))
    want_ref = j_attention_ref(jq, jk, jv, causal=causal, window=window)
    want_pallas = flash_attention_fwd(jq, jk, jv, causal=causal, window=window,
                                      block_q=128, block_k=128, interpret=True)
    dense = attention_ref(tq, tk, tv, causal=causal, window=window)
    blocked = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                  block_q=128, block_k=96)
    # the blocked version on the CUDA kernel's tiles
    tiled = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                block_q=k3_ops.TILE_Q, block_k=k3_ops.TILE_K)
    n0 = k3_ops.launches
    wrapped = flash_attention(tq, tk, tv, causal=causal, window=window,
                              block_q=64, block_k=128)
    assert k3_ops.launches == n0  # CPU tensors never launch the kernel
    for got in (dense, blocked, tiled, wrapped):
        assert got.dtype == tq.dtype and tuple(got.shape) == (B, Hq, Sq, D)
        _close(got, want_ref, dtype)
        _close(got, want_pallas, dtype)


def test_plain_attention_takes_strided_views():
    """The wrapper's inputs may be permuted views of the model layout."""
    B, S, Hkv, G, D = 1, 70, 2, 3, 64
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((B, S, Hkv * G, D), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
    views = (q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))
    got = flash_attention(*views, block_q=32, block_k=16)
    want = attention_ref(*(t.contiguous() for t in views))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("window", [None, 48], ids=["causal", "window"])
@pytest.mark.parametrize("S", [128, 150], ids=["even", "ragged"])
def test_model_flash_attention_matches_jax(S, window):
    B, Hkv, G, D = 2, 2, 2, 32
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, S, Hkv, G, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=True, window=window, q_block=64, kv_block=32)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True, window=window,
                                q_block=64, kv_block=32)
    assert tuple(got.shape) == (B, S, Hkv, G, D)
    _close(got, want, "float32")


@pytest.mark.parametrize("rolling,window", [(False, None), (True, None), (True, 5)],
                         ids=["flat", "rolling", "rolling-window"])
def test_decode_attention_matches_jax(rolling, window):
    B, W, Hkv, G, D = 3, 16, 2, 2, 32
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Hkv, G, D), dtype=np.float32)
    kc = rng.standard_normal((B, W, Hkv, D), dtype=np.float32)
    vc = rng.standard_normal((B, W, Hkv, D), dtype=np.float32)
    pos = np.array([3, 16, 37], np.int32)  # inside, at and past the cache width
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(pos), window=window, rolling=rolling)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), torch.from_numpy(pos),
                                 window=window, rolling=rolling)
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 3, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    (jx, tx), (js, ts) = _pair(x, dtype), _pair(scale, dtype)
    _close(tlayers.rms_norm(tx, ts), jlayers.rms_norm(jx, js), dtype)

    pos = np.array([0, 1, 7, 4095, 32767], np.int32)
    jc, jsn = jlayers.rope_angles(jnp.asarray(pos), 16, 1e6)
    tc, tsn = tlayers.rope_angles(torch.from_numpy(pos), 16, 1e6)
    # sin/cos of angles up to 3.3e4 rad: f32 argument reduction differs by ulps
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tsn.numpy(), np.asarray(jsn), atol=1e-4, rtol=0)
    jr = jlayers.apply_rope(jx, jc[None, :, None, :], jsn[None, :, None, :])
    tc, tsn = torch.from_numpy(np.array(jc)), torch.from_numpy(np.array(jsn))
    tr = tlayers.apply_rope(tx, tc[None, :, None, :], tsn[None, :, None, :])
    _close(tr, jr, dtype)

    h = rng.standard_normal((4, 16), dtype=np.float32)
    wg, wu = (rng.standard_normal((16, 24), dtype=np.float32) / 4 for _ in range(2))
    wd = rng.standard_normal((24, 16), dtype=np.float32) / 5
    pairs = [_pair(a, dtype) for a in (h, wg, wu, wd)]
    _close(tlayers.swiglu(*(t for _, t in pairs)), jlayers.swiglu(*(j for j, _ in pairs)),
           dtype)


def test_kernel_argument_check():
    """What K3 does not cover raises before any launch (checked on CPU
    tensors: the check does not look at the device type)."""
    bf = torch.bfloat16
    q = torch.zeros(1, 4, 8, 128, dtype=bf)
    kv = torch.zeros(1, 2, 8, 128, dtype=bf)
    check_kernel_args(q, kv, kv)  # covered: bf16, D = 128, G = 2
    check_kernel_args(q[..., :64].contiguous(), kv[..., :64].contiguous(),
                      kv[..., :64].contiguous(), window=4)  # D = 64
    with pytest.raises(TypeError, match="bfloat16"):
        check_kernel_args(q.float(), kv.float(), kv.float())
    with pytest.raises(TypeError, match="bfloat16"):
        check_kernel_args(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head dim"):
        d32 = torch.zeros(1, 2, 8, 32, dtype=bf)
        check_kernel_args(torch.zeros(1, 4, 8, 32, dtype=bf), d32, d32)
    with pytest.raises(ValueError, match="strides"):
        check_kernel_args(q.transpose(2, 3), kv, kv)
    with pytest.raises(ValueError, match="kv heads"):
        kv3 = torch.zeros(1, 3, 8, 128, dtype=bf)
        check_kernel_args(q, kv3, kv3)
    with pytest.raises(ValueError, match="window"):
        check_kernel_args(q, kv, kv, window=0)


# (tensor shape as allocated, permutation to [B, H, S, D]): contiguous
# [B, H, S, D], and the model layout [B, S, H, D] read as a permuted view,
# for q (qwen3's G = 5: 10 q heads over 2 kv heads) and for k/v
TMA_CASES = [
    ((2, 4, 100, 128), (0, 1, 2, 3)),
    ((1, 3, 129, 64), (0, 1, 2, 3)),
    ((2, 70, 10, 128), (0, 2, 1, 3)),
    ((2, 70, 2, 128), (0, 2, 1, 3)),
    ((3, 33, 2, 64), (0, 2, 1, 3)),
]


@pytest.mark.parametrize("shape,perm", TMA_CASES,
                         ids=["bhsd", "bhsd-d64", "model-q-g5", "model-kv", "model-kv-d64"])
def test_tma_fields(shape, perm):
    """dims (D, S, H, B), byte strides of S, H and B, box (64, rows)."""
    rows = k3_ops.TILE_Q
    t = torch.zeros(shape, dtype=torch.bfloat16).permute(*perm)
    B, H, S, D = t.shape
    contiguous = perm == (0, 1, 2, 3)
    ss, sh, sb = ((D, S * D, H * S * D) if contiguous else (H * D, D, S * H * D))
    assert tma_fields(t, rows) == (D, S, H, B, 2 * ss, 2 * sh, 2 * sb, 64, rows)


def test_tma_fields_raises():
    """TMA takes 16-byte aligned data and strides of whole 16-byte units."""
    t = torch.zeros(2 * 4 * 16 * 64 + 8, dtype=torch.bfloat16)
    assert t.data_ptr() % 16 == 0
    tma_fields(t[8:].view(2, 4, 16, 64), 128)  # 16 bytes in: aligned
    with pytest.raises(ValueError, match="16-byte aligned"):
        tma_fields(t[1:1 + 2 * 4 * 16 * 64].view(2, 4, 16, 64), 128)
    with pytest.raises(ValueError, match="sequence stride of 136 bytes"):
        tma_fields(torch.zeros(2, 4, 16, 68, dtype=torch.bfloat16)[..., :64], 128)
    with pytest.raises(ValueError, match="head stride of 8 bytes"):
        tma_fields(torch.zeros(2 * 4096, dtype=torch.bfloat16)
                   .as_strided((2, 4, 16, 64), (4096, 4, 256, 1)), 128)
    with pytest.raises(ValueError, match="unit last stride"):
        tma_fields(torch.zeros(2, 4, 64, 16, dtype=torch.bfloat16).transpose(2, 3), 128)
    with pytest.raises(ValueError, match=r"\[B, H, S, D\]"):
        tma_fields(torch.zeros(4, 16, 64, dtype=torch.bfloat16), 128)
