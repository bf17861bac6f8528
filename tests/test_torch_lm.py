"""The port's LM serving path (``repro_torch.models.transformer``) against
the JAX package's (``repro.models.transformer``) on the CPU.

Weights come from the JAX ``init_lm_params`` and are carried across with
``repro_torch.convert``; the prompts from numpy.  The port's ``prefill``
is held against the reference's (last-position logits and the whole KV
cache), then three ``decode_step``s against the reference's, the first of
which overwrites cache slot 0 (W = S after an S-token prefill).

Tolerances: float32 at atol = rtol = 1e-4 (two layers of float32 matrix
products and softmaxes, summed in another order than XLA's).  bfloat16 at
rtol = 2e-2 and atol = 2e-2 of the tensor's largest magnitude: both
frameworks round to bf16 after every operation, but not after the same
ones (XLA rounds ``silu``'s sigmoid, torch does not; sums run in another
order), so single elements differ by a few bf16 ulps of the vector's scale
(one ulp of a value in [2, 4) is 1.6e-2).  On these configs the port's
largest deviation from the JAX bf16 run is the size of the JAX bf16 run's
own deviation from its float32 run (0.02-0.04 on values up to 3.6).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy  # noqa: E402
from repro_torch.models import TransformerLM, decode_step, prefill  # noqa: E402

ARCHS = ["qwen3-14b", "internlm2-20b", "deepseek-coder-33b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, N_DECODE = 2, 24, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, dtype, what):
    tol = TOL[dtype]
    want = _np(want)
    atol = tol * float(np.abs(want).max()) if dtype == "bfloat16" else tol
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=tol, err_msg=what)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jtf.init_lm_params(jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for get_t, get_j in ((tconfigs.get_config, j_get_config),
                         (tconfigs.get_smoke_config, j_get_smoke_config)):
        t, j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.n_params == j.n_params and t.n_active_params == j.n_active_params


def test_convert_roundtrip_is_bit_identical():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("qwen3-14b"), dtype="bfloat16")
    params = _jax_params(cfg, seed=3)
    model = lm_params_from_numpy(params, cfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    back = lm_params_to_numpy(model)
    flat_in = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        got = flat_out[path]
        assert got.shape == leaf.shape, path
        assert np.array_equal(got, leaf.view(np.uint16)), path


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("qwen3-14b", "bfloat16")],
                         ids=[f"{a}-f32" for a in ARCHS] + ["qwen3-14b-bf16"])
def test_prefill_and_decode_match_jax(arch, dtype):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(j_get_smoke_config(arch), dtype=dtype)
    params = _jax_params(jcfg)
    model = lm_params_from_numpy(params, cfg, device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)

    j_logits, j_cache = jtf.prefill(params, jnp.asarray(tokens), jcfg)
    t_logits, t_cache = prefill(model, torch.from_numpy(tokens))
    assert t_logits.dtype == torch.float32 and tuple(t_logits.shape) == (B, cfg.vocab)
    assert tuple(t_cache.k.shape) == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
    _close(t_logits, j_logits, dtype, "prefill logits")
    _close(t_cache.k, j_cache.k, dtype, "prefill k cache")
    _close(t_cache.v, j_cache.v, dtype, "prefill v cache")

    slot0 = t_cache.k[:, :, 0].clone()
    for step in range(N_DECODE):
        tok = rng.integers(0, cfg.vocab, B).astype(np.int32)
        pos = np.full(B, S + step, np.int32)
        j_logits, j_cache = jtf.decode_step(params, j_cache, jnp.asarray(tok),
                                            jnp.asarray(pos), jcfg)
        t_logits, t_cache2 = decode_step(model, t_cache, torch.from_numpy(tok),
                                         torch.from_numpy(pos))
        assert t_cache2 is t_cache  # written in place
        _close(t_logits, j_logits, dtype, f"decode {step} logits")
        _close(t_cache.k, j_cache.k, dtype, f"decode {step} k cache")
        _close(t_cache.v, j_cache.v, dtype, f"decode {step} v cache")
    # position S landed in slot 0 (W = S), replacing position 0
    assert not torch.equal(t_cache.k[:, :, 0], slot0)


def test_entry_points_need_a_device_or_cpu(monkeypatch):
    cfg = tconfigs.get_smoke_config("qwen3-14b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params_from_numpy({}, cfg)
    assert TransformerLM(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "olmoe-1b-7b"])
def test_moe_raises_not_implemented(arch):
    with pytest.raises(NotImplementedError, match="A.11"):
        tconfigs.get_config(arch)
    cfg = dataclasses.replace(tconfigs.get_smoke_config("qwen3-14b"),
                              moe=tconfigs.MoESpec(n_experts=4, top_k=2, d_ff_expert=96))
    with pytest.raises(NotImplementedError, match="A.11"):
        TransformerLM(cfg, device="cpu")
