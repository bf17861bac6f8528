"""The port's LM (``repro_torch.models.transformer``) against the JAX
package's (``repro.models.transformer``) on the CPU, dense and MoE.

Weights come from the JAX ``init_lm_params`` and are carried across with
``repro_torch.convert``; the prompts from numpy.  The port's ``prefill``
is held against the reference's (last-position logits and the whole KV
cache, ``W = S`` or, for mixtral's window of 16 at S 24, the rolling
cache of the last 16 positions), then three ``decode_step``s against the
reference's, the first of which overwrites cache slot ``S % W``; and
``forward``/``lm_loss`` against the reference's (logits, aux, nll, loss).

MoE routing: every MoE FFN call of both packages is recorded (the router
logits on the reference's side, ``moe_route``'s ``topi`` on the port's);
the chosen experts must be equal except on near-tie tokens (two of the
reference's top-(K+1) logits closer than ``ROUTE_MARGIN``, as
``test_torch_moe.near_ties`` counts them; counted and logged), and a
sequence in which a token was routed differently is left out of the
comparisons that follow.

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
import logging

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
from repro_torch.models import (TransformerLM, cache_window, decode_step,  # noqa: E402
                                forward, lm_loss, prefill)
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.moe import moe_route  # noqa: E402
from test_torch_moe import near_ties  # noqa: E402

log = logging.getLogger(__name__)

ARCHS = ["qwen3-14b", "internlm2-20b", "deepseek-coder-33b", "mixtral-8x7b", "olmoe-1b-7b"]
MOE_ARCHS = ["mixtral-8x7b", "olmoe-1b-7b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# twice the largest difference of one router logit between the packages
# (their MoE inputs differ by float32 rounding, or by bf16 ulps of the
# hidden state): measured up to 1.2e-6 in float32 and 0.024 in bfloat16 on
# these configs
ROUTE_MARGIN = {"float32": 1e-4, "bfloat16": 5e-2}
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


@pytest.fixture
def routing(monkeypatch):
    """Record every MoE FFN call's routing in both packages, in call order:
    the reference's router logits (through a debug callback, which runs
    inside its layer scan) and the port's ``topi``."""
    rec = {"jax": [], "torch": []}
    j_moe, t_moe = jtf.moe_ffn, ttf.moe_ffn

    def j_recorded(x, p, spec):
        logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
        jax.debug.callback(lambda l: rec["jax"].append(np.asarray(l)), logits)
        return j_moe(x, p, spec)

    def t_recorded(x, router, w_gate, w_up, w_down, spec):
        rec["torch"].append(moe_route(x, router, spec).topi.numpy())
        return t_moe(x, router, w_gate, w_up, w_down, spec)

    monkeypatch.setattr(jtf, "moe_ffn", j_recorded)
    monkeypatch.setattr(ttf, "moe_ffn", t_recorded)
    return rec


def _rerouted_rows(rec, cfg, dtype, n_rows, what) -> set:
    """Check and clear the recorded calls; the sequences (rows of the
    ``[B, S]`` or ``[B]`` tokens, flattened in that order) in which a
    near-tie token was routed differently."""
    jax.effects_barrier()
    n_calls = (len(rec["jax"]), len(rec["torch"]))
    calls = list(zip(rec["jax"], rec["torch"]))
    rec["jax"].clear()
    rec["torch"].clear()
    if cfg.moe is None:
        assert n_calls == (0, 0), what
        return set()
    assert n_calls == (cfg.n_layers, cfg.n_layers), what
    rows, ties = set(), 0
    K = cfg.moe.top_k
    for j_logits, t_topi in calls:
        j_topi = np.argsort(-j_logits, axis=-1, kind="stable")[:, :K]
        differ = ~(j_topi == t_topi).all(axis=-1)
        tie = near_ties(j_logits, K, ROUTE_MARGIN[dtype])
        assert tie[differ].all(), f"{what}: topi differs on tokens that are not near-ties"
        ties += int(tie.sum())
        rows |= {int(t) // (len(t_topi) // n_rows) for t in np.flatnonzero(differ)}
    log.info("%s: %d near-tie tokens (margin < %g), sequences routed differently: %s",
             what, ties, ROUTE_MARGIN[dtype], sorted(rows))
    return rows


def _rows_close(got, want, rows_out, dtype, what, axis=0):
    """``_close`` on the batch rows (axis ``axis``) not in ``rows_out``."""
    keep = [b for b in range(B) if b not in rows_out]
    assert keep, f"{what}: every sequence was routed differently"
    _close(_np(got).take(keep, axis), _np(want).take(keep, axis), dtype, what)


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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_convert_roundtrip_is_bit_identical(arch):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="bfloat16")
    params = _jax_params(cfg, seed=3)
    model = lm_params_from_numpy(params, cfg, device="cpu")
    lp = model.layers[0]
    E, F = cfg.moe.n_experts, cfg.moe.d_ff_expert
    assert lp.router.dtype == torch.float32 and lp.w_gate.dtype == torch.bfloat16
    assert tuple(lp.w_gate.shape) == (E, cfg.d_model, F)
    assert tuple(lp.w_down.shape) == (E, F, cfg.d_model)
    back = lm_params_to_numpy(model)
    flat_in = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        got = flat_out[path]
        assert got.shape == leaf.shape, path
        want = leaf.view(np.uint16) if leaf.dtype.name == "bfloat16" else leaf
        assert got.dtype == want.dtype and np.array_equal(got, want), path


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("qwen3-14b", "bfloat16"), ("olmoe-1b-7b", "bfloat16")],
                         ids=[f"{a}-f32" for a in ARCHS] + ["qwen3-14b-bf16", "olmoe-1b-7b-bf16"])
def test_prefill_and_decode_match_jax(arch, dtype, routing):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(j_get_smoke_config(arch), dtype=dtype)
    params = _jax_params(jcfg)
    model = lm_params_from_numpy(params, cfg, device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    W, rolling = cache_window(cfg, S)
    assert rolling == (arch == "mixtral-8x7b")

    j_logits, j_cache = jtf.prefill(params, jnp.asarray(tokens), jcfg)
    t_logits, t_cache = prefill(model, torch.from_numpy(tokens))
    assert t_logits.dtype == torch.float32 and tuple(t_logits.shape) == (B, cfg.vocab)
    assert tuple(t_cache.k.shape) == (cfg.n_layers, B, W, cfg.n_kv_heads, cfg.d_head)
    out = _rerouted_rows(routing, cfg, dtype, B, f"{arch} prefill")
    _rows_close(t_logits, j_logits, out, dtype, "prefill logits")
    _rows_close(t_cache.k, j_cache.k, out, dtype, "prefill k cache", axis=1)
    _rows_close(t_cache.v, j_cache.v, out, dtype, "prefill v cache", axis=1)

    slot = S % W
    before = t_cache.k[:, :, slot].clone()
    for step in range(N_DECODE):
        tok = rng.integers(0, cfg.vocab, B).astype(np.int32)
        pos = np.full(B, S + step, np.int32)
        j_logits, j_cache = jtf.decode_step(params, j_cache, jnp.asarray(tok),
                                            jnp.asarray(pos), jcfg)
        t_logits, t_cache2 = decode_step(model, t_cache, torch.from_numpy(tok),
                                         torch.from_numpy(pos))
        assert t_cache2 is t_cache  # written in place
        out |= _rerouted_rows(routing, cfg, dtype, B, f"{arch} decode {step}")
        _rows_close(t_logits, j_logits, out, dtype, f"decode {step} logits")
        _rows_close(t_cache.k, j_cache.k, out, dtype, f"decode {step} k cache", axis=1)
        _rows_close(t_cache.v, j_cache.v, out, dtype, f"decode {step} v cache", axis=1)
    # position S landed in slot S % W, replacing position S - W
    assert not torch.equal(t_cache.k[:, :, slot], before)


@pytest.mark.parametrize("arch", ["qwen3-14b"] + MOE_ARCHS)
def test_forward_and_lm_loss_match_jax(arch, routing):
    cfg = tconfigs.get_smoke_config(arch)
    jcfg = j_get_smoke_config(arch)
    params = _jax_params(jcfg, seed=1)
    model = lm_params_from_numpy(params, cfg, device="cpu")
    rng = np.random.default_rng(6)
    tokens, labels = (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for _ in range(2))

    j_logits, j_aux = jtf.forward(params, jnp.asarray(tokens), jcfg)
    t_logits, t_aux = forward(model, torch.from_numpy(tokens))
    assert t_logits.dtype == torch.float32 and tuple(t_logits.shape) == (B, S, cfg.vocab)
    out = _rerouted_rows(routing, cfg, "float32", B, f"{arch} forward")
    _rows_close(t_logits, j_logits, out, "float32", "forward logits")
    j_loss, j_parts = jtf.lm_loss(params, jnp.asarray(tokens), jnp.asarray(labels), jcfg)
    t_loss, t_parts = lm_loss(model, torch.from_numpy(tokens), torch.from_numpy(labels))
    out |= _rerouted_rows(routing, cfg, "float32", B, f"{arch} lm_loss")
    if cfg.moe is None:
        assert float(t_aux) == 0.0 == float(j_aux)
    else:
        assert float(t_aux) > 0.0
    if out:  # the aux loss and the mean NLL mix every sequence
        return
    for name, got, want in (("aux", t_aux, j_aux), ("nll", t_parts["nll"], j_parts["nll"]),
                            ("aux of lm_loss", t_parts["aux"], j_parts["aux"]),
                            ("loss", t_loss, j_loss)):
        _close(got, want, "float32", name)


def test_entry_points_need_a_device_or_cpu(monkeypatch):
    cfg = tconfigs.get_smoke_config("qwen3-14b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params_from_numpy({}, cfg)
    assert TransformerLM(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_raises_not_implemented(arch):
    """Once the MoE archs raised NotImplementedError; now they resolve: an
    LM family config, and a model that builds on the CPU."""
    cfg = tconfigs.get_config(arch)
    assert tconfigs.ARCH_FAMILY[arch] == "lm" and arch in tconfigs.ARCHS
    assert cfg.moe is not None
    smoke = tconfigs.get_smoke_config(arch)
    model = TransformerLM(smoke, device="cpu")
    E, F = smoke.moe.n_experts, smoke.moe.d_ff_expert
    assert tuple(model.layers[0].w_up.shape) == (E, smoke.d_model, F)
    assert model.layers[0].router.dtype == torch.float32
    n = sum(p.numel() for p in model.parameters())
    assert n == smoke.n_params
