"""The port's training (``repro_torch.train``, ``repro_torch.dist.compression``
and the gradients of the LMs and GNNs through K3's and K4's
``autograd.Function``s) against the JAX package's on the CPU, on the same
numpy inputs.

Tolerances, and why:

* Compression is bit for bit: the same float32 operations, ``torch.round``
  and ``jnp.round`` both round half to even, and a group's ``max|x|`` (the
  scale over an LM's layers, which the reference stacks into one leaf) is
  exact.
* ``adamw_update``, ``cosine_lr``, ``global_norm`` and ``make_train_step``
  on the tiny linear loss: rtol 1e-6 (one float32 ulp here and there: XLA
  and torch evaluate ``pow`` and the sums' reduction trees their own way).
  Measured: equal.
* LM and GNN gradients: each element within 1e-4 of its leaf's largest
  ``|g|`` (float32 products and sums in another order than XLA's; the
  LM's backward runs the port's blocked attention gradient where the
  reference differentiates its blocked forward).  Measured: at most 2e-6.
* Three train steps (lr 1e-2, warmup 1): loss and ``grad_norm`` at rtol
  1e-5; parameters within 1 % of a step (``lr / 100``), except at most 2
  elements of a leaf or ``ODD_SHARE`` (1e-3) of them, each within ``2 lr``
  a step.  Adam's first steps move an element by ``lr * m / (sqrt(v) +
  eps)``, about ``lr * sign(g)``: where ``g`` is near 0 a last-bit
  difference flips the sign.  Measured: at most 1 element a leaf.  With
  compression, an element whose ``x / scale`` lies within float32 noise of
  a rounding tie flips a quantum of the dequantized gradient, so the share
  is ``ODD_SHARE_COMPRESS`` (5e-3).  Measured: at most 13 of 8,192 (1.6e-3,
  olmoe's ``wv``).
* The Functions' backwards: K3's against autograd of the dense
  ``attention_ref`` at 1e-5 of the largest ``|grad|``; GCN aggregation's
  against autograd of ``spmm_rows_ref`` bit for bit on integer inputs.

MoE routing is compared as in ``tests/test_torch_lm.py`` (both packages'
recorded; different experts only on near-ties, which are counted), and the
gradient comparisons need every token routed alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.configs.base import GNN_SHAPES as J_GNN_SHAPES  # noqa: E402
from repro.dist import compression as jcomp  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.dist import compression as tcomp  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import FlashAttention  # noqa: E402
from repro_torch.kernels.gather_segsum import build_rows, spmm_rows_ref  # noqa: E402
from repro_torch.launch.cells import graph_batch  # noqa: E402
from repro_torch.models import GNN, TransformerLM, forward, gnn_loss, lm_loss  # noqa: E402
from repro_torch.models.gnn import _GcnAggregate, gcn_rows  # noqa: E402
from repro_torch.models.transformer import reference_groups  # noqa: E402
from repro_torch.train import (AdamConfig, TrainState, adamw_update, cosine_lr,  # noqa: E402
                               global_norm, init_train_state, make_train_step)
from test_torch_lm import _rerouted_rows, routing  # noqa: E402,F401

GRAD_TOL = 1e-4
STEP_TOL = 1e-2  # of lr
ODD_SHARE = 1e-3
ODD_SHARE_COMPRESS = 5e-3
ADAM = dict(lr=1e-2, warmup_steps=1, grad_clip=1.0)
N_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x)


def _paired(a, b):
    """The leaves of two reference-layout trees, by path."""
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb)
    return [(jax.tree_util.keystr(p), np.asarray(x), np.asarray(fb[p])) for p, x in fa]


def _j_state(state_np):
    """The reference's ``TrainState`` of jnp arrays from the port's state
    as numpy (``convert.train_state_to_numpy``)."""
    return jax.tree.map(jnp.asarray, jopt.TrainState(
        params=state_np.params, m=state_np.m, v=state_np.v, step=state_np.step,
        err=state_np.err))


def _reference_params(cfg, jcfg, seed: int) -> dict:
    """Weights drawn by the port, as the reference's tree of numpy arrays
    (bf16 as ``ml_dtypes`` arrays), checked leaf by leaf against the
    structure, shapes and dtypes of ``init_lm_params`` (traced, not run)."""
    model = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    ours = train_state_to_numpy(init_train_state(model)).params
    ours = jax.tree.map(lambda x: x.view(jnp.bfloat16) if x.dtype == np.uint16 else x, ours)
    want = jax.eval_shape(lambda: jtf.init_lm_params(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(ours) == jax.tree.structure(want)
    for x, w in zip(jax.tree.leaves(ours), jax.tree.leaves(want)):
        assert x.shape == w.shape and x.dtype == w.dtype
    return ours


def _grads_close(got, want, what):
    for path, w, g in _paired(want, got):
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= GRAD_TOL, f"{what} {path}: {err} of the leaf's largest |g|"


def _params_close(got, want, what, compress=False):
    """Within 1 % of a step (``lr / 100``), but for a few elements, each
    within ``2 lr`` a step (see the module docstring)."""
    share = ODD_SHARE_COMPRESS if compress else ODD_SHARE
    for path, w, g in _paired(want, got):
        d = np.abs(g - w)
        odd = int((d > STEP_TOL * ADAM["lr"]).sum())
        assert odd <= max(2, share * d.size), f"{what} {path}: {odd} of {d.size}"
        assert float(d.max()) <= 2 * ADAM["lr"] * N_STEPS, f"{what} {path}: {d.max()}"


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_quantize_and_compress_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(257,)).astype(np.float32)
    x[:8] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -127.0, 0.0], np.float32) / 127.0 * 3
    x[8] = 3.0  # max |x|: the ties above land on exact halves of the scale
    err = rng.normal(size=(257,)).astype(np.float32) * 1e-3
    q_t, s_t = tcomp.quantize_int8(torch.from_numpy(x))
    q_j, s_j = jcomp.quantize_int8(jnp.asarray(x))
    assert np.array_equal(_np(q_t), np.asarray(q_j)) and float(s_t) == float(s_j)
    assert np.array_equal(_np(tcomp.dequantize_int8(q_t, s_t)),
                          np.asarray(jcomp.dequantize_int8(q_j, s_j)))
    for a, b in zip(tcomp.compress_grads(torch.from_numpy(x), torch.from_numpy(err)),
                    jcomp.compress_grads(jnp.asarray(x), jnp.asarray(err))):
        assert np.array_equal(_np(a), np.asarray(b))
    zero = tcomp.quantize_int8(torch.zeros(4))
    assert float(zero[1]) == 0.0 and not zero[0].any()


def test_ef_compress_tree_bit_identical_over_reference_leaves():
    """Three rounds of EF compression on an LM's gradients: the port's
    per-layer tensors with :func:`reference_groups` against the reference
    on its stacked leaves (one scale across the layers; mixtral's experts
    whole in the port, virtual in the reference), bit for bit, over the
    leaves ``embed``, ``wq``, the router and ``w_up``; then a plain dict
    tree against the same tree.  The reference runs eagerly, as its
    function is written: under jit XLA may round the division by the scale
    otherwise."""
    cfg = tconfigs.get_smoke_config("mixtral-8x7b")
    model = TransformerLM(cfg, device="cpu")
    groups = reference_groups(model)
    assert groups["['layers.1.wq']"] == groups["['layers.0.wq']"] == "['layers']['wq']"
    keep = ("['embed']", "['layers']['wq']", "['layers']['moe']['router']",
            "['layers']['moe']['w_up']")
    names = [n for n, _ in model.named_parameters() if groups[f"[{n!r}]"] in keep]
    rng = np.random.default_rng(3)
    # each port tensor at its own scale, so a per-tensor scale would differ
    noisy = lambda: {n: torch.from_numpy((rng.normal(size=model.get_parameter(n).shape)
                                          * rng.lognormal(0, 2)).astype(np.float32))
                     for n in names}

    def reference(d):
        """``d``'s leaves in the reference's layout (the other leaves 0)."""
        full = {n: d.get(n, torch.zeros(p.shape)) for n, p in model.named_parameters()}
        st = train_state_to_numpy(TrainState(params=model, m=full, v=full,
                                             step=torch.zeros((), dtype=torch.int32)))
        return {"embed": st.m["embed"], "layers": {
            "wq": st.m["layers"]["wq"], "moe": {k: st.m["layers"]["moe"][k]
                                               for k in ("router", "w_up")}}}

    err_t, err_j = None, None
    for r in range(3):
        g_t = noisy()
        deq_t, err_t = tcomp.ef_compress_tree(g_t, err_t, groups)
        deq_j, err_j = jcomp.ef_compress_tree(jax.tree.map(jnp.asarray, reference(g_t)), err_j)
        for got, want in ((reference(deq_t), deq_j), (reference(err_t), err_j)):
            for path, w, g in _paired(want, got):
                assert np.array_equal(g, w), f"round {r} {path}"
    tree = {"a": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)),
            "b": [torch.from_numpy(rng.normal(size=7).astype(np.float32))]}
    deq, err = tcomp.ef_compress_tree(tree)
    deq_j, err_j = jcomp.ef_compress_tree(jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree))
    for path, w, g in _paired(deq_j, pytree.tree_map(_np, deq)) + _paired(
            err_j, pytree.tree_map(_np, err)):
        assert np.array_equal(g, w), path


# ---------------------------------------------------------------------------
# the optimizer and the train step
# ---------------------------------------------------------------------------


def _linear(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=4).astype(np.float32)}
    batch = {"x": rng.normal(size=(8, 3)).astype(np.float32),
             "y": rng.normal(size=(8, 4)).astype(np.float32)}
    return params, batch


def test_adamw_cosine_and_global_norm_match_jax():
    """Five AdamW steps on given gradients, warmup over 3 steps and the
    clip active (the gradients' norm ~ 4 against a clip of 1)."""
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=8, grad_clip=1.0, weight_decay=0.1)
    params, _ = _linear(0)
    rng = np.random.default_rng(1)
    st_t = init_train_state({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    st_j = jopt.init_train_state(jax.tree.map(jnp.asarray, params))
    for step in range(5):
        g = {k: (2 * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
        gt = {k: torch.from_numpy(v) for k, v in g.items()}
        np.testing.assert_allclose(float(global_norm(gt)), float(jopt.global_norm(g)), rtol=1e-6)
        st_t, m_t = adamw_update(st_t, gt, AdamConfig(**cfg))
        st_j, m_j = jopt.adamw_update(st_j, jax.tree.map(jnp.asarray, g), jopt.AdamConfig(**cfg))
        assert int(st_t.step) == int(st_j.step) == step + 1 and st_t.step.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-6)
        for tree_t, tree_j in ((st_t.params, st_j.params), (st_t.m, st_j.m), (st_t.v, st_j.v)):
            for k in params:
                np.testing.assert_allclose(_np(tree_t[k]), np.asarray(tree_j[k]), rtol=1e-6,
                                           atol=1e-7)
    for s in (0, 1, 3, 5, 8, 9):
        np.testing.assert_allclose(float(cosine_lr(AdamConfig(**cfg), torch.tensor(s))),
                                   float(jopt.cosine_lr(jopt.AdamConfig(**cfg), jnp.int32(s))),
                                   rtol=1e-6)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compress"])
def test_make_train_step_matches_jax(microbatches, compress):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    params, batch = _linear(2)
    j_loss = lambda p, b: (jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2), {})
    t_loss = lambda p, b: (torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2),
                           {"b_sum": p["b"].sum()})
    st_j = jopt.init_train_state(jax.tree.map(jnp.asarray, params), compress)
    st_t = init_train_state({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                            compress)
    step_j = j_make_train_step(j_loss, jopt.AdamConfig(**cfg), microbatches=microbatches,
                               compress=compress)
    step_t = make_train_step(t_loss, AdamConfig(**cfg), microbatches=microbatches,
                             compress=compress)
    for _ in range(5):
        st_j, m_j = step_j(st_j, jax.tree.map(jnp.asarray, batch))
        st_t, m_t = step_t(st_t, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m_t) == {"loss", "b_sum", "grad_norm", "lr"}
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(_np(st_t.params[k]), np.asarray(st_j.params[k]), rtol=1e-6,
                                   atol=1e-7)
        if compress:
            np.testing.assert_allclose(_np(st_t.err[k]), np.asarray(st_j.err[k]), rtol=1e-6,
                                       atol=1e-7)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(t_loss, AdamConfig(), microbatches=3)(st_t, {
            k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# the LMs and GNNs: gradients and three train steps
# ---------------------------------------------------------------------------


LM_CASES = [("qwen3-14b", 2, False), ("olmoe-1b-7b", 1, True), ("mixtral-8x7b", 1, False)]


@pytest.mark.parametrize("arch,microbatches,compress", LM_CASES,
                         ids=[f"{a}-mb{m}" + ("-compress" if c else "") for a, m, c in LM_CASES])
def test_lm_grads_and_train_steps_match_jax(arch, microbatches, compress, routing, monkeypatch):
    cfg, jcfg = tconfigs.get_smoke_config(arch), j_get_smoke_config(arch)
    model = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, compress)
    state_np = train_state_to_numpy(state)
    params = state_np.params
    rng = np.random.default_rng(1)
    tokens, labels = (rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32) for _ in range(2))
    tt, tl = torch.from_numpy(tokens), torch.from_numpy(labels)
    if cfg.moe is not None:  # every token routed alike, or the gradients differ
        jax.jit(lambda p, t: jtf.forward(p, t, jcfg))(params, jnp.asarray(tokens))
        with torch.no_grad():
            forward(state.params, tt)
        assert not _rerouted_rows(routing, cfg, "float32", 2, f"{arch} forward")
    monkeypatch.undo()

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jnp.asarray(tokens), jnp.asarray(labels), jcfg),
        has_aux=True))(params)
    t_loss, _ = lm_loss(state.params, tt, tl)
    names = [n for n, _ in state.params.named_parameters()]
    grads = torch.autograd.grad(t_loss, list(state.params.parameters()))
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    as_ref = train_state_to_numpy(dataclasses.replace(state, m=dict(zip(names, grads))))
    _grads_close(as_ref.m, j_grads, arch)

    step_j = jax.jit(j_make_train_step(lambda p, b: jtf.lm_loss(p, b["t"], b["l"], jcfg),
                                       jopt.AdamConfig(**ADAM), microbatches=microbatches,
                                       compress=compress))
    step_t = make_train_step(lambda m, b: lm_loss(m, b["t"], b["l"]), AdamConfig(**ADAM),
                             microbatches=microbatches, compress=compress)
    st_j = _j_state(state_np)
    for _ in range(N_STEPS):
        st_j, m_j = step_j(st_j, {"t": jnp.asarray(tokens), "l": jnp.asarray(labels)})
        state, m_t = step_t(state, {"t": tt, "l": tl})
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    got = train_state_to_numpy(state)
    assert int(got.step) == N_STEPS
    _params_close(got.params, st_j.params, f"{arch} params", compress)


GNN_ARCHS = ["gcn-cora", "gat-cora", "meshgraphnet", "dimenet"]


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_grads_and_train_steps_match_jax(arch):
    cfg, jcfg = tconfigs.get_smoke_config(arch), j_get_smoke_config(arch)
    spec = jcells._shrink(J_GNN_SHAPES["full_graph_sm"])
    g_t = graph_batch(cfg, spec, seed=11, device="cpu")
    g_j, _ = jcells._graph_batch(jcfg, spec, True, np.random.default_rng(11))
    d_feat, d_edge = g_t.node_feat.shape[1], (g_t.edge_feat.shape[1] or 4)
    model = GNN(cfg, d_feat, d_edge, device="cpu", generator=torch.Generator().manual_seed(0))
    state = init_train_state(model.params())
    state_np = train_state_to_numpy(state)
    params = state_np.params
    rows = gcn_rows(g_t) if arch == "gcn-cora" else None

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jgnn.gnn_loss(p, g_j, jcfg), has_aux=True))(params)
    t_loss, _ = gnn_loss(state.params, g_t, cfg, rows)
    grads = torch.autograd.grad(t_loss, pytree.leaves(state.params))
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    it = iter(grads)
    _grads_close(pytree.tree_map(lambda _: _np(next(it)), state.params), j_grads, arch)

    step_j = jax.jit(j_make_train_step(lambda p, b: jgnn.gnn_loss(p, b, jcfg),
                                       jopt.AdamConfig(**ADAM)))
    step_t = make_train_step(lambda p, b: gnn_loss(p, b, cfg, rows), AdamConfig(**ADAM))
    st_j = _j_state(state_np)
    for _ in range(N_STEPS):
        st_j, m_j = step_j(st_j, g_j)
        state, m_t = step_t(state, g_t)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    _params_close(pytree.tree_map(_np, state.params), st_j.params, f"{arch} params")


# ---------------------------------------------------------------------------
# the Functions' backwards, the train-state map
# ---------------------------------------------------------------------------


FA_CASES = [(2, 4, 2, 37, 37, 16, True, None), (1, 6, 2, 40, 40, 8, True, 7),
            (2, 2, 1, 9, 21, 16, False, None), (1, 3, 3, 33, 33, 32, True, 1)]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window", FA_CASES,
                         ids=["causal-gqa", "window7", "full-ragged", "window1"])
def test_flash_attention_function_backward_matches_autograd(B, Hq, Hkv, Sq, Skv, D, causal,
                                                            window):
    """K3's Function on CPU tensors (the blocked plain forward, 8-row
    query blocks so that blocks are skipped) against autograd of
    ``attention_ref``."""
    rng = np.random.default_rng(Sq)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    q, k, v = mk(B, Hq, Sq, D), mk(B, Hkv, Skv, D), mk(B, Hkv, Skv, D)
    do = mk(B, Hq, Sq, D)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FlashAttention.apply(*ins, causal, window, 8, 8)
    got = torch.autograd.grad(out, ins, do)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = attention_ref(*ref, causal=causal, window=window)
    want = torch.autograd.grad(want_out, ref, do)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-5)
    for name, g, w in zip("qkv", got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale, name


def test_gather_segsum_pair_backward_matches_autograd():
    """``A x + A^T x`` through the Function against autograd of two
    ``spmm_rows_ref``s, integer-valued, bit for bit; the matrices must be
    square and of one size."""
    rng = np.random.default_rng(0)
    n, m = 50, 300
    src, dst = (torch.from_numpy(rng.integers(0, n, m)) for _ in range(2))
    val = torch.from_numpy(rng.integers(1, 4, m).astype(np.float32))
    fwd, bwd = build_rows(src, dst, val, n, n, "cpu"), build_rows(dst, src, val, n, n, "cpu")
    x = torch.from_numpy(rng.integers(-3, 4, (n, 5)).astype(np.float32))
    g = torch.from_numpy(rng.integers(-3, 4, (n, 5)).astype(np.float32))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = _GcnAggregate.apply(xa, fwd, bwd)
    want = spmm_rows_ref(fwd, xb) + spmm_rows_ref(bwd, xb)
    assert torch.equal(out, want)
    assert torch.equal(torch.autograd.grad(out, xa, g)[0], torch.autograd.grad(want, xb, g)[0])
    with pytest.raises(ValueError, match="square"):
        _GcnAggregate.apply(xa, build_rows(src, dst, val, n + 1, n, "cpu"), bwd)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-14b"])
def test_train_state_numpy_roundtrip_is_bit_identical(arch):
    """A TrainState in the reference's layout (bf16 params as ``ml_dtypes``
    arrays, mixtral's virtual experts, error-feedback buffers) into the
    port's and back, bit for bit; the port's holds the LM module and dicts
    keyed by its parameter names."""
    jcfg = dataclasses.replace(j_get_smoke_config(arch), dtype="bfloat16")
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="bfloat16")
    params = _reference_params(cfg, jcfg, 4)
    rng = np.random.default_rng(5)
    f32 = lambda: jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
    state_np = jopt.TrainState(params=params, m=f32(), v=f32(), step=np.int32(7), err=f32())
    state = train_state_from_numpy(state_np, cfg, "cpu")
    names = {n for n, _ in state.params.named_parameters()}
    assert set(state.m) == set(state.v) == set(state.err) == names
    assert state.params.embed.dtype == torch.bfloat16 and state.m["embed"].dtype == torch.float32
    assert state.step.dtype == torch.int32 and int(state.step) == 7
    back = train_state_to_numpy(state)
    for field in ("params", "m", "v", "err"):
        for path, w, g in _paired(getattr(state_np, field), getattr(back, field)):
            w = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
            assert g.dtype == w.dtype and np.array_equal(g, w), f"{field} {path}"
    assert back.step.dtype == np.int32 and int(back.step) == 7
