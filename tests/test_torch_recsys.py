"""The port's recsys slice (``repro_torch.models.two_tower``, the fanout
sampler, the two-tower config and ``convert``'s two-tower leaves) against
the JAX package on the CPU, on the same numpy inputs.

Tolerances, and why:

* ``sample_fanout``: array-equal (a numpy copy on the same Generator).
* Towers, loss, scores and top-k: rtol 1e-5, atol 1e-6 (unit-norm tower
  outputs; float32 products and the bag's sums in another order than
  XLA's).  The top-k indices are equal (no near-ties among 512 normal
  candidates).
* The loss's gradient: each leaf within 1e-4 of its largest ``|g|``, as
  in ``tests/test_torch_train.py``.
* One train step (lr 1e-2): loss and ``grad_norm`` at rtol 1e-5; the
  parameters within 1 % of a step (``lr / 100``) but for at most 2
  elements of a leaf or 0.1 % of them, each within ``2 lr`` (Adam's first
  step moves an element by about ``lr * sign(g)``, and a last-bit
  difference flips the sign of a ``g`` near 0).
* The towers over chunks of rows against the whole batch: atol 2e-7 on
  the unit-norm tower outputs (2 ulps of 1.0) and 4e-6 on the scores
  (times ``temp`` 20), rtol 1e-6: the same operations a row, but the
  product of a single row is a matrix-vector product, which the CPU
  library blocks otherwise (chunks of 3 rows measured equal, single rows
  1.5e-7 off).
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
from repro.configs.base import RECSYS_SHAPES as J_RECSYS_SHAPES  # noqa: E402
from repro.graphstore import sampler as jsampler  # noqa: E402
from repro.models import two_tower as jtt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import (two_tower_params_from_numpy,  # noqa: E402
                                 two_tower_params_to_numpy)
from repro_torch.graphstore import sampler as tsampler  # noqa: E402
from repro_torch.models import two_tower as ttt  # noqa: E402
from repro_torch.train import AdamConfig, init_train_state, make_train_step  # noqa: E402

ARCH = "two-tower-retrieval"
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
ADAM = dict(lr=1e-2, warmup_steps=1, weight_decay=0.0)
B = 8


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _setup(seed: int = 0):
    """The smoke config, the reference's weights (numpy) and a batch."""
    cfg, jcfg = tconfigs.get_smoke_config(ARCH), j_get_smoke_config(ARCH)
    params_np = jax.tree.map(np.asarray, jtt.init_two_tower_params(jax.random.PRNGKey(seed),
                                                                   jcfg))
    rng = np.random.default_rng(seed + 1)
    Fu, Fi, M = cfg.n_user_fields, cfg.n_item_fields, cfg.multi_hot
    batch = dict(
        user_idx=rng.integers(0, cfg.user_vocab, (B, Fu, M)).astype(np.int32),
        user_wt=(rng.random((B, Fu, M)) * (rng.random((B, Fu, M)) > 0.2)).astype(np.float32),
        item_idx=rng.integers(0, cfg.item_vocab, (B, Fi, M)).astype(np.int32),
        item_wt=rng.random((B, Fi, M)).astype(np.float32),
        log_q=rng.normal(size=B).astype(np.float32) * 0.1,
    )
    return cfg, jcfg, params_np, batch


def _batches(batch):
    return (jtt.RecsysBatch(**{k: jnp.asarray(v) for k, v in batch.items()}),
            ttt.RecsysBatch(**{k: torch.from_numpy(v) for k, v in batch.items()}))


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def _paired(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb)
    return [(jax.tree_util.keystr(p), np.asarray(x), np.asarray(fb[p])) for p, x in fa]


@pytest.mark.parametrize("seed,fanouts", [(0, (5, 3)), (7, (15, 10, 2))])
def test_sample_fanout_arrays_equal_jax(seed, fanouts):
    rng = np.random.default_rng(100 + seed)
    n, m = 300, 2000
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    dst[dst == 7] = 8  # one vertex without in-edges: a self-padded neighbourhood
    csr_t, csr_j = (mod.build_csr_neighbors(n, src, dst) for mod in (tsampler, jsampler))
    assert np.array_equal(csr_t.indptr, csr_j.indptr)
    assert np.array_equal(csr_t.indices, csr_j.indices)
    seeds = np.array([7, 1, 50, 299, 3])
    got = tsampler.sample_fanout(csr_t, seeds, fanouts, np.random.default_rng(seed))
    want = jsampler.sample_fanout(csr_j, seeds, fanouts, np.random.default_rng(seed))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


def test_config_and_shapes_match_jax():
    for get_t, get_j in ((tconfigs.get_config, j_get_config),
                         (tconfigs.get_smoke_config, j_get_smoke_config)):
        assert dataclasses.asdict(get_t(ARCH)) == dataclasses.asdict(get_j(ARCH))
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.RECSYS_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_RECSYS_SHAPES.items()}


def test_init_matches_reference_structure_and_convert_roundtrip():
    """The port's own draw has the reference's leaves, shapes and dtypes
    (tables scaled by 0.05: fan-in normals with std 0.05 / sqrt(D)), and
    ``convert`` carries the reference's tree across bit for bit."""
    cfg, jcfg, params_np, _ = _setup()
    ours = ttt.init_two_tower_params(cfg, device="cpu")
    want = jax.eval_shape(lambda: jtt.init_two_tower_params(jax.random.PRNGKey(0), jcfg))
    mine = two_tower_params_to_numpy(ours)
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    for x, w in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        assert x.shape == w.shape and x.dtype == w.dtype
    std = float(ours["user_table"].std())
    assert 0.8 < std / (0.05 / cfg.embed_dim ** 0.5) < 1.2
    assert float(ours["temp"]) == 20.0 and not ours["user_mlp"]["b0"].any()
    back = two_tower_params_to_numpy(two_tower_params_from_numpy(params_np, cfg, "cpu"))
    for path, w, g in _paired(params_np, back):
        assert np.array_equal(g, w), path
    with pytest.raises(KeyError, match="leaves"):
        two_tower_params_from_numpy({"temp": params_np["temp"]}, cfg, "cpu")


def test_towers_loss_scores_and_retrieval_match_jax():
    cfg, jcfg, params_np, batch = _setup()
    pj = jax.tree.map(jnp.asarray, params_np)
    pt = two_tower_params_from_numpy(params_np, cfg, "cpu")
    bj, bt = _batches(batch)
    with torch.no_grad():
        _close(ttt.user_tower(pt, bt.user_idx, bt.user_wt, cfg),
               jtt.user_tower(pj, bj.user_idx, bj.user_wt, jcfg), "user_tower")
        _close(ttt.item_tower(pt, bt.item_idx, bt.item_wt, cfg),
               jtt.item_tower(pj, bj.item_idx, bj.item_wt, jcfg), "item_tower")
        loss_t, m_t = ttt.two_tower_loss(pt, bt, cfg)
        loss_j, m_j = jtt.two_tower_loss(pj, bj, jcfg)
        _close(loss_t, loss_j, "loss")
        assert float(m_t["in_batch_acc"]) == float(m_j["in_batch_acc"])
        _close(ttt.score_pairs(pt, bt, cfg), jtt.score_pairs(pj, bj, jcfg), "score_pairs")
        cand = np.random.default_rng(5).normal(size=(512, cfg.tower_mlp[-1])).astype(np.float32)
        vt, it = ttt.retrieval_scores(pt, bt.user_idx[:1], bt.user_wt[:1],
                                      torch.from_numpy(cand), cfg, top_k=100)
        vj, ij = jtt.retrieval_scores(pj, bj.user_idx[:1], bj.user_wt[:1], jnp.asarray(cand),
                                      jcfg, top_k=100)
    _close(vt, vj, "top-k scores")
    assert np.array_equal(_np(it), np.asarray(ij))


def test_loss_gradient_matches_jax_grad():
    cfg, jcfg, params_np, batch = _setup(2)
    bj, bt = _batches(batch)
    j_grads = jax.grad(lambda p: jtt.two_tower_loss(p, bj, jcfg)[0])(
        jax.tree.map(jnp.asarray, params_np))
    pt = two_tower_params_from_numpy(params_np, cfg, "cpu")
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(pt)]
    grads = torch.autograd.grad(ttt.two_tower_loss(pt, bt, cfg)[0], leaves)
    got = jax.tree.unflatten(jax.tree.structure(pt), [g.numpy() for g in grads])
    for path, w, g in _paired(j_grads, got):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) / scale <= GRAD_TOL, path


def test_train_step_matches_jax():
    cfg, jcfg, params_np, batch = _setup(3)
    bj, bt = _batches(batch)
    st_j = jopt.init_train_state(jax.tree.map(jnp.asarray, params_np))
    st_j, m_j = jax.jit(j_make_train_step(lambda p, b: jtt.two_tower_loss(p, b, jcfg),
                                          jopt.AdamConfig(**ADAM)))(st_j, bj)
    st_t = init_train_state(two_tower_params_from_numpy(params_np, cfg, "cpu"))
    st_t, m_t = make_train_step(lambda p, b: ttt.two_tower_loss(p, b, cfg),
                                AdamConfig(**ADAM))(st_t, bt)
    for k in ("loss", "grad_norm", "lr", "in_batch_acc"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    assert int(st_t.step) == int(st_j.step) == 1
    for path, w, g in _paired(st_j.params, two_tower_params_to_numpy(st_t.params)):
        d = np.abs(g - w)
        odd = int((d > 1e-2 * ADAM["lr"]).sum())
        assert odd <= max(2, 1e-3 * d.size), f"{path}: {odd} of {d.size}"
        assert float(d.max()) <= 2 * ADAM["lr"], path


@pytest.mark.parametrize("rows", [1, 3])
def test_towers_over_chunks_equal_whole_batch(rows, monkeypatch):
    """The bounded working set (chunks of ``rows`` batch rows: BAG_BYTES
    cut to their gathers) against the whole batch at once; and the chunk
    size of the full config."""
    cfg, _, params_np, batch = _setup(4)
    pt = two_tower_params_from_numpy(params_np, cfg, "cpu")
    _, bt = _batches(batch)
    towers = ((ttt.user_tower, bt.user_idx, bt.user_wt, cfg.n_user_fields),
              (ttt.item_tower, bt.item_idx, bt.item_wt, cfg.n_item_fields))
    with torch.no_grad():
        whole = [tower(pt, idx, wt, cfg) for tower, idx, wt, _ in towers]
        scores = ttt.score_pairs(pt, bt, cfg)
        for (tower, idx, wt, F), want in zip(towers, whole):
            monkeypatch.setattr(ttt, "BAG_BYTES", rows * F * cfg.multi_hot * cfg.embed_dim * 4)
            assert ttt.bag_rows(F, cfg.multi_hot, cfg.embed_dim) == rows
            torch.testing.assert_close(tower(pt, idx, wt, cfg), want, rtol=1e-6, atol=2e-7)
        torch.testing.assert_close(ttt.score_pairs(pt, bt, cfg), scores, rtol=1e-6, atol=4e-6)
    monkeypatch.undo()
    full = tconfigs.get_config(ARCH)
    assert ttt.bag_rows(full.n_user_fields, full.multi_hot, full.embed_dim) == 32768
    assert ttt.bag_rows(full.n_item_fields, full.multi_hot, full.embed_dim) == 65536


def test_two_tower_needs_a_device_or_cpu(monkeypatch):
    cfg = tconfigs.get_smoke_config(ARCH)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttt.init_two_tower_params(cfg)
    meta = ttt.init_two_tower_params(cfg, device="meta", init=False)
    assert meta["user_table"].device.type == "meta"
