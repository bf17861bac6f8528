"""The port's GNN forward path (``repro_torch.models.gnn``,
``repro_torch.launch.cells.graph_batch``, ``repro_torch.convert``) against
the JAX package's on the CPU.

Graphs come from ``graph_batch`` and ``repro.launch.cells._graph_batch``
with one seed (array-equal); weights from the JAX ``init_gnn_params``,
carried across with ``repro_torch.convert.gnn_params_from_numpy``.

Tolerance, float32: each logit within 1e-4 of its row's largest |logit|,
the loss to rtol 1e-4.  The two packages add in other orders
(GCN's aggregation runs through destination rows, each row's products
summed in edge order, against the reference's COO segment sums; XLA
fuses and reorders the MLPs' and DimeNet's contractions), so elements differ
by a few float32 ulps of the row's scale; measured on these configs, at most
5e-6 of it (MeshGraphNet).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.configs.base import GNN_SHAPES as J_GNN_SHAPES  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import gnn_params_from_numpy, gnn_params_to_numpy  # noqa: E402
from repro_torch.kernels.gather_segsum import ops as k4_ops  # noqa: E402
from repro_torch.launch.cells import graph_batch  # noqa: E402
from repro_torch.models.gnn import (GNN, GraphBatch, gcn_rows, gnn_forward,  # noqa: E402
                                    gnn_loss, init_gnn_params, make_triplets)

ARCHS = ["gcn-cora", "gat-cora", "meshgraphnet", "dimenet"]
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_graph(cfg, spec, seed):
    g, _ = jcells._graph_batch(cfg, spec, True, np.random.default_rng(seed))
    return g


def _jax_params(cfg, d_feat, d_edge_feat, seed=0):
    p = jgnn.init_gnn_params(jax.random.PRNGKey(seed), cfg, d_feat, d_edge_feat)
    return jax.tree.map(np.asarray, p)


def _close(got, want, what):
    """|got - want| <= TOL * the row's largest |want| (at least 1e-6)."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1e-6)
    err = np.abs(got - want)
    assert np.all(err <= TOL * scale), f"{what}: max err / row scale {(err / scale).max()}"


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for get_t, get_j in ((tconfigs.get_config, j_get_config),
                         (tconfigs.get_smoke_config, j_get_smoke_config)):
        got, want = dataclasses.asdict(get_t(arch)), dataclasses.asdict(get_j(arch))
        # the port drops only the reference's XLA lowering knob
        assert want.keys() - got.keys() == {"unroll"}
        assert {k: want[k] for k in got} == got
    assert tconfigs.ARCH_FAMILY[arch] == "gnn"


def test_shapes_match_jax_and_recsys_raises():
    """Once the recsys arch raised NotImplementedError; now it resolves to
    the reference's config."""
    assert tconfigs.GNN_SHAPES.keys() == J_GNN_SHAPES.keys()
    for name, spec in tconfigs.GNN_SHAPES.items():
        assert dataclasses.asdict(J_GNN_SHAPES[name]) == dataclasses.asdict(spec)
    assert (dataclasses.asdict(tconfigs.get_config("two-tower-retrieval"))
            == dataclasses.asdict(j_get_config("two-tower-retrieval")))
    assert tconfigs.ARCH_FAMILY["two-tower-retrieval"] == "recsys"


@pytest.mark.parametrize("shape", list(J_GNN_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_batch_arrays_equal_jax(arch, shape):
    cfg = tconfigs.get_smoke_config(arch)
    spec = jcells._shrink(J_GNN_SHAPES[shape])
    got = graph_batch(cfg, spec, seed=7, device="cpu")
    want = _jax_graph(j_get_smoke_config(arch), spec, seed=7)
    for name in GraphBatch._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_make_triplets_matches_jax():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 40, 300).astype(np.int32)
    dst = rng.integers(0, 40, 300).astype(np.int32)
    got = make_triplets(src, dst, 3, np.random.default_rng(1))
    want = jgnn.make_triplets(src, dst, 3, np.random.default_rng(1))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_roundtrip_is_bit_identical(arch):
    cfg = tconfigs.get_smoke_config(arch)
    params = _jax_params(j_get_smoke_config(arch), 8, 4, seed=3)
    model = gnn_params_from_numpy(params, cfg, device="cpu")
    back = gnn_params_to_numpy(model)
    flat_in = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        assert flat_out[path].dtype == leaf.dtype and flat_out[path].shape == leaf.shape, path
        np.testing.assert_array_equal(flat_out[path], leaf, err_msg=str(path))
    # the port's own init has the reference's tree (paths and shapes)
    own = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda t: np.asarray(t), init_gnn_params(cfg, 8, 4, device="cpu")))[0]
    assert [(p, a.shape) for p, a in own] == [(p, a.shape) for p, a in flat_in]


def _forward_pair(arch, spec, cfg, jcfg, seed=11):
    g_t = graph_batch(cfg, spec, seed=seed, device="cpu")
    g_j = _jax_graph(jcfg, spec, seed=seed)
    d_feat, d_edge = g_t.node_feat.shape[1], (g_t.edge_feat.shape[1] or 4)
    params = _jax_params(jcfg, d_feat, d_edge)
    model = gnn_params_from_numpy(params, cfg, device="cpu")
    return g_t, g_j, params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    cfg, jcfg = tconfigs.get_smoke_config(arch), j_get_smoke_config(arch)
    spec = jcells._shrink(J_GNN_SHAPES["full_graph_sm"])
    g_t, g_j, params, model = _forward_pair(arch, spec, cfg, jcfg)
    want = jgnn.gnn_forward(params, g_j, jcfg)
    got = model(g_t)
    assert got.dtype == torch.float32
    _close(got, want, f"{arch} logits")
    j_loss, _ = jgnn.gnn_loss(params, g_j, jcfg)
    t_loss, aux = gnn_loss(model.params(), g_t, cfg)
    assert aux == {}
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=TOL)


def test_gcn_full_width_full_graph_sm_matches_jax():
    """gcn-cora at its published widths on the Cora-sized graph (3,072 nodes,
    10,752 edges, 1,433 features), through both directions' rows."""
    cfg, jcfg = tconfigs.get_config("gcn-cora"), j_get_config("gcn-cora")
    spec = J_GNN_SHAPES["full_graph_sm"]
    g_t, g_j, params, model = _forward_pair("gcn-cora", spec, cfg, jcfg, seed=0)
    rows = gcn_rows(g_t)
    for r in (rows.fwd, rows.bwd):
        assert (r.n_out, r.n_src, int(r.row_ptr[-1])) == (3072, 3072, 10_752)
    n0 = k4_ops.launches
    got = model(g_t, rows)
    assert k4_ops.launches == n0
    want = jgnn.gnn_forward(params, g_j, jcfg)
    _close(got, want, "gcn-cora full width")
    assert torch.equal(got, gnn_forward(model.params(), g_t, cfg))  # rows built inside


def test_tiles_only_for_gcn_and_entry_points_need_a_device(monkeypatch):
    cfg = tconfigs.get_smoke_config("gat-cora")
    spec = jcells._shrink(J_GNN_SHAPES["full_graph_sm"])
    g = graph_batch(cfg, spec, seed=0, device="cpu")
    gcn = graph_batch(tconfigs.get_smoke_config("gcn-cora"), spec, seed=0, device="cpu")
    model = GNN(cfg, 8, device="cpu")
    with pytest.raises(ValueError, match="only GCN"):
        model(g, gcn_rows(gcn))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNN(cfg, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_batch(cfg, spec, seed=0)
