"""The port's segment ops (``repro_torch.graphstore.segment_ops``) against
the JAX package's (``repro.graphstore.segment_ops``) on the same numpy
inputs, on the CPU.

Segment ids include empty segments (ids drawn from fewer values than
``num_segments``), where ``segment_max`` must give ``-inf`` and
``segment_softmax`` must map it to 0.  Tolerance: float32 at rtol = atol =
1e-6 (the same adds in another order: ``index_add_`` against XLA's
scatter-add); integer-valued data and maxima are compared exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.graphstore import segment_ops as jseg  # noqa: E402
from repro_torch.graphstore import segment_ops as tseg  # noqa: E402

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, n, shape, n_seg, integer=False):
    """Data [n, *shape] and ids in [0, n_seg - 3): the last 3 segments are
    empty, and so is any id the draw misses."""
    rng = np.random.default_rng(seed)
    data = (rng.integers(-5, 6, (n,) + shape).astype(np.float32) if integer
            else rng.normal(size=(n,) + shape).astype(np.float32))
    ids = rng.integers(0, n_seg - 3, n).astype(np.int32)
    return data, ids


def _check(got, want, exact=False):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(), (3,), (2, 4)], ids=["1d", "2d", "3d"])
@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max"])
def test_segment_reductions_match_jax(op, shape):
    data, ids = _data(1, 200, shape, 40)
    got = getattr(tseg, op)(torch.from_numpy(data), torch.from_numpy(ids), 40)
    want = getattr(jseg, op)(jnp.asarray(data), jnp.asarray(ids), 40)
    _check(got, want, exact=op == "segment_max")
    if op == "segment_max":
        assert np.isneginf(got.numpy()[-3:]).all()


def test_integer_sums_are_exact():
    data, ids = _data(2, 500, (4,), 64, integer=True)
    got = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 64)
    _check(got, jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 64), exact=True)


@pytest.mark.parametrize("heads", [None, 3], ids=["flat", "heads"])
def test_segment_softmax_matches_jax_with_empty_and_masked(heads):
    shape = () if heads is None else (heads,)
    logits, ids = _data(3, 150, shape, 30)
    logits[::7] = -1e30  # masked edges, as GAT masks padding
    got = tseg.segment_softmax(torch.from_numpy(logits), torch.from_numpy(ids), 30)
    want = jseg.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), 30)
    _check(got, want)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_gather_scatter_sum_matches_jax(weighted):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    src = rng.integers(0, 50, 300).astype(np.int32)
    dst = rng.integers(0, 45, 300).astype(np.int32)
    w = rng.normal(size=300).astype(np.float32) if weighted else None
    got = tseg.gather_scatter_sum(torch.from_numpy(x), torch.from_numpy(src),
                                  torch.from_numpy(dst), 50,
                                  None if w is None else torch.from_numpy(w))
    want = jseg.gather_scatter_sum(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), 50,
                                   None if w is None else jnp.asarray(w))
    _check(got, want)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_embedding_bag_matches_jax(combine, weighted):
    rng = np.random.default_rng(5)
    table = rng.normal(size=(100, 8)).astype(np.float32)
    idx = rng.integers(0, 100, 64).astype(np.int32)
    bag = np.sort(rng.integers(0, 14, 64)).astype(np.int32)  # bags 14, 15 empty
    w = rng.random(64).astype(np.float32) if weighted else None
    got = tseg.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                             torch.from_numpy(bag), 16,
                             None if w is None else torch.from_numpy(w), combine)
    want = jseg.embedding_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bag), 16,
                              None if w is None else jnp.asarray(w), combine)
    _check(got, want)
    with pytest.raises(ValueError, match="combine"):
        tseg.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(bag), 16, combine="max")


@pytest.mark.parametrize("with_val,nnz_per_block", [(False, 16), (True, 64), (True, 1024)])
def test_build_padded_csr_arrays_equal(with_val, nnz_per_block):
    rng = np.random.default_rng(6)
    dst = rng.integers(0, 30, 200)
    src = rng.integers(0, 30, 200)
    val = rng.normal(size=200).astype(np.float32) if with_val else None
    got = tseg.build_padded_csr(dst, src, val, 30, nnz_per_block)
    want = jseg.build_padded_csr(dst, src, val, 30, nnz_per_block)
    for name in ("col", "row", "val"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.num_rows, got.nnz_per_block) == (want.num_rows, want.nnz_per_block)
