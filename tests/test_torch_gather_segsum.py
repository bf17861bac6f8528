"""The port's sparse formats and SpMM (``repro_torch.kernels.gather_segsum``)
against the JAX package's (``repro.kernels.gather_segsum``,
``repro.graphstore.segment_ops``) on the CPU.

* ``build_tiles`` returns the reference's arrays exactly (tile order, zero
  tiles for empty destination blocks, ``first_visit``, ``occupancy``), with
  duplicate edges summed in edge order.
* ``build_rows`` gives destination rows: ``row_ptr`` monotone from 0 to
  nnz, each row's edges in edge order; ``rows_from_tiles`` of the same
  edges' tiles is the same matrix.
* ``gather_segsum`` on CPU tensors runs the plain row-level version
  (``spmm_rows_ref``) and ``block_spmm_ref`` the tile-level one; both are
  held against the Pallas kernel in interpret mode and against
  ``gather_scatter_sum`` at atol = rtol = 1e-4 (the contract of
  ``tests/test_kernels.py``: float32 sums in another order), and bit for
  bit on integer-valued weights and x (every sum is exact).
* K4's argument check raises on what the kernel does not take.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gather_segsum import build_tiles as j_build_tiles  # noqa: E402
from repro.kernels.gather_segsum import gather_segsum as j_gather_segsum  # noqa: E402
from repro.kernels.gather_segsum import spmm_ref as j_spmm_ref  # noqa: E402
from repro.graphstore.segment_ops import gather_scatter_sum as j_gather_scatter_sum  # noqa: E402
from repro_torch.kernels.gather_segsum import (BlockRows, block_spmm_ref,  # noqa: E402
                                               build_rows, build_tiles,
                                               check_kernel_args, gather_segsum,
                                               rows_from_tiles, spmm_ref, spmm_rows_ref)
from repro_torch.kernels.gather_segsum import ops as k4_ops  # noqa: E402

# (n_dst, n_src, n_edges, F, seed): the sweep of tests/test_kernels.py, and a
# graph with many duplicate edges and empty destination blocks
SWEEP = [
    (256, 256, 1000, 64, 0),
    (300, 200, 700, 16, 1),  # non-multiple of block
    (128, 512, 2000, 128, 2),
    (512, 512, 100, 200, 3),  # sparse, F > f_tile
    (700, 300, 3000, 7, 4),  # duplicates (few distinct sources), empty dst blocks
]
IDS = [f"spmm{i}" for i in range(len(SWEEP))]
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(n_dst, n_src, m, F, seed, integer=False):
    rng = np.random.default_rng(seed)
    if seed == 4:  # few sources, dst in the lower half: duplicates and empty blocks
        src = rng.integers(0, 40, m).astype(np.int32)
        dst = rng.integers(0, n_dst // 2, m).astype(np.int32)
    else:
        src = rng.integers(0, n_src, m).astype(np.int32)
        dst = rng.integers(0, n_dst, m).astype(np.int32)
    if integer:
        val = rng.integers(-3, 4, m).astype(np.float32)
        x = rng.integers(-4, 5, (n_src, F)).astype(np.float32)
    else:
        val = rng.normal(size=m).astype(np.float32)
        x = rng.normal(size=(n_src, F)).astype(np.float32)
    return src, dst, val, x


@pytest.mark.parametrize("with_val", [True, False], ids=["val", "ones"])
@pytest.mark.parametrize("n_dst,n_src,m,F,seed", SWEEP, ids=IDS)
def test_build_tiles_arrays_equal_jax(n_dst, n_src, m, F, seed, with_val):
    src, dst, val, _ = _edges(n_dst, n_src, m, F, seed)
    val = val if with_val else None
    got = build_tiles(torch.from_numpy(src), torch.from_numpy(dst),
                      None if val is None else torch.from_numpy(val), n_dst, n_src)
    want = j_build_tiles(src, dst, val, n_dst, n_src)
    for name in ("tiles", "tile_src", "tile_dst", "first_visit"):
        a, b = getattr(got, name).numpy(), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("n_out_blocks", "n_src_blocks", "block_size", "occupancy"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("n_dst,n_src,m,F,seed", SWEEP, ids=IDS)
def test_build_rows_invariants(n_dst, n_src, m, F, seed):
    src, dst, val, _ = _edges(n_dst, n_src, m, F, seed)
    rows = build_rows(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(val),
                      n_dst, n_src)
    assert (rows.n_out, rows.n_src) == (n_dst, n_src)
    assert rows.row_ptr.dtype == torch.int64 and rows.row_ptr.shape == (n_dst + 1,)
    assert rows.col.dtype == torch.int32 and rows.val.dtype == torch.float32
    ptr = rows.row_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == m and bool((np.diff(ptr) >= 0).all())
    np.testing.assert_array_equal(np.diff(ptr), np.bincount(dst, minlength=n_dst))
    # row r holds its edges in edge order
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(rows.col.numpy(), src[order])
    np.testing.assert_array_equal(rows.val.numpy(), val[order])
    with pytest.raises(ValueError, match="past n_dst"):
        build_rows(torch.from_numpy(src), torch.from_numpy(dst), None, int(dst.max()), n_src)


def _dense(rows: BlockRows) -> np.ndarray:
    a = np.zeros((rows.n_out, rows.n_src), np.float64)
    r = np.repeat(np.arange(rows.n_out), np.diff(rows.row_ptr.numpy()))
    np.add.at(a, (r, rows.col.numpy()), rows.val.numpy())
    return a


@pytest.mark.parametrize("n_dst,n_src,m,F,seed", SWEEP, ids=IDS)
def test_rows_from_tiles_is_the_same_matrix(n_dst, n_src, m, F, seed):
    src, dst, val, _ = _edges(n_dst, n_src, m, F, seed, integer=True)
    args = (torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(val), n_dst, n_src)
    rows, bt = build_rows(*args), build_tiles(*args)
    tr = rows_from_tiles(bt)
    assert (tr.n_out, tr.n_src) == (bt.n_out_blocks * 128, bt.n_src_blocks * 128)
    got = _dense(tr)
    assert not got[n_dst:].any() and not got[:, n_src:].any()
    np.testing.assert_array_equal(got[:n_dst, :n_src], _dense(rows))
    # one entry per nonzero of the tiles, each row in tile order
    assert int(tr.row_ptr[-1]) == int(torch.count_nonzero(bt.tiles))


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "int"])
@pytest.mark.parametrize("n_dst,n_src,m,F,seed", SWEEP, ids=IDS)
def test_gather_segsum_cpu_matches_pallas_interpret(n_dst, n_src, m, F, seed, integer):
    src, dst, val, x = _edges(n_dst, n_src, m, F, seed, integer)
    rows = build_rows(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(val),
                      n_dst, n_src)
    n0 = k4_ops.launches
    got = gather_segsum(rows, torch.from_numpy(x), n_dst)
    assert k4_ops.launches == n0  # the CPU path launches nothing
    assert got.shape == (n_dst, F) and got.dtype == torch.float32
    want = j_gather_segsum(j_build_tiles(src, dst, val, n_dst, n_src), jnp.asarray(x), n_dst,
                           force="interpret")
    gss = j_gather_scatter_sum(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), n_dst,
                               jnp.asarray(val))
    coo = j_spmm_ref(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(val), jnp.asarray(x),
                     n_dst)
    t_coo = spmm_ref(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(val),
                     torch.from_numpy(x), n_dst)
    for ref in (want, gss):
        if integer:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    if integer:
        np.testing.assert_array_equal(t_coo.numpy(), np.asarray(coo))
    else:
        np.testing.assert_allclose(t_coo.numpy(), np.asarray(coo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), t_coo.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "int"])
@pytest.mark.parametrize("n_dst,n_src,m,F,seed", SWEEP, ids=IDS)
def test_block_spmm_ref_matches_pallas_interpret(n_dst, n_src, m, F, seed, integer):
    """The tile-level plain version, and K4's CPU path on the same tiles'
    rows, against the Pallas kernel on the reference's tiles."""
    src, dst, val, x = _edges(n_dst, n_src, m, F, seed, integer)
    bt = build_tiles(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(val),
                     n_dst, n_src)
    xt = torch.from_numpy(x)
    got = block_spmm_ref(bt.tiles, bt.tile_src, bt.tile_dst, bt.first_visit, xt,
                         bt.n_out_blocks)[:n_dst]
    via_rows = gather_segsum(rows_from_tiles(bt), xt, n_dst)
    want = np.asarray(j_gather_segsum(j_build_tiles(src, dst, val, n_dst, n_src),
                                      jnp.asarray(x), n_dst, force="interpret"))
    for a in (got, via_rows):
        if integer:
            np.testing.assert_array_equal(a.numpy(), want)
        else:
            np.testing.assert_allclose(a.numpy(), want, rtol=TOL, atol=TOL)


def test_block_spmm_ref_reads_short_x_as_zero_rows():
    src, dst, val, x = _edges(300, 200, 700, 16, 1)
    bt = build_tiles(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(val),
                     300, 200)
    xt = torch.from_numpy(x)
    padded = torch.cat([xt, torch.zeros(bt.n_src_blocks * 128 - 200, 16)])
    args = (bt.tiles, bt.tile_src, bt.tile_dst, bt.first_visit)
    short = block_spmm_ref(*args, xt, bt.n_out_blocks)
    assert short.shape == (bt.n_out_blocks * 128, 16)
    assert torch.equal(short, block_spmm_ref(*args, padded, bt.n_out_blocks))
    # the rows of the same tiles read x's missing rows as 0 too
    rows = rows_from_tiles(bt)
    assert torch.equal(spmm_rows_ref(rows, xt), spmm_rows_ref(rows, padded))
    assert torch.equal(gather_segsum(rows, xt, 300), spmm_rows_ref(rows, padded)[:300])


def _kernel_args(F=8):
    """A well-formed matrix of 3 rows over 200 sources, and x."""
    rows = BlockRows(torch.tensor([0, 1, 1, 3]), torch.tensor([5, 0, 199], dtype=torch.int32),
                     torch.tensor([1.0, 2.0, 3.0]), n_out=3, n_src=200)
    return rows, torch.zeros(200, F)


def test_kernel_argument_check():
    rows, x = _kernel_args()
    check_kernel_args(rows, x, 3)  # well-formed: no error
    check_kernel_args(rows, x, 0)
    with pytest.raises(ValueError, match="n_out 4"):
        check_kernel_args(rows, x, 4)
    rows.val = rows.val.double()
    with pytest.raises(TypeError, match="val"):
        check_kernel_args(rows, x, 3)
    rows, x = _kernel_args()
    with pytest.raises(TypeError, match="x"):
        check_kernel_args(rows, x.half(), 3)
    rows.col = rows.col.long()
    with pytest.raises(TypeError, match="col"):
        check_kernel_args(rows, x, 3)
    rows, x = _kernel_args()
    with pytest.raises(ValueError, match="contiguous"):
        check_kernel_args(rows, torch.zeros(8, 200).t(), 3)
    rows.val = rows.val[:2]
    with pytest.raises(ValueError, match="val: 2 elements"):
        check_kernel_args(rows, x, 3)
    rows, x = _kernel_args()
    rows.row_ptr = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="row_ptr"):
        check_kernel_args(rows, x, 3)
    rows, x = _kernel_args()
    rows.row_ptr = rows.row_ptr.int()
    with pytest.raises(TypeError, match="row_ptr"):
        check_kernel_args(rows, x, 3)
    rows, x = _kernel_args()
    rows.col = rows.col.view(3, 1)
    with pytest.raises(ValueError, match=r"col must be \[nnz\]"):
        check_kernel_args(rows, x, 3)
    rows, x = _kernel_args()
    with pytest.raises(ValueError, match="n >= 1"):
        check_kernel_args(rows, torch.zeros(0, 8), 3)
    with pytest.raises(ValueError, match="n >= 1"):
        check_kernel_args(rows, torch.zeros(200), 3)
    with pytest.raises(TypeError, match="tensor"):
        check_kernel_args(rows, x.numpy(), 3)


def test_wrapper_refuses_other_devices():
    rows, x = _kernel_args()
    with pytest.raises(ValueError, match="unsupported device"):
        gather_segsum(rows, x.to("meta"), 3)
    rows.col = rows.col.to("meta")
    with pytest.raises(ValueError, match="on meta"):
        gather_segsum(rows, x, 3)
    # well-formed on the CPU: the plain version
    rows, x = _kernel_args()
    x[5], x[0], x[199] = 1.0, 10.0, 100.0
    np.testing.assert_array_equal(gather_segsum(rows, x, 3)[:, 0].numpy(), [1.0, 0.0, 320.0])
