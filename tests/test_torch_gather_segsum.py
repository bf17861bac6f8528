"""The port's block tiling and block-sparse SpMM
(``repro_torch.kernels.gather_segsum``) against the JAX package's
(``repro.kernels.gather_segsum``) on the CPU.

* ``build_tiles`` returns the reference's arrays exactly (tile order, zero
  tiles for empty destination blocks, ``first_visit``, ``occupancy``), with
  duplicate edges summed in edge order.
* ``gather_segsum`` on CPU tensors runs the plain tile-level version
  (``block_spmm_ref``); it is held against the Pallas kernel in interpret
  mode at atol = rtol = 1e-4 (the contract of ``tests/test_kernels.py``:
  float32 sums of up to 128 products per tile in another order), and bit
  for bit on integer-valued tiles and x (every sum is exact).
* ``BlockTiles`` refuses an unsorted ``tile_dst``, and K4's argument
  checks raise on what the kernel does not take.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gather_segsum import build_tiles as j_build_tiles  # noqa: E402
from repro.kernels.gather_segsum import gather_segsum as j_gather_segsum  # noqa: E402
from repro.kernels.gather_segsum import spmm_ref as j_spmm_ref  # noqa: E402
from repro_torch.kernels.gather_segsum import (BlockTiles, block_spmm,  # noqa: E402
                                               block_spmm_ref, build_tiles,
                                               check_kernel_args, gather_segsum,
                                               spmm_ref)
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
    # each output block's run of tiles
    t_dst = want.tile_dst
    expect = np.searchsorted(t_dst, np.arange(want.n_out_blocks + 1))
    np.testing.assert_array_equal(got.run_start.numpy(), expect)


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "int"])
@pytest.mark.parametrize("n_dst,n_src,m,F,seed", SWEEP, ids=IDS)
def test_gather_segsum_cpu_matches_pallas_interpret(n_dst, n_src, m, F, seed, integer):
    src, dst, val, x = _edges(n_dst, n_src, m, F, seed, integer)
    bt = build_tiles(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(val),
                     n_dst, n_src)
    n0 = k4_ops.launches
    got = gather_segsum(bt, torch.from_numpy(x), n_dst)
    assert k4_ops.launches == n0  # the CPU path launches nothing
    assert got.shape == (n_dst, F) and got.dtype == torch.float32
    want = j_gather_segsum(j_build_tiles(src, dst, val, n_dst, n_src), jnp.asarray(x), n_dst,
                           force="interpret")
    coo = j_spmm_ref(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(val), jnp.asarray(x),
                     n_dst)
    t_coo = spmm_ref(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(val),
                     torch.from_numpy(x), n_dst)
    if integer:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(t_coo.numpy(), np.asarray(coo))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(t_coo.numpy(), np.asarray(coo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), t_coo.numpy(), rtol=TOL, atol=TOL)


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
    assert torch.equal(short, block_spmm(bt, xt))


def _kernel_args(T=3, F=8):
    """A well-formed tile set of T tiles over 3 output blocks, and x."""
    idx = torch.zeros(T, dtype=torch.int32)
    bt = BlockTiles(torch.zeros(T, 128, 128), idx.clone(), torch.arange(T, dtype=torch.int32),
                    idx.clone(), n_out_blocks=3, n_src_blocks=2, block_size=128,
                    occupancy=0.0)
    return bt, torch.zeros(200, F)


def test_kernel_argument_check():
    bt, x = _kernel_args()
    check_kernel_args(bt, x)  # well-formed: no error
    np.testing.assert_array_equal(bt.run_start.numpy(), [0, 1, 2, 3])
    bt, x = _kernel_args()
    bt.tiles = torch.zeros(3, 64, 64)
    with pytest.raises(ValueError, match="block_size 128"):
        check_kernel_args(bt, x)
    bt, x = _kernel_args()
    bt.tiles = bt.tiles.double()
    with pytest.raises(TypeError, match="tiles"):
        check_kernel_args(bt, x)
    bt, x = _kernel_args()
    with pytest.raises(TypeError, match="x"):
        check_kernel_args(bt, x.half())
    bt, x = _kernel_args()
    bt.tile_src = bt.tile_src.long()
    with pytest.raises(TypeError, match="tile_src"):
        check_kernel_args(bt, x)
    bt, x = _kernel_args()
    with pytest.raises(ValueError, match="contiguous"):
        check_kernel_args(bt, torch.zeros(8, 200).t())
    with pytest.raises(ValueError, match="not sorted"):
        BlockTiles(bt.tiles, bt.tile_src, torch.tensor([0, 2, 1], dtype=torch.int32),
                   bt.first_visit, 3, 2, 128, 0.0)
    bt, x = _kernel_args()
    bt.run_start = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="run_start"):
        check_kernel_args(bt, x)
    bt, x = _kernel_args()
    with pytest.raises(ValueError, match="n >= 1"):
        check_kernel_args(bt, torch.zeros(0, 8))


def test_wrapper_refuses_other_devices():
    bt, x = _kernel_args()
    with pytest.raises(ValueError, match="unsupported device"):
        block_spmm(bt, x.to("meta"))
