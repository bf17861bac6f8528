"""The port's CUDA kernels and engine on the card, against the plain
PyTorch versions on the same inputs.  Marked ``gpu``: each test skips
without a CUDA device (decided inside the ``cuda`` fixture, never at
import).  Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Integer-valued inputs are compared bit for bit; lognormal inputs to rtol
1e-5 on the sums (float atomics and block partials add in another order).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import peel as tpeel  # noqa: E402
from repro_torch.graphstore.generators import make_transaction_stream  # noqa: E402
from repro_torch.kernels.frontier_spmv import frontier_spmv, frontier_spmv_ref  # noqa: E402
from repro_torch.kernels.frontier_spmv import ops as k2_ops  # noqa: E402
from repro_torch.kernels.peel_round import peel_round, peel_round_ref  # noqa: E402
from repro_torch.kernels.peel_round import ops as k1_ops  # noqa: E402
from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.serve import SpadeService  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _assert_close(got, want, exact):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if exact or not g.is_floating_point():
            assert torch.equal(g.cpu(), w.cpu())
        else:
            torch.testing.assert_close(g.cpu(), w.cpu(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("V", [1, 255, 257, 100_000])
def test_peel_round_kernel_matches_plain(cuda, V, integer):
    rng = np.random.default_rng(V)
    if integer:
        w, a, dw = (rng.integers(0, k, V).astype(np.float32) for k in (9, 3, 4))
    else:
        w, a, dw = (rng.lognormal(m, 1.0, V).astype(np.float32) for m in (2.0, 0.0, 0.0))
    arrs = [torch.from_numpy(x).to(cuda) for x in
            (w, a, rng.random(V) < 0.7, rng.integers(-1, 9, V).astype(np.int32), dw)]
    th = torch.tensor(float(np.median(w)), device=cuda)
    r = torch.tensor(5, dtype=torch.int32, device=cuda)
    n0 = k1_ops.launches
    got = peel_round(*arrs, th, r)
    assert k1_ops.launches == n0 + 1
    _assert_close(got, peel_round_ref(*arrs, th, r), integer)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "lognormal"])
@pytest.mark.parametrize("pad", ["full", "workset"])
def test_frontier_spmv_kernel_matches_plain(cuda, pad, integer):
    rng = np.random.default_rng(7)
    V, m, E = 5000, 60_000, 65_536
    pad_id = V - 1 if pad == "full" else 0
    src = np.full(E, pad_id, np.int32)
    dst = np.full(E, pad_id, np.int32)
    src[:m], dst[:m] = rng.integers(0, V, m), rng.integers(0, V, m)
    c = np.zeros(E, np.float32)
    c[:m] = rng.integers(1, 6, m) if integer else rng.lognormal(1.0, 1.0, m)
    alive = np.zeros(E, bool)
    alive[:m] = rng.random(m) < 0.9
    peel = rng.random(V) < 0.2
    peel[pad_id] = True  # a peeled pad vertex must stay inert
    arrs = [torch.from_numpy(x).to(cuda) for x in (src, dst, c, alive, peel)]
    n0 = k2_ops.launches
    got = frontier_spmv(*arrs)
    assert k2_ops.launches == n0 + 1
    _assert_close(got, frontier_spmv_ref(*arrs), integer)


def test_kernel_wrappers_check_arguments(cuda):
    x = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        peel_round(x, x, x, x.int(), x, x[0], x[0].int())
    with pytest.raises(ValueError, match="elements"):
        frontier_spmv(x.int(), x[:4].int(), x, x.bool(), x.bool())


def test_bulk_peel_cuda_equals_cpu(cuda):
    from repro_torch.graphstore.structs import device_graph_from_coo

    rng = np.random.default_rng(3)
    n, m = 2000, 12_000
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    c = rng.integers(1, 6, keep.sum()).astype(np.float32)
    res = [tpeel.bulk_peel(device_graph_from_coo(n, src[keep], dst[keep], c,
                                                 device=d), eps=0.1)
           for d in (cuda, "cpu")]
    for f in ("level", "best_g", "best_level", "n_rounds", "delta"):
        assert torch.equal(getattr(res[0], f).cpu(), getattr(res[1], f)), f


@pytest.mark.parametrize("spec", [{}, {"window_ticks": 2, "workset": True}],
                         ids=["fused", "window2-workset"])
def test_service_cuda_equals_cpu(cuda, spec):
    stream = make_transaction_stream(n=3000, m=15000, seed=9)
    states, reps = [], []
    for d in ("cuda", "cpu"):
        svc = SpadeService("DG", batch_edges=512, device=d, **spec)
        reps.append(svc.run(stream))
        states.append(state_to_numpy(svc.final_state))
    assert reps[0].final_g == reps[1].final_g
    assert reps[0].live_edges == reps[1].live_edges
    for k, v in states[0].items():
        assert np.array_equal(np.asarray(v), np.asarray(states[1][k])), k


# K3 flash_attention: bf16 on the tensor cores against its plain versions
# (float32 inside) on the same bf16 inputs; atol = rtol = 2e-2, the
# tolerance tests/test_kernels.py gives the Pallas kernel in bf16 (the
# kernel rounds P to bf16 before P V, and its output to bf16).  Late rows
# average many keys and are small, so each band of 64 query rows is also
# held normwise: ||got - want|| / ||want|| <= 1e-2.


def _band_rel_err(got, want, band=64):
    err2 = (got.float() - want.float()).square().sum(dim=(0, 1, 3))
    want2 = want.float().square().sum(dim=(0, 1, 3))
    pad = -got.shape[2] % band
    err2, want2 = (torch.nn.functional.pad(t, (0, pad)).view(-1, band).sum(1)
                   for t in (err2, want2))
    return float((err2 / want2).sqrt().max())

FA_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window)
    (1, 4, 2, 128, 128, 64, True, None),
    (2, 10, 2, 333, 333, 128, True, None),   # qwen3's G = 5, ragged
    (1, 8, 8, 200, 200, 128, True, 64),      # window: tiles skipped
    (2, 6, 3, 197, 197, 64, True, 100),
    (1, 4, 1, 100, 300, 128, False, None),   # not causal, Sq != Skv
    # the edges of the 128 x 128 tiles: the second consumer warpgroup (query
    # rows 64-127 of a tile) with some live rows and with none
    (1, 4, 2, 70, 70, 128, True, None),
    (2, 4, 2, 60, 60, 64, True, None),
    # fewer than 128 keys; windows narrower than a kv tile
    (1, 4, 4, 300, 90, 64, False, None),
    (1, 10, 2, 100, 100, 128, True, None),
    (1, 8, 2, 600, 600, 128, True, 50),
    (1, 2, 1, 256, 256, 64, True, 1),
    # S a multiple of 128 and just past one, G = 5 and G = 1
    (1, 10, 2, 512, 512, 128, True, None),
    (2, 4, 4, 129, 129, 128, True, None),
    (1, 5, 1, 256, 256, 64, True, None),
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window", FA_CASES,
                         ids=[f"fa{i}" for i in range(len(FA_CASES))])
def test_flash_attention_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D, causal, window):
    from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention import ops as k3_ops

    rng = np.random.default_rng(Sq + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        cuda, torch.bfloat16) for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    n0 = k3_ops.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k3_ops.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    for want in (attention_ref(q, k, v, causal=causal, window=window),
                 flash_attention_ref(q, k, v, causal=causal, window=window,
                                     block_q=128, block_k=128)):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
        assert _band_rel_err(got, want) <= 1e-2


def test_flash_attention_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        cuda, torch.bfloat16) for s in ((2, 10, 700, 128), (2, 2, 700, 128), (2, 2, 700, 128)))
    first = flash_attention(q, k, v, window=300)
    again = flash_attention(q, k, v, window=300)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_model_flash_attention_cuda_matches_cpu(cuda):
    """Strided model-layout views through K3 against the CPU plain path."""
    from repro_torch.models.attention import flash_attention

    rng = np.random.default_rng(4)
    B, S, Hkv, G, D = 2, 150, 2, 5, 128
    q = torch.from_numpy(rng.standard_normal((B, S, Hkv, G, D), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda))
    want = flash_attention(q, k, v)
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=2e-2, rtol=2e-2)


def test_flash_attention_wrapper_raises_on_cuda(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as k3_ops

    q = torch.zeros(1, 2, 16, 128, device=cuda)
    n0 = k3_ops.launches
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros(1, 2, 16, 96, device=cuda, dtype=torch.bfloat16)
        flash_attention(x, x, x)
    assert k3_ops.launches == n0


# K4 gather_segsum: float32 FFMA over destination rows against the plain
# row-level version, the plain tile-level version on the same edges' tiles
# (through rows_from_tiles) and the COO oracle: bit for bit on integer-valued
# weights and x, where every sum is exact, else atol = rtol = 1e-4
# (tests/test_kernels.py's contract).

K4_CASES = [
    # (n_dst, n_src, n_edges, F, seed): tests/test_kernels.py's sweep, GCN's
    # widths, and rows longer than a warp's edges in flight
    (256, 256, 1000, 64, 0),
    (300, 200, 700, 16, 1),
    (128, 512, 2000, 128, 2),
    (512, 512, 100, 200, 3),
    (3072, 3072, 10_752, 7, 4),
    (1000, 5000, 60_000, 33, 5),
]


@pytest.mark.parametrize("integer", [True, False], ids=["int", "normal"])
@pytest.mark.parametrize("n_dst,n_src,m,F,seed", K4_CASES,
                         ids=[f"k4_{i}" for i in range(len(K4_CASES))])
def test_gather_segsum_kernel_matches_plain(cuda, n_dst, n_src, m, F, seed, integer):
    from repro_torch.kernels.gather_segsum import (block_spmm_ref, build_rows, build_tiles,
                                                   gather_segsum, rows_from_tiles, spmm_ref,
                                                   spmm_rows_ref)
    from repro_torch.kernels.gather_segsum import ops as k4_ops

    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(0, n_src, m).astype(np.int32)).to(cuda)
    dst = torch.from_numpy(rng.integers(0, n_dst, m).astype(np.int32)).to(cuda)
    if integer:
        val = torch.from_numpy(rng.integers(-3, 4, m).astype(np.float32)).to(cuda)
        x = torch.from_numpy(rng.integers(-4, 5, (n_src, F)).astype(np.float32)).to(cuda)
    else:
        val = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(cuda)
        x = torch.from_numpy(rng.normal(size=(n_src, F)).astype(np.float32)).to(cuda)
    rows = build_rows(src, dst, val, n_dst, n_src)
    assert rows.col.is_cuda and rows.row_ptr.is_cuda
    bt = build_tiles(src, dst, val, n_dst, n_src)
    n0 = k4_ops.launches
    got = gather_segsum(rows, x, n_dst)
    again = gather_segsum(rows, x, n_dst)
    tiled = gather_segsum(rows_from_tiles(bt), x, n_dst)
    torch.cuda.synchronize()
    assert k4_ops.launches == n0 + 3
    assert got.shape == (n_dst, F)
    assert torch.equal(got, again)  # the same bits every run
    plain = spmm_rows_ref(rows, x)
    block = block_spmm_ref(bt.tiles, bt.tile_src, bt.tile_dst, bt.first_visit, x,
                           bt.n_out_blocks)[:n_dst]
    coo = spmm_ref(src, dst, val, x, n_dst)
    if integer:
        assert torch.equal(got, plain) and torch.equal(got, coo)
        assert torch.equal(tiled, block)
    else:
        for want in (coo, plain):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(tiled, block, atol=1e-4, rtol=1e-4)


def test_gather_segsum_wrapper_raises_on_cuda(cuda):
    from repro_torch.kernels.gather_segsum import BlockRows, gather_segsum
    from repro_torch.kernels.gather_segsum import ops as k4_ops

    rows = BlockRows(torch.tensor([0, 1, 3], device=cuda),
                     torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda),
                     torch.ones(3, device=cuda), n_out=2, n_src=256)
    x = torch.zeros(256, 8, device=cuda)
    n0 = k4_ops.launches
    with pytest.raises(TypeError, match="x"):
        gather_segsum(rows, x.double(), 2)
    with pytest.raises(ValueError, match="n_out 3"):
        gather_segsum(rows, x, 3)
    with pytest.raises(ValueError, match="contiguous"):
        gather_segsum(rows, torch.zeros(8, 256, device=cuda).t(), 2)
    rows.col = rows.col.cpu()
    with pytest.raises(ValueError, match="on cpu"):
        gather_segsum(rows, x, 2)
    assert k4_ops.launches == n0


@pytest.mark.parametrize("arch", ["gcn-cora", "gat-cora", "meshgraphnet", "dimenet"])
def test_gnn_forward_cuda_matches_cpu(cuda, arch):
    """Smoke configs on a small graph; GCN runs through K4, 4 launches."""
    import dataclasses

    from repro_torch.configs import GNN_SHAPES, get_smoke_config
    from repro_torch.kernels.gather_segsum import ops as k4_ops
    from repro_torch.launch.cells import graph_batch
    from repro_torch.models.gnn import GNN, gcn_rows

    cfg = get_smoke_config(arch)
    spec = dataclasses.replace(GNN_SHAPES["full_graph_sm"], n_nodes=700, n_edges=3000,
                               d_feat=8)
    g_cpu = graph_batch(cfg, spec, seed=1, device="cpu")
    g_gpu = graph_batch(cfg, spec, seed=1, device=cuda)
    cpu = GNN(cfg, 8, device="cpu")
    gpu = GNN(cfg, 8, device=cuda, init=False)
    gpu.load_state_dict(cpu.state_dict())
    rows = gcn_rows(g_gpu) if arch == "gcn-cora" else None
    n0 = k4_ops.launches
    got = gpu(g_gpu, rows)
    torch.cuda.synchronize()
    assert k4_ops.launches == n0 + (4 if arch == "gcn-cora" else 0)
    want = cpu(g_cpu)
    scale = want.abs().amax(-1, keepdim=True).clamp(min=1e-6)
    assert bool(((got.cpu() - want).abs() <= 1e-4 * scale).all())
