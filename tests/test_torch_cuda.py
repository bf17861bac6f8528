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
