"""The port's ``SpadeService`` (on the CPU) against the JAX reference's, on
the stream of the verify recipe: ``make_transaction_stream(n=3000,
m=15000, seed=9)`` in 512-edge ticks.

Under DG (integer weights) every report field but the timing fields is
equal.  Under DW the counts are equal and ``final_g`` agrees to rtol 1e-5:
lognormal amounts make the float32 sums (edge masses, f, the community
loss) depend on summation order, which differs between the frameworks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphstore.generators import make_transaction_stream  # noqa: E402
from repro.serve import SpadeService as JaxService  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.graphstore.structs import device_graph_from_coo  # noqa: E402
from repro_torch.serve import EngineSpec, SpadeService  # noqa: E402

TIMING = {"mean_tick_seconds", "mean_us_per_edge", "tick_seconds"}
DW_EQUAL = ("fraud_recall", "n_ticks", "live_edges", "n_expired_edges",
            "n_workset_ticks", "n_fallback_ticks", "n_predicted_ticks",
            "n_bucket_miss_ticks")
SPECS = [{}, {"window_ticks": 8}, {"window_ticks": 8, "workset": True},
         {"window_ticks": 2}, {"window_ticks": 2, "workset": True}]
SPEC_IDS = ["plain", "window8", "window8-workset", "window2", "window2-workset"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    return make_transaction_stream(n=3000, m=15000, seed=9)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_service_dg_reports_equal(stream, spec):
    want = JaxService("DG", batch_edges=512, **spec).run(stream)
    svc = SpadeService("DG", batch_edges=512, device="cpu", **spec)
    got = svc.run(stream)
    for f in dataclasses.fields(want):
        if f.name not in TIMING:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.fraud_recall == 1.0
    assert int(svc.final_state.edge_count) == got.live_edges
    if spec.get("window_ticks") == 2:
        assert got.n_expired_edges > 0  # the window really slid


@pytest.mark.parametrize("spec", SPECS[:3], ids=SPEC_IDS[:3])
def test_service_dw_reports_agree(stream, spec):
    want = JaxService("DW", batch_edges=512, **spec).run(stream)
    got = SpadeService("DW", batch_edges=512, device="cpu", **spec).run(stream)
    for f in DW_EQUAL:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_allclose(got.final_g, want.final_g, rtol=1e-5)
    np.testing.assert_allclose(got.benign_fraction, want.benign_fraction, rtol=1e-3)


def test_entry_points_need_a_device_without_gpu():
    """With no GPU, an entry point called without ``device`` raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is the working default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpadeService("DG")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_graph_from_coo(3, np.array([0, 1]), np.array([1, 2]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy({})
    # the host plane is NumPy on the host CPU: it needs no device
    assert SpadeService("DG", plane="host").device is None
    # a mesh must be a torch.distributed DeviceMesh, and only on the device
    # plane (the sharded engine runs under torch.distributed: tests/test_torch_dist.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        EngineSpec(mesh=object())
    with pytest.raises(ValueError, match="device-plane settings"):
        EngineSpec(plane="host", mesh=object())


def test_launch_cli_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--semantics", "DG", "--vertices", "500",
          "--edges", "2500", "--batch", "128", "--window", "2", "--workset"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "recall=" in out


def _decayed(xp, src, dst, raw, deg, t):
    """The README's time-decayed amount (a ``uses_aux`` semantics)."""
    return xp.maximum(raw, 1e-12) * 2.0 ** (-(1.0 - (0.0 if t is None else t)))


@pytest.mark.parametrize("kind", ["FD", "aux"])
def test_service_degree_and_aux_semantics_agree(stream, kind):
    """FD (arrival-time degrees through the B x B count) and a semantics
    reading the per-edge timestamp: counts equal, ``final_g`` to rtol 1e-5
    (FD's ``log`` and lognormal sums differ in the last bits)."""
    from repro.core.semantics import SuspSemantics as JaxSemantics
    from repro_torch.core.semantics import SuspSemantics

    if kind == "FD":
        jsem = tsem = "FD"
    else:
        jsem = JaxSemantics(name="TDW", esusp=_decayed, uses_aux=True)
        tsem = SuspSemantics(name="TDW", esusp=_decayed, uses_aux=True)
    spec = {"window_ticks": 2, "workset": True}
    want = JaxService(jsem, batch_edges=512, **spec).run(stream)
    got = SpadeService(tsem, batch_edges=512, device="cpu", **spec).run(stream)
    for f in DW_EQUAL:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_allclose(got.final_g, want.final_g, rtol=1e-5)
