"""``chip_smoke.py``'s phase 22 (two-tower-retrieval on ``rows`` through
``shard_cell``, and a sharded state's checkpoints) rehearsed on the CPU
with the smoke config: 22a, one ``gloo`` rank on a (data 1, model 1)
mesh, the unsharded bits; 22b, four ``gloo`` ranks on (data 2, model 2)
serving within ``TT_TOL`` of the unsharded scores, the top 100 the
unsharded one but at ties, each rank's collectives equal to the dry run's
prediction for the mesh; 22c, two train steps within the phase's
tolerances of the unsharded steps, the offset-rows control rejected;
22d, a ``CheckpointManager`` on the four ranks, restored onto (data 1,
model 2) and onto one device bit for bit.  The card runs the same
functions at full width (its memory is checked there only).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture
def cpu_phase(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    grad = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(grad)


def test_phase22_rehearsal(cpu_phase):
    ref, ref_train = chip_smoke.tt_smoke_reference(0)
    out = chip_smoke.phase_two_tower_sharded(ref, ref_train, 0, smoke=True)
    w = out["world4"]
    for name in ("serve_p99", "serve_bulk"):
        assert w["serve"][name]["err_of_temp"] < 1e-6, name
    for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
        got = w["serve"][name]
        assert got["cost"]["bytes"] == got["predicted"]["bytes"], name
        assert sum(got["cost"]["calls"].values()) > 0, name
    assert w["serve"]["retrieval_cand"]["positions_differing"] == 0
    t = w["train"]
    assert max(t["rel_err"].values()) < 1e-5 and t["control_rel"] > 1e-3
    assert t["cost"]["bytes"] == t["predicted"]["bytes"]
    assert w["ckpt"]["leaves"] > 0 and not any(out["launches"].values())
