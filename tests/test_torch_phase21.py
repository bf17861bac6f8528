"""``chip_smoke.py``'s phase 21 (the MoE LM train step sharded on a
``DeviceMesh`` with FSDP) rehearsed on the CPU with the smoke configs
(float32): olmoe-1b-7b's unsharded steps twice (on the CPU they repeat
their bits); 21a, one ``gloo`` rank on a (data 1, model 1) mesh through
``shard_cell``, bit for bit; 21b and 21c, four ``gloo`` ranks on (data 2,
model 2), olmoe two steps and mixtral-8x7b one, within the phase's
tolerances of the unsharded steps, each rank's collectives in step 1 equal
to the dry run's prediction for the mesh, step 1's per-token NLL equal
to the unsharded step's (no token rerouted in float32), and the
swapped-shard control rejected.  The card runs the same functions at
full width (K3's launch counts and the memory are checked there only).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture
def cpu_phase(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    grad = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(grad)


def test_phase21_rehearsal(cpu_phase):
    out = chip_smoke.phase_moe_fsdp(0, smoke=True)
    world1 = out["world1"]
    assert world1["unsharded_repeats"] and world1["rule"].startswith("bit for bit")
    for key, arch in (("world4", chip_smoke.MOE_FSDP_ARCH),
                      ("world4_mixtral", chip_smoke.MIXTRAL_TP_ARCH)):
        w = out[key]
        assert max(max(e) for e in w["metrics_rel_err"].values()) < 1e-5, arch
        got = w["collectives"]["rank0"]
        assert got["bytes"] == w["collectives"]["predicted"]["bytes"], arch
        assert got["calls"] == w["collectives"]["predicted"]["calls"], arch
        assert got["calls"]["all-gather"] > 0 and got["calls"]["reduce-scatter"] > 0
        tol = chip_smoke.MOE_FSDP_NLL_TOL
        assert all(r["rerouted"] == 0.0 and r["nll_max"] < 1e-5 for r in w["sound"]), arch
        assert min(c["nll_mean"] for c in w["control"]) > w["control_factor"] * tol, arch
