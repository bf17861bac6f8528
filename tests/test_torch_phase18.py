"""``chip_smoke.py``'s phase 18 (the dense LM train step sharded on a
``DeviceMesh`` with FSDP) rehearsed on the CPU with qwen3-14b's smoke
config (float32): 18k, K3's Function under ``local_map`` with the q heads
sharded on 18b's two ``gloo`` ranks, against plain autograd; 18a, one ``gloo``
rank on a (data 1, model 1) mesh, its step through ``shard_cell`` the
unsharded step's bits (loss, grad_norm and the digests of every updated
leaf); 18b, two ``gloo`` ranks on (data 2, model 1), each drawing the
model from the seed in turn and keeping its shards, two steps within the
phase's tolerances of the unsharded steps, each rank's state half the
unsharded one and its collectives in a step equal to the dry run's
prediction for the mesh; and the controls of 18b's rules: the sharded steps
with one rank's gradient partials dropped before the reduce-scatter break
the leaf rule.  The card runs the same functions at full width (K3's
launch counts and the memory are checked there only).
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


def test_bits_digest_sees_one_bit():
    x = torch.arange(1000, dtype=torch.float32).reshape(10, 100) / 7
    d = chip_smoke.bits_digest(x)
    assert chip_smoke.bits_digest(x.clone()) == d
    y = x.clone()
    y.view(-1).view(torch.int32)[517] ^= 1
    assert chip_smoke.bits_digest(y) != d
    z = x.clone()
    z[[0, 1]] = x[[1, 0]]  # the same bits in other places
    assert chip_smoke.bits_digest(z) != d
    assert chip_smoke.bits_digest(x.to(torch.bfloat16)) != chip_smoke.bits_digest(
        x.to(torch.bfloat16) * 2)


def test_phase18_rehearsal(cpu_phase):
    world1 = chip_smoke.fsdp_world1(None, 0, smoke=True)
    assert world1["leaves_equal"] > 0
    world2 = chip_smoke.fsdp_world2(0, smoke=True)
    assert all(max(r["errs"].values()) < 1e-5 for r in world2["k3"]["ranks"])  # float32
    assert max(world2["metrics_rel_err"].values()) < 1e-5  # float32: reordered sums only
    got = world2["collectives"]["rank0"]["bytes"]
    assert got == world2["collectives"]["predicted"]["bytes"]
    assert got["all-gather"] > 0 and got["reduce-scatter"] > 0 and got["all-reduce"] > 0
    assert all(r["state_gb"] < 0.51 * world2["plain"]["state_gb"] for r in world2["ranks"])


def test_phase18_controls(cpu_phase):
    """The leaf rule can fail: dropping rank 1's gradient partials (half
    the batch's gradient) puts far more than FSDP_ODD of a leaf's elements
    beyond tolerance, where the sharded steps as 18b runs them stay
    within it.  In float32 the float32 reduce-scatter is the same step,
    and two microbatches of one row are the unsharded step within the
    rules."""
    got = chip_smoke.fsdp_controls(0, smoke=True)
    assert got["none"]["passes"] and got["none"]["odd_share_max"] <= chip_smoke.FSDP_ODD
    assert got["f32"]["odd_share_max"] == got["none"]["odd_share_max"]
    assert not got["drop"]["passes"]
    assert got["drop"]["odd_share_max"] > 2 * chip_smoke.FSDP_ODD
    assert got["micro2"]["passes"] and got["none_vs_micro2"]["passes"]
