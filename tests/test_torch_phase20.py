"""``chip_smoke.py``'s phase 20 (the Spade cells and gcn-cora's train step
through ``shard_cell``) rehearsed on the CPU with the smoke configs: 20a,
one ``gloo`` rank on a (data 1, model 1) mesh, both Spade cells the
unsharded bits (phase 16c's, made here); 20b, four ``gloo`` ranks on
(data 2, model 2), the same bits (``best_g`` too: the smoke graph's sums
stay below 2^24), the dry run's all-reduces on every rank, the
dropped-partials control outside ``best_g``'s bound; 20c, gcn-cora on four
``gloo`` ranks against its unsharded steps, each rank's collectives the
dry run's, the dropped-aggregate control rejected; 20d, GAT, MeshGraphNet
and DimeNet in the same spawn against their unsharded steps, each rank's
collectives the dry run's, GAT's unsummed-denominators control rejected.
The card runs the same functions at full width (the kernels' launch
counts are checked there only: on the CPU the plain versions run).
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


def spade_bits(seed: int) -> dict:
    """What phase 16c keeps for phase 20, from the smoke cells on the CPU."""
    from repro_torch.launch.cells import build_cell

    out = {}
    for shape in chip_smoke.SPADE_CELL_FIELDS:
        cell = build_cell(chip_smoke.SPADE_ARCH, shape, concrete=True, smoke=True, seed=seed,
                          device="cpu")
        res = cell.fn(*cell.args)
        g = cell.args[0] if shape == "grab4_static" else cell.args[0].graph
        out[shape] = chip_smoke.spade_host(res, shape) | {
            "edges": int(g.edge_mask.sum()),
            "launches": {"peel_round": 0, "frontier_spmv": 0, "suffix_init": 0}}
    return out


def test_phase20_rehearsal(cpu_phase):
    out = chip_smoke.phase_sharded_cells(spade_bits(0), 0, smoke=True)
    rounds = 16  # the smoke config's max_rounds
    for shape, row in out["world1"].items():
        assert row["all_reduces"] == 1 + rounds == row["predicted"]["all_reduces"], shape
    for shape in chip_smoke.SPADE_CELL_FIELDS:
        w = out["world4"][shape]
        assert w["bits_equal_best_g"] and w["best_g_diff"] == 0.0
        assert w["all_reduces"] == 1 + rounds
        assert w["reduced_bytes"] == (1 + rounds) * (512 + 1) * 8
    static = out["world4"]["grab4_static"]
    assert abs(static["control_best_g_diff"][0]) > static["best_g_bound"]
    gcn = out["gcn"]
    assert gcn["max_rel_err"] < chip_smoke.GCN_TP_RTOL
    assert all(max(e.values()) > chip_smoke.GCN_TP_RTOL for e in gcn["control_errs"])
    assert gcn["collectives"]["bytes"] == gcn["predicted"]["bytes"]
    assert gcn["collectives"]["calls"] == gcn["predicted"]["calls"]
    assert gcn["collectives"]["calls"]["all-gather"] == 2  # h of each layer, over model
    for arch in chip_smoke.GNN_TP_ARCHS:
        d = out["gnn"][arch]
        assert d["max_rel_err"] < chip_smoke.GNN_TP_RTOL[arch], arch
        assert d["collectives"]["bytes"] == d["predicted"]["bytes"], arch
        assert d["collectives"]["calls"] == d["predicted"]["calls"], arch
    gat = out["gnn"]["gat-cora"]
    assert all(e["loss"] >= chip_smoke.GNN_TP_CONTROL_MARGIN * chip_smoke.GNN_TP_RTOL["gat-cora"]
               for e in gat["control_errs"])
    assert gat["collectives"]["calls"]["all-gather"] == 2  # h of each layer, over model
    assert out["launches_20d"] == 0
    for arch in chip_smoke.GNN_TP_ARCHS:
        assert len(out["gnn"][arch]["unsharded_spread"]) == chip_smoke.GNN_TP_STEPS


def test_gnn_remat_rehearsal(cpu_phase):
    """``chip_smoke.py --gnn-remat`` at smoke size: MeshGraphNet's and
    DimeNet's steps with and without the remat in turns, and DimeNet's
    step by kernel (the CPU's ops here)."""
    out = chip_smoke.gnn_remat(0, smoke=True, steps=1)
    for arch in ("meshgraphnet", "dimenet"):
        assert {k: len(v) for k, v in out[arch].items()} == {"remat": 2, "plain": 2}
    assert len(out["dimenet_kernels_ms"]) == 10
