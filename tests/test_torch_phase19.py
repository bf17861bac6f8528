"""``chip_smoke.py``'s phase 19 (the MoE LM serving path sharded on a
``DeviceMesh``) rehearsed on the CPU with the smoke configs: 19a, one
``gloo`` rank on a (data 1, model 1) mesh, olmoe-1b-7b's prefill, decode
steps, ``forward`` and ``lm_loss`` the unsharded run's bits; 19b, four
``gloo`` ranks on (data 2, model 2), each drawing the model from the seed
and keeping its shards, the logits within the phase's tolerances of the
unsharded run, the routing counted against 19a's, one layer's ``moe_ffn``
sharded against unsharded, each rank's collectives a step equal to the dry
run's prediction for the mesh, and the swapped-shard control rejected;
19c, mixtral-8x7b's smoke config (virtual experts unfolded) on two ranks
on (data 1, model 2), held to its unsharded run, its control rejected.
The card runs the same functions at full width (K3's launch counts are
checked there only: on the CPU attention runs its plain version).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

PROMPT, N_DECODE = 64, 3


@pytest.fixture
def cpu_phase(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    grad = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(grad)


def olmoe_reference() -> dict:
    """What phase 14c keeps for phase 19, from the smoke config on the CPU."""
    from repro_torch.models import decode_step, forward, lm_loss, prefill

    cfg = chip_smoke.moe_tp_cfg(chip_smoke.MOE_TP_ARCH, None, True)
    model = chip_smoke.moe_tp_model(cfg, 0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, PROMPT)))
    logits, cache = prefill(model, tokens)
    ref = {"tokens": tokens, "prefill_logits": logits.clone(), "fed": [], "decode_logits": [],
           "smoke": True, "n_layers": cfg.n_layers}
    tok = logits.argmax(-1)
    for i in range(N_DECODE):
        ref["fed"].append(tok)
        logits, cache = decode_step(model, cache, tok, torch.full((2,), PROMPT + i))
        ref["decode_logits"].append(logits.clone())
        tok = logits.argmax(-1)
    labels = torch.roll(tokens, -1, dims=1)
    flogits, faux = forward(model, tokens)
    loss, _ = lm_loss(model, tokens, labels)
    ref.update(labels=labels, forward_digest=chip_smoke.bits_digest(flogits),
               aux_digest=chip_smoke.bits_digest(faux), aux=float(faux),
               loss_digest=chip_smoke.bits_digest(loss), loss=float(loss))
    return ref


def test_phase19_rehearsal(cpu_phase):
    out = chip_smoke.phase_moe_tp(olmoe_reference(), 0)
    world1 = out["world1"]
    assert not any(world1["prefill_cost"]["bytes"].values())  # one rank: no collective
    for key, arch, n_ranks in (("world4", chip_smoke.MOE_TP_ARCH, 4),
                               ("world2_mixtral", chip_smoke.MIXTRAL_TP_ARCH, 2)):
        w = out[key]
        assert len(w["ranks"]) == n_ranks
        assert w["logit_rel_err_max"] < 1e-5  # float32: reordered sums only
        assert min(w["control_rel_err"]) > chip_smoke.MOE_TP_TOL[arch]
        assert w["rows"] == n_ranks * 2 * (N_DECODE + 1)
        # float32: nothing rerouted, every row whose routing was recorded
        # (19c records no forward: its prefill rows) held at the tight tolerance
        assert w["rows_alike"] == w["rows"] - (0 if key == "world4" else 2 * n_ranks)
        assert all(r["rerouted"] == 0 and r["keep_differs"] == 0 for r in w["routing"])
        for step in ("prefill", "decode"):
            got = w["collectives"][step]["rank0"]["bytes"]
            assert got == w["collectives"][step]["predicted"]["bytes"] and any(got.values())
    w4 = out["world4"]
    for r in w4["ranks"]:
        assert r["ffn512"]["routing_equal"] and r["ffn512"]["normwise_err"] < 1e-5
    assert w4["loss_rel_err"] < 1e-5 and w4["aux_rel_err"] < 1e-5


def test_phase19_float32_partial_sums_path(cpu_phase):
    """19b through ROADMAP C.12's diagnostic ranks (the attention's
    row-parallel partial sums formed and all-reduced in float32,
    ``moe_tp_rank_f32``): on the float32 smoke model it is the same
    function, so the logits hold the float32 tolerance, nothing is
    rerouted and both controls are rejected by their factors; the output
    projection is patched in the ranks only, not in this process."""
    from repro_torch.models import transformer

    out_proj = transformer._out_proj
    ref = olmoe_reference()
    w1 = chip_smoke.moe_tp_world1(ref, 0)
    w = chip_smoke.moe_tp_spawn("19b f32", dict(ref, routing=w1["routing"]), 0,
                                chip_smoke.MOE_TP_ARCH, ref["n_layers"], chip_smoke.MOE_TP_MESH,
                                rank_fn=chip_smoke.moe_tp_rank_f32)
    assert transformer._out_proj is out_proj
    assert w["logit_rel_err_max"] < 1e-5
    assert all(r["rerouted"] == 0 and r["keep_differs"] == 0 for r in w["routing"])
    assert all(len(r["rerouted_by_layer"]) == ref["n_layers"] for r in w["routing"])
    factors = chip_smoke.MOE_TP_CONTROL_FACTOR
    tol = chip_smoke.MOE_TP_TOL[chip_smoke.MOE_TP_ARCH]
    assert min(w["control_rel_err"]) > factors["experts"][chip_smoke.MOE_TP_ARCH] * tol
    assert min(w["control_wo_rel_err"]) > factors["experts_wo"][chip_smoke.MOE_TP_ARCH] * tol


def test_phase19_checks_logged(cpu_phase):
    """The diagnostics' ``checks_logged``: a failed check inside is
    logged and returned, and outside it stops the run again."""
    with chip_smoke.checks_logged([]) as failed:
        chip_smoke.check(False, "a planted failure")
        chip_smoke.check(True, "a check that holds")
    assert failed == ["a planted failure"]
    with pytest.raises(SystemExit):
        chip_smoke.check(False, "after the block")


def test_c12_batch_witness(cpu_phase):
    """ROADMAP C.12's single-device witness on the smoke config: the B 2
    run repeated routes every token alike, and each prompt alone, routed
    in the B 2 run's blocks, is counted over its own tokens in every
    layer."""
    cfg = chip_smoke.moe_tp_cfg(chip_smoke.MOE_TP_ARCH, None, True)
    out = chip_smoke.moe_batch_witness(0, smoke=True, prompt=PROMPT)
    assert out["b2_again"]["rerouted"] == 0 and out["b2_again"]["keep_differs"] == 0
    assert out["b2_again"]["tokens"] == 2 * PROMPT * cfg.n_layers
    for b in range(2):
        alone = out[f"prompt{b}_alone"]
        assert alone["tokens"] == PROMPT * cfg.n_layers
        assert len(alone["rerouted_by_layer"]) == cfg.n_layers
        assert 0.0 <= alone["rerouted_share"] <= 1.0
