"""``chip_smoke.py``'s phase 17 (the dense LM serving path sharded on a
``DeviceMesh``) rehearsed on the CPU with qwen3-14b's smoke config: 17a,
one ``gloo`` rank on a (data 1, model 1) mesh taking over the unsharded
model, its prefill (logits and cache) and every decode step the unsharded
run's bits; 17b, two ``gloo`` ranks on (data 1, model 2), each drawing
the model from the seed and keeping its shards, the logits within the
phase's tolerance of the unsharded run and each rank's collectives a
step equal to the dry run's prediction for the mesh.  The card runs the
same functions at full width (K3's launch counts are checked there only:
on the CPU attention runs its plain version).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

PROMPT, N_DECODE = 64, 4


@pytest.fixture
def cpu_phase(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    grad = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(grad)


def test_phase17_rehearsal(cpu_phase):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import TransformerLM, decode_step, prefill

    cfg = get_smoke_config(chip_smoke.LM_ARCH)
    model = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, PROMPT)))
    logits, cache = prefill(model, tokens)
    ref = {"tokens": tokens, "prefill_logits": logits.clone(),
           "cache": (cache.k.clone(), cache.v.clone()), "fed": [], "decode_logits": [],
           "smoke": True}
    tok = logits.argmax(-1)
    for i in range(N_DECODE):
        logits, cache = decode_step(model, cache, tok, torch.full((2,), PROMPT + i))
        ref["fed"].append(tok)
        ref["decode_logits"].append(logits.clone())
        tok = logits.argmax(-1)
    world1 = chip_smoke.tp_world1(ref, model)
    assert not any(world1["prefill_cost"]["bytes"].values())  # one rank: no collective
    ref["model_layers"] = cfg.n_layers
    world2 = chip_smoke.tp_world2(ref, 0)
    assert world2["logit_rel_err_max"] < 1e-5  # float32: reordered sums only
    assert world2["rows_decided"] + world2["rows_tied"] == 2 * 2 * (N_DECODE + 1)
    for step in ("prefill", "decode"):
        got = world2["collectives"][step]["rank0"]["bytes"]
        assert got == world2["collectives"][step]["predicted"]["bytes"] and any(got.values())
