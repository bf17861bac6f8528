"""The check that decides ``correct``, driven through the rest of a run on
the CPU at a small size (the look for a chip skipped): a sound run
passes, the control (the reference in bfloat16 in the program's place)
fails, and so does a run whose timed path is broken underneath, once for
each fault this cell can have.  (Its one device holds everything: there
is no exchange between chips to leave out.)"""

import time

import pytest
import torch

import harness

CELLS = ("grab4-dw.slide-b4096", "grab4-fd.slide-b4096")


def run(cell, seed=2**32 + 9, control=False):
    return harness.run_cell(cell, seed, 0.2, 0, "cpu", time.perf_counter(), control=control)[1]


def failing(out) -> set:
    return {k for k, c in out.checks.items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("workload", CELLS)
def test_bench_sound_run_is_correct(small_cell, workload):
    out = run(small_cell(workload))
    assert out.correct and not failing(out), out.checks


@pytest.mark.parametrize("workload", CELLS)
def test_bench_control_fails(small_cell, workload):
    from spade import check

    cell = small_cell(workload)
    out = run(cell, control=True)
    assert out.correct
    control_correct, checks = check.judge_control(out.control, cell.limits)
    assert set(checks) == set(cell.limits)
    assert not control_correct, checks


def _state_unchanged(real):
    def step(state, *args, **kwargs):
        _, info = real(state, *args, **kwargs)
        return state, info
    return step


def _half_batch(real):
    def step(state, drop, src, dst, c, valid, *args, **kwargs):
        half = valid & (torch.arange(valid.shape[0]) < valid.shape[0] // 2)
        return real(state, drop, src, dst, c, half, *args, **kwargs)
    return step


def _answer_altered(real):
    def weights(self, *args, **kwargs):
        w, deg = real(self, *args, **kwargs)
        return torch.cat([w[:1] * 1.5, w[1:]]), deg
    return weights


@pytest.mark.parametrize("fault, target", [
    (_state_unchanged, "repro_torch.core.incremental:slide_and_maintain_predictive"),
    (_half_batch, "repro_torch.core.incremental:slide_and_maintain_predictive"),
    (_answer_altered, "repro_torch.core.semantics:SuspSemantics.batch_weights"),
])
@pytest.mark.parametrize("workload", CELLS)
def test_bench_planted_fault_is_caught(small_cell, monkeypatch, workload, fault, target):
    import importlib

    module, attr = target.split(":")
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    monkeypatch.setattr(owner, name, fault(getattr(owner, name)))
    out = run(small_cell(workload))
    assert not out.correct and failing(out)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_bench_small_cell_on_the_card(small_cell, workload):
    """The harness and the kernels on a card, at the small size (run on the
    chip with ``python -m pytest -m gpu bench``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = small_cell(workload)
    line, out = harness.run_cell(cell, 3, 0.5, 1, "cuda:0", time.perf_counter())
    assert out.correct, out.checks
    assert out.readings.counters["k1_launches"] > 0
