"""The port's example twins (``examples/torch_*.py``) run on the CPU at a
small size, each in a few seconds (``--device cpu`` for the device
services)."""

from __future__ import annotations

import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SMALL = ["--vertices", "600", "--edges", "3000"]
RUNS = {
    "torch_quickstart": (SMALL, "planted colluding actor 600 detected: True"),
    "torch_streaming_fraud_service": (SMALL, "FD     grouping"),
    "torch_sliding_window_service": (SMALL + ["--device", "cpu", "--batch", "64"],
                                     "host slide:"),
    "torch_multi_pod_fraud_scan": (SMALL + ["--device", "cpu", "--batch", "256"],
                                   "tick 2:"),
    "torch_custom_semantics_service": (SMALL + ["--device", "cpu", "--batch", "64"],
                                       "host oracle under TDW"),
    "torch_fraud_aware_recsys": (SMALL + ["--device", "cpu", "--steps", "3"],
                                 "retrieval training on clean stream (cpu)"),
}


@pytest.fixture(autouse=True)
def _own_registry(monkeypatch):
    """A semantics an example registers ("TDW") stays inside its test, so
    the registry the other tests of this process see is the package's own."""
    from repro_torch.core import semantics

    monkeypatch.setattr(semantics, "_REGISTRY", dict(semantics._REGISTRY))


@pytest.mark.parametrize("name", list(RUNS))
def test_example_twin_runs_on_cpu(name, capsys, monkeypatch):
    argv, expect = RUNS[name]
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    torch.set_num_threads(1)
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert expect in out, out


def test_train_lm_twin_runs_and_resumes_on_cpu(tmp_path, capsys, monkeypatch):
    torch.set_num_threads(1)
    for _ in range(2):
        monkeypatch.setattr(sys, "argv", ["torch_train_lm.py", "--steps", "2", "--device", "cpu",
                                          "--ckpt-dir", str(tmp_path)])
        runpy.run_path(str(EXAMPLES / "torch_train_lm.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "step 2 loss=" in out and "resumed from step 2" in out and "step 4 loss=" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["torch_train_lm.py", "--ckpt-dir", str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(str(EXAMPLES / "torch_train_lm.py"), run_name="__main__")


@pytest.mark.parametrize("name", ["torch_sliding_window_service",
                                  "torch_multi_pod_fraud_scan",
                                  "torch_custom_semantics_service",
                                  "torch_fraud_aware_recsys"])
def test_example_device_part_needs_a_device_without_gpu(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is the working default")
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *SMALL])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
