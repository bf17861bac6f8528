"""The port's training launcher (``python -m repro_torch.launch.train``)
on the CPU: a checkpointed run resumes bit for bit, and the launcher
takes only training cells and needs a device or ``--device cpu``."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import pytree  # noqa: E402
from repro_torch.convert import train_state_to_numpy  # noqa: E402
from repro_torch.ft.checkpoint import latest_step  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def _state_np(state) -> dict:
    return {pytree.keystr(p): np.asarray(x)
            for p, x in pytree.leaves_with_path(train_state_to_numpy(state))}


@pytest.mark.parametrize("arch", ["qwen3-14b", "gcn-cora", "two-tower-retrieval"])
def test_resume_is_bit_identical(arch, tmp_path, capsys):
    """4 steps straight against 2, a fresh start that resumes from the
    checkpoint, and 2 more: the same bits in every leaf of the state."""
    torch.set_num_threads(1)
    common = ["--arch", arch, "--smoke", "--device", "cpu", "--ckpt-every", "2"]
    straight = train.main(common + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    train.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    assert latest_step(str(tmp_path / "b")) == 2
    resumed = train.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step 4 loss=" in out
    assert int(straight.step) == int(resumed.step) == 4
    assert latest_step(str(tmp_path / "b")) == 4
    a, b = _state_np(straight), _state_np(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_launcher_refuses_cells_that_do_not_train():
    with pytest.raises(SystemExit, match="not a train step"):
        train.main(["--arch", "two-tower-retrieval", "--shape", "serve_p99", "--smoke",
                    "--device", "cpu", "--steps", "1"])


def test_launcher_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "gcn-cora", "--smoke", "--steps", "1"])
