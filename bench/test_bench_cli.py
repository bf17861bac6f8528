"""The command refuses to run without the CUDA devices its cell asks for,
and then prints no result."""

import subprocess
import sys

import pytest
import torch

from conftest import ROOT


def test_bench_cli_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "grab4-dw.slide-b4096",
                        "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr
