"""``chip_smoke.py``'s reading of a ``torch.profiler`` trace
(``read_trace``): a whole trace is the median over the calls; a trace
short by up to ``DROPPED_MAX`` kernels, or a quarter of the kernels it
kept where that is more, is read kernel by kernel, each kernel's median
time times the times a call launches it, whatever the CUDA-event span of
the same calls (a bound on the mean, not on the median); a trace short by
more, or one without device time, is refused (the caller takes it again
over twice the calls, and fails after ``PROFILE_ATTEMPTS``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _events(calls: list[list[tuple[str, float]]]) -> list:
    """Device events, one list of (name, us) a call, in launch order."""
    return [SimpleNamespace(name=name, time_range=SimpleNamespace(elapsed_us=lambda us=us: us))
            for call in calls for name, us in call]


def _calls(n: int) -> list[list[tuple[str, float]]]:
    """``n`` calls of a kernel "k" (100 us, 101 us in every fourth call)
    and a kernel "c" (2 us)."""
    return [[("k", 101.0 if i % 4 == 0 else 100.0), ("c", 2.0)] for i in range(n)]


DROP = chip_smoke.DROPPED_MAX
N = 12  # calls: DROPPED_MAX is more than a quarter of their kernels
M = 8 * DROP  # calls: a quarter of their kernels is more than DROPPED_MAX


def _short(n: int, k: int) -> list[list[tuple[str, float]]]:
    """``n`` calls, the first ``k`` of them without their "c" kernel."""
    return [c[:1] for c in _calls(n)[:k]] + _calls(n)[k:]


CASES = {
    "whole": (N, _calls(N), 10_000.0, 102.0, None),
    "one dropped": (N, _calls(N)[:-1] + [[("k", 100.0)]], 10_000.0, 102.0, None),
    "DROPPED_MAX dropped": (N, _short(N, DROP), 10_000.0, 102.0, None),
    "one more dropped": (N, _short(N, DROP + 1), 10_000.0, None,
                         f"is short of {DROP + 1} kernels"),
    # 2M - k kernels kept of 2M: k dropped is at most a quarter of them
    # while 5k <= 2M
    "a quarter of the kernels kept dropped": (M, _short(M, 2 * M // 5), 100_000.0, 102.0,
                                              None),
    "one more than a quarter dropped": (M, _short(M, 2 * M // 5 + 1), 100_000.0, None,
                                        f"is short of {2 * M // 5 + 1} kernels"),
    "no device time": (N, [[("k", 0.0)]] * N, 10_000.0, None, "recorded no device time"),
    "longer than its span": (N, _calls(N)[:-1] + [[("k", 100.0)]], 1_200.0, 102.0, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_read_trace(case):
    n, calls, span_us, want, fault = CASES[case]
    us, why = chip_smoke.read_trace(_events(calls), n, span_us)
    if fault is None:
        assert why is None and us == want
    else:
        assert fault in why
