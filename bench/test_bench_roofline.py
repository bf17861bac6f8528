"""The byte and operation counts behind the roofline shares, against
counts made by hand on tiny inputs, and the trace arithmetic that turns
them into shares."""

import math

import torch

import devtrace
import harness

SRC = torch.tensor([0, 1, 2, 3, 0], dtype=torch.int32)
DST = torch.tensor([1, 2, 3, 0, 2], dtype=torch.int32)
C = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])


def metric(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


def test_bench_frontier_spmv_counts():
    alive = torch.tensor([1, 1, 1, 0, 1], dtype=torch.bool)
    peel = torch.tensor([1, 0, 0, 0], dtype=torch.bool)
    nbytes, ops = metric("frontier_spmv_roofline").work(
        SRC, DST, C, alive, peel, torch.zeros(4, dtype=torch.float64))
    # 5 liveness bytes; ends of the 4 live slots (8 B each); 2 hits (slots
    # 0 and 4: c read, liveness written); 4 distinct ends' peel bytes; 2
    # vertices take a sum (1, 2); the dropped mass
    assert int(nbytes) == 5 + 8 * 4 + 5 * 2 + 4 + 4 * 2 + 4
    assert int(ops) == 2 + 2  # dropped mass over 2 hits, 2 contributions


def test_bench_suffix_init_counts():
    mask = torch.tensor([1, 1, 1, 0, 1], dtype=torch.bool)
    live = torch.tensor([1, 1, 0, 1], dtype=torch.bool)
    a = torch.zeros(4)
    mod = metric("suffix_init_roofline")
    nbytes, ops = mod.work(SRC, DST, C, mask, live, a)
    # 5 mask bytes; ends of 4 masked slots; c of the one induced slot (0);
    # 5 `both` bytes; 4 live bytes; 3 priors; 4 weights and the total
    assert int(nbytes) == 5 + 8 * 4 + 4 * 1 + 5 + 4 + 4 * 3 + (4 * 4 + 4)
    assert int(ops) == 3 * 1 + 3
    nbytes, _ = mod.work(SRC, DST, C, mask, live, a, acc=torch.zeros(5, dtype=torch.float64))
    assert int(nbytes) == 5 + 8 * 4 + 4 * 1 + 5 + 4 + 4 * 3 + 8 * 5


def test_bench_roofline_share_and_dropped_kernels():
    # two calls of an entry with kernels k_a and k_b; the profiler lost one k_b
    ops = [("k_a", 0.0, 10.0), ("k_b", 10.0, 30.0), ("k_a", 40.0, 50.0)]
    trace = devtrace.Trace(ops=ops, spans=[], lo_us=0.0, hi_us=100.0)
    assert math.isclose(trace.kernel_seconds(("k_a", "k_b"), calls=2), (20 + 40) / 1e6)
    assert trace.kernel_seconds(("k_c",), calls=2) is None
    r = harness.Readings(ticks=[], tick_edges=[], window_s=1.0, setup_s=1.0, counters={},
                         trace=trace, peaks={"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1e12})
    r.work["m"] = torch.tensor([[3e6, 1.0], [1.0, 3e6]], dtype=torch.float64)
    assert math.isclose(r.roofline("m", ("k_a", "k_b")), 100 * 6e-6 / 60e-6)
    assert math.isclose(trace.busy_s, 40e-6)


def test_bench_idle_gaps_by_span():
    busy = devtrace.merge([(0, 10), (5, 20), (50, 60)])
    assert busy == [(0, 20), (50, 60)]
    spans = [(15, 40, "maintain"), (40, 45, "sync")]
    gaps = devtrace.attribute_gaps(busy, spans, 0, 70)
    # idle 20-50 (maintain 20-40, sync 40-45, other 45-50) and 60-70 (other)
    assert gaps == {"maintain": 20, "sync": 5, "other": 15}
