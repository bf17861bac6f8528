"""The benchmark's own tests (``python -m pytest bench`` from the root of
the checkout; they are not part of ``tests/``): the harness's modules and
the program's package importable, as ``bench/run.py`` makes them, and a
Grab-like cell cut to a size the CPU runs in seconds."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def shrink(cell):
    """``cell`` at 3,000 vertices and 15,000 background edges, 64-edge
    ticks in a window of 4, everything else as the cell has it."""
    cell.config["graph"].update(n_vertices=3000, background_edges=15000)
    cell.config["graph"]["dense_blocks"].update(edges=200)
    cell.traffic.update(batch_edges=64, window_ticks=4, warmup_slides=2, chunk_ticks=8)
    cell.traffic["burst"].update(window_tick=1, edges=30)
    cell.traffic["check"].update(sampled=2, within=6)
    cell.traffic["trace"].update(start_tick=6, ticks=3)
    return cell


@pytest.fixture
def small_cell():
    import harness

    return lambda workload: shrink(harness.load_cell(ROOT, workload))
