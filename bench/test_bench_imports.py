"""Nothing a run loads is JAX or the JAX package (compared by whole
top-level names, so ``repro_torch`` passes and ``repro`` fails), and no
file of the benchmark reads the JAX package's old benchmarks."""

import subprocess
import sys

from conftest import BENCH, ROOT

RUN = r"""
import sys, time
sys.path[:0] = [{src!r}, {bench!r}]
import run, harness, devtrace, control
from spade import check, driver, reference, stream, numpy_stream
from conftest import shrink
cell = shrink(harness.load_cell(run.ROOT, "grab4-fd.slide-b4096"))
for m in cell.end_to_end + cell.per_layer:
    cell.metric(m["name"])
line, out = harness.run_cell(cell, 5, 0.2, 0, "cpu", time.perf_counter())
assert out.correct, out.checks
{extra}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(harness.forbidden_modules())
"""


def loaded(extra: str = "") -> tuple[list, list]:
    code = RUN.format(src=str(ROOT / "src"), bench=str(BENCH), extra=extra)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    *_, names, forbidden = p.stdout.strip().splitlines()
    return eval(names), eval(forbidden)


def test_bench_run_loads_no_jax():
    names, forbidden = loaded()
    assert "repro_torch" in names and "torch" in names
    assert not {"jax", "jaxlib", "flax", "repro"} & set(names)
    assert forbidden == []


def test_bench_forbidden_check_tells_repro_from_repro_torch():
    _, forbidden = loaded("import types; sys.modules['repro'] = types.ModuleType('repro')\n"
                          "sys.modules['repro.core'] = types.ModuleType('repro.core')")
    assert forbidden == ["repro", "repro.core"]


def test_bench_reads_nothing_of_the_old_benchmarks():
    for path in BENCH.rglob("*"):
        if path.suffix in (".py", ".json", ".md") and path.name != "test_bench_imports.py":
            text = path.read_text()
            assert "benchmarks" not in text and "BENCH_" not in text, path
