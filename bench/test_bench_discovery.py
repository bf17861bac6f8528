"""A configuration, a traffic mix, a cell's limits and a metric added as
files alone are found by name, with no edit to any file already there."""

import json
import shutil

import harness
from conftest import ROOT


def test_bench_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    cfg = json.loads((bench / "configs" / "spade-grab4-dw.json").read_text())
    cfg["name"] = "spade-new"
    cfg["graph"]["n_vertices"] = 1234
    (bench / "configs" / "spade-new.json").write_text(json.dumps(cfg))
    (bench / "configs" / "spade-new.py").write_text(
        "USES_DEGREE = False\n\ndef esusp(raw, deg):\n    return raw * 0 + 1\n")
    mix = json.loads((bench / "traffic" / "slide-b4096.json").read_text())
    mix.update(name="slide-b256", batch_edges=256, window_ticks=1024)
    (bench / "traffic" / "slide-b256.json").write_text(json.dumps(mix))
    (bench / "limits" / "new.slide-b256.json").write_text(json.dumps({"seed_w": 0}))
    (bench / "metrics" / "ticks_seen.py").write_text(
        "def read(r):\n    return len(r.ticks)\n")
    spec["configs"].append({"name": "spade-new", "source": "x", "file": "bench/configs/spade-new.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new.slide-b256", "config": "spade-new",
                              "traffic": "slide-b256", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "ticks_seen", "unit": "ticks", "better": "higher",
                              "source": "host_clock", "layer": "service", "moves": "edges_per_s",
                              "workloads": ["new.slide-b256"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell(tmp_path, "new.slide-b256", bench=bench)
    assert cell.config["graph"]["n_vertices"] == 1234
    assert cell.traffic["batch_edges"] == 256 and cell.limits == {"seed_w": 0}
    assert [m["name"] for m in cell.per_layer] == ["ticks_seen"]
    assert cell.reference().esusp(2.0, 0) == 1.0
    r = harness.Readings(ticks=[0.1, 0.2], tick_edges=[256, 256], window_s=0.3, setup_s=1.0,
                         counters={})
    line = json.loads(harness.result_line(cell, r, 1, True, 2, 0, {}, {}, None))
    assert line["metrics"] == {"ticks_seen": {"value": 2.0, "unit": "ticks"}}
    assert json.loads(harness.result_line(cell, r, 0, True, 2, 0, {}, {}, None))["metrics"][
        "edges_per_s"]["value"] == 512 / 0.3
    # the old cells still find their own files, and no file that was there changed
    assert harness.load_cell(tmp_path, "grab4-dw.slide-b4096", bench=bench).config["name"] \
        == "spade-grab4-dw"
    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
