"""Every data file and reader of the harness loads, BENCHMARK.json names
only files that exist, and a cell or a metric added as files alone is
found without an edit to the code."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import HARNESS, ROOT
from fbench import scene, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("sub", ["configs", "traffic", "checks", "kernels",
                                 "launchers"])
def test_json_files_load(sub):
    files = sorted((HARNESS / sub).glob("*.json"))
    assert files, sub
    for f in files:
        assert isinstance(json.loads(f.read_text()), dict), f


LOOP_API = ("warm", "window", "traced", "one", "comparisons")


def test_readers_counts_and_loops_load():
    for f in sorted((HARNESS / "metrics").glob("*.py")):
        assert callable(spec.load_module(f).read), f
    for t in sorted((HARNESS / "traffic").glob("*.json")):
        loop = spec.loop_module(HARNESS, json.loads(t.read_text())["kind"])
        assert all(callable(getattr(loop, f)) for f in LOOP_API), t
    for f in sorted((HARNESS / "rooflines").glob("*.py")):
        nbytes, flops = spec.load_module(f).count(10, 40.0, 3)
        assert nbytes > 0 and flops > 0, f


def test_tables_compile():
    t = spec.tables(HARNESS)
    names = {k["name"] for k in t["kernels"]}
    assert {"force_step", "density"} <= names
    for ent in t["launchers"]:
        assert {"file", "function", "layer"} <= set(ent)


def test_benchmark_names_existing_files():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = spec.load_cell(ROOT / "BENCHMARK.json", w["name"])
        assert cell.limits, f"{w['name']} has no limits file"
        assert (HARNESS / "traffic" / f"{w['traffic']}.json").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HARNESS / "metrics" / f"{m['name']}.py").exists()
        assert NAME.match(m["name"])


def test_every_cell_reports_its_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = spec.load_cell(ROOT / "BENCHMARK.json", w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names and m["moves"] in e2e


def test_config_particle_counts():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert scene.positions(cfg, 7).shape[0] == cfg["particles"]


def test_cell_and_metric_added_as_files(tmp_path):
    """A new loop, traffic mix, cell, limits and metric, each a new file,
    are found by name with no edit to the harness's code."""
    h = tmp_path / "harness"
    for sub in ("configs", "traffic", "checks", "metrics", "loops"):
        shutil.copytree(HARNESS / sub, h / sub)
    (h / "loops" / "movie.py").write_text(
        (HARNESS / "loops" / "rollout.py").read_text()
        + "\nRECORD_EVERY = 10\n")
    t = json.loads((h / "traffic" / "rollout_inc.json").read_text())
    t.update(steps_per_call=500, kind="movie")
    (h / "traffic" / "rollout_short.json").write_text(json.dumps(t))
    (h / "checks" / "ddb3d_1m.rollout_short.json").write_text(
        json.dumps({"pos_max_h": 1.0}))
    (h / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return run.attempted / run.window_s\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [{
        "name": "ddb3d_1m.rollout_short", "config": "ddb3d_1m",
        "traffic": "rollout_short", "chips": 1, "why": "500-step calls"}]
    bench["end_to_end"] = BENCH["end_to_end"] + [{
        "name": "calls_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["ddb3d_1m.rollout_short"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(tmp_path / "BENCHMARK.json",
                          "ddb3d_1m.rollout_short", h)
    assert cell.traffic["steps_per_call"] == 500
    assert spec.loop_module(h, cell.traffic["kind"]).RECORD_EVERY == 10
    assert cell.limits == {"pos_max_h": 1.0}
    names = [m["name"] for m in cell.end_to_end]
    assert "calls_per_s" in names and "setup_s" in names
    read = spec.metric_reader(h, "calls_per_s")
    assert read(type("R", (), {"attempted": 4, "window_s": 2.0})) == 2.0
