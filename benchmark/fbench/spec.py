"""Finding a cell's files by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells, each with a
configuration and a traffic mix, and the metrics, each with the cells it
is reported in (all cells when it has no ``workloads`` key).  Under the
harness's folder:

  configs/<config>.json     the scene, its physics and guarantees
  traffic/<traffic>.json    a mix's parameters; its ``kind`` names its loop
  loops/<kind>.py           a loop: set-up's warm call, the window, the
                            traced windows, the comparisons (fbench.bench)
  checks/<workload>.json    each compared number's limit
  metrics/<metric>.py       a reader: ``read(run) -> float | None``
  kernels/<kernel>.json     a device kernel's name pattern and layer
  launchers/<name>.json     a function of the port and the layer of what
                            it launches
  rooflines/<kernel>.py     the work of one launch: ``count(n, pairs)``
                            -> (bytes, flops)

Adding a cell, loop, metric, kernel or launcher is adding a file.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple, Optional

HARNESS = Path(__file__).resolve().parents[1]


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: Optional[dict]
    end_to_end: list
    per_layer: list
    harness: Path


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(bench_json: Path, workload: str,
              harness: Path = HARNESS) -> Cell:
    bench = _json(bench_json)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_json}; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    limits_path = harness / "checks" / f"{workload}.json"
    return Cell(
        name=workload,
        config=_json(harness / "configs" / f"{w['config']}.json"),
        traffic=_json(harness / "traffic" / f"{w['traffic']}.json"),
        chips=w["chips"],
        limits=_json(limits_path) if limits_path.exists() else None,
        end_to_end=[m for m in bench["end_to_end"] if _listed(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _listed(m, workload)],
        harness=harness)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "fbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_module(harness: Path, kind: str):
    return load_module(harness / "loops" / f"{kind}.py")


def metric_reader(harness: Path, name: str):
    return load_module(harness / "metrics" / f"{name}.py").read


def roofline_count(harness: Path, kernel: str):
    path = harness / "rooflines" / f"{kernel}.py"
    return load_module(path).count if path.exists() else None


def tables(harness: Path) -> dict:
    from .trace import compile_tables
    kernels = [dict(_json(p), name=p.stem)
               for p in sorted((harness / "kernels").glob("*.json"))]
    launchers = [_json(p)
                 for p in sorted((harness / "launchers").glob("*.json"))]
    return compile_tables(kernels, launchers)
