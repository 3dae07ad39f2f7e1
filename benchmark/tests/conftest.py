"""Fixtures of the benchmark's own tests: a tiny copy of the harness for
runs on the CPU, and the card's presence, decided inside a fixture."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HARNESS = Path(__file__).resolve().parents[1]
ROOT = HARNESS.parent
for p in (str(HARNESS), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny stand-ins of the cells, on the cells' configuration at a size the CPU
# runs in seconds ("auto" resolves to naive at this size, so the tiny
# rollout names its incremental tier): {name: (config, particles, traffic,
# method)}.  A traffic mix of TRAFFIC is written into the copy; the others
# are the harness's own files.
TINY = {
    "tiny.rollout_inc": ("ddb3d_1m", 2500, "rollout_inc", "pallas_inc"),
    "tiny.frames": ("ddb3d_1m", 2500, "frames", "pallas"),
}
LIMITS_OF = {"tiny.rollout_inc": "ddb3d_1m.rollout_inc"}
# the viewer's loop (loops/frames.py), which no cell of BENCHMARK.json runs
# yet: its mix and limits as they stood when it had a cell (PERF.md)
TRAFFIC = {"frames": {
    "kind": "frames", "method": "auto", "steps_per_frame": 10,
    "frames_per_episode": 100, "warm_frames": 3, "width": 512,
    "height": 512, "color_by": "speed", "azimuth": 30.0, "elevation": 20.0,
    "check_steps": 10, "checked_frames": 2, "returned_rho": "last_step",
    "trace_a": 100, "trace_b": 10, "trace_c": 20}}
LIMITS = {"tiny.frames": {"pos_p999_h": 0.0005, "vel_p999_c": 0.0002,
                          "rho_p999": 0.0005, "fb_rel": 0.001,
                          "img_levels": 0}}


def make_tiny(dst: Path) -> Path:
    """A copy of the harness's data and readers with the tiny cells, and
    their BENCHMARK.json; returns its path."""
    h = dst / "harness"
    for sub in ("loops", "metrics", "kernels", "launchers", "rooflines",
                "configs", "traffic", "checks"):
        shutil.copytree(HARNESS / sub, h / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = []
    for name, (cfg, n, traffic, method) in TINY.items():
        c = json.loads((HARNESS / "configs" / f"{cfg}.json").read_text())
        c["scene"]["n_request"] = n
        conf = name.split(".")[0]
        (h / "configs" / f"{conf}.json").write_text(json.dumps(c))
        t = dict(TRAFFIC[traffic]) if traffic in TRAFFIC else json.loads(
            (HARNESS / "traffic" / f"{traffic}.json").read_text())
        t.update(method=method, warm={"pallas": 4, "to_step": 60,
                                      "method": "pallas_inc"})
        if t["kind"] == "rollout":
            t.update(steps_per_call=20, check_steps=16)
        else:
            t.update(frames_per_episode=6, width=64, height=48,
                     steps_per_frame=3, check_steps=3, warm_frames=1,
                     trace_a=6, trace_b=2, trace_c=2)
        tname = f"tiny_{traffic}"
        (h / "traffic" / f"{tname}.json").write_text(json.dumps(t))
        limits = LIMITS.get(name) or json.loads(
            (HARNESS / "checks" / f"{LIMITS_OF[name]}.json").read_text())
        (h / "checks" / f"{name}.json").write_text(json.dumps(limits))
        cells.append({"name": name, "config": conf, "traffic": tname,
                      "chips": 1, "why": "a tiny stand-in for the CPU"})
    bench["workloads"] = cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.rollout_inc"]
    # the frames loop's metrics, as readers of the tiny copy
    (h / "metrics" / "frame_ms_p95.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    lat = getattr(run, 'frame_latency', None)\n"
        "    return float(np.percentile(np.asarray(lat) * 1e3, 95.0)) "
        "if lat else None\n")
    (h / "metrics" / "render_ms.frames.py").write_text(
        "def read(run):\n    return getattr(run.trace, 'render_ms', None)\n")
    bench["end_to_end"].append({
        "name": "frame_ms_p95", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock", "workloads": ["tiny.frames"]})
    bench["per_layer"].append({
        "name": "render_ms.frames", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "render", "moves": "frame_ms_p95",
        "workloads": ["tiny.frames"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return h


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    dst = tmp_path_factory.mktemp("tiny")
    return make_tiny(dst)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
