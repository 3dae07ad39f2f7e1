"""The ``ddb3d_5m`` cell's own pieces on the CPU: ``seam_movers_per_step``
reads a hand-made record and reads nothing where the record has no
``inc.step`` span or no ``seam_movers`` counter; a tiny stand-in of the
cell (the ``ddb3d_5m`` scene at 2,500 particles on ``rollout_inc_500``)
loads the mix's keys and runs its loop, traced and untraced."""

from __future__ import annotations

import io
import json
import sys
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

import conftest
from conftest import ROOT
from fbench import spec
from gpufluidsimulator_torch.models import solver
from gpufluidsimulator_torch.models.scenes import dam_break
from gpufluidsimulator_torch.utils import profiling

sys.path.insert(0, str(ROOT / "benchmark"))
import run as bench_run  # noqa: E402

CELL = "ddb3d_5m.rollout_inc"
STAND_IN = "tiny5m.rollout_inc_500"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tiny5m(tmp_path_factory):
    """A tiny copy of the harness whose one cell stands in for ``CELL``,
    with the metric lists of ``CELL`` given to the stand-in."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conftest, "TINY",
                   {STAND_IN: ("ddb3d_5m", 2500, "rollout_inc_500",
                               "pallas_inc")})
        mp.setattr(conftest, "LIMITS_OF", {STAND_IN: CELL})
        h = conftest.make_tiny(tmp_path_factory.mktemp("tiny5m"))
    bench_json = h.parent / "BENCHMARK.json"
    bench = json.loads(bench_json.read_text())
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    lists = {m["name"]: m.get("workloads")
             for m in real["end_to_end"] + real["per_layer"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if lists.get(m["name"]) is not None:
            m["workloads"] = [STAND_IN] if CELL in lists[m["name"]] else []
    bench_json.write_text(json.dumps(bench))
    return h


def _call(steps, counters):
    return {"name": "solver.run", "steps": steps,
            "spans": {"inc.step": {"count": steps, "host_s": 1e-3 * steps,
                                   "self_s": 1e-4 * steps}},
            "counters": counters, "launches": {}}


def test_seam_movers_per_step_on_a_hand_made_record(tiny5m, monkeypatch):
    """Window A's calls (two of 500 steps here) over its ``inc.step``
    count; window B's call is left out; a record without the counter (a
    program that lacks it) reads as nothing."""
    read = spec.metric_reader(tiny5m, "seam_movers_per_step")
    run = SimpleNamespace(trace=SimpleNamespace(steps_a=1000))
    record = [_call(500, {"movers": 9000, "seam_movers": 1200}),
              _call(500, {"movers": 9100, "seam_movers": 1300}),
              _call(500, {"movers": 9200, "seam_movers": 99999})]
    monkeypatch.setattr(profiling, "calls", lambda: record)
    assert read(run) == 2.5
    record[:] = [_call(500, {"movers": 9000, "seam_movers": 0}),
                 _call(500, {"movers": 9000, "seam_movers": 0})]
    assert read(run) == 0.0
    record[:] = [_call(500, {"movers": 9000}), _call(500, {"movers": 9000})]
    assert read(run) is None


@pytest.mark.parametrize("record", ["empty", "naive"])
def test_nothing_to_read(tiny5m, record):
    profiling.take_calls()
    if record == "naive":
        params, state = dam_break(n=150, dim=2, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]):
            solver.run(state, params, 4, method="naive", device="cpu")
        assert profiling.calls()[0]["steps"] == 4
    read = spec.metric_reader(tiny5m, "seam_movers_per_step")
    assert read(SimpleNamespace(trace=SimpleNamespace(steps_a=4))) is None
    assert read(SimpleNamespace(trace=None)) is None
    profiling.take_calls()


@pytest.mark.parametrize("trace", [0, 1])
def test_stand_in_runs_the_mix(tiny5m, trace):
    mix = json.loads((ROOT / "benchmark" / "traffic"
                      / "rollout_inc_500.json").read_text())
    assert mix["kind"] == "rollout" and mix["steps_per_call"] == 500
    assert mix["warm"]["to_step"] == 3175
    profiling.take_calls()
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = bench_run.main(["--workload", STAND_IN, "--seed",
                             str(2 ** 31 + 23), "--seconds", "0.3",
                             "--trace", str(trace)], device="cpu",
                            bench_json=tiny5m.parent / "BENCHMARK.json",
                            harness=tiny5m)
    profiling.take_calls()
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["correct"] is True, line["checks"]
    metrics = line["metrics"]
    if not trace:
        assert {"setup_s", "particle_steps_per_s"} <= set(metrics)
    else:
        # the readers of the program's record (the CPU has no kernels for
        # the device's metrics); one x tile at this size, so the counter
        # is recorded and reads 0
        assert {"movers_per_step", "host_step_us",
                "seam_movers_per_step"} <= set(metrics)
        assert metrics["seam_movers_per_step"]["value"] == 0.0
        assert metrics["movers_per_step"]["value"] > 0
