"""The ``ddb3d_5m_cont`` cell's own pieces on the CPU: ``cell_fill_max``
and ``force_step_cont_roofline`` read hand-made records and read nothing
where there is nothing to read; the continuity kernels' name patterns;
a tiny stand-in of the cell (the ``ddb3d_5m_cont`` scene, K = 16, at
2,500 particles on ``rollout_cont_500``) loads the mix's keys and runs
its loop, traced and untraced."""

from __future__ import annotations

import io
import json
import sys
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

import conftest
from conftest import HARNESS, ROOT
from fbench import roofline, spec, trace
from gpufluidsimulator_torch.models import solver
from gpufluidsimulator_torch.models.scenes import dam_break
from gpufluidsimulator_torch.utils import profiling

sys.path.insert(0, str(ROOT / "benchmark"))
import run as bench_run  # noqa: E402

CELL = "ddb3d_5m_cont.rollout_cont"
STAND_IN = "tinycont.rollout_cont_500"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tinycont(tmp_path_factory):
    """A tiny copy of the harness whose one cell stands in for ``CELL``,
    warmed on the continuity tier, with the metric lists of ``CELL`` given
    to the stand-in."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conftest, "TINY",
                   {STAND_IN: ("ddb3d_5m_cont", 2500, "rollout_cont_500",
                               "pallas_inc_cont")})
        mp.setattr(conftest, "LIMITS_OF", {STAND_IN: CELL})
        h = conftest.make_tiny(tmp_path_factory.mktemp("tinycont"))
    mix = h / "traffic" / "tiny_rollout_cont_500.json"
    t = json.loads(mix.read_text())
    t["warm"]["method"] = "pallas_inc_cont"
    mix.write_text(json.dumps(t))
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


def test_cell_fill_max_on_a_hand_made_record(monkeypatch):
    """The largest of window A's calls' counters (two of 500 steps here);
    window B's call is left out; a record without the counter (a program
    that lacks it) reads as nothing."""
    read = spec.metric_reader(HARNESS, "cell_fill_max")
    run = SimpleNamespace(trace=SimpleNamespace(steps_a=1000))
    record = [_call(500, {"movers": 9000, "cell_fill_max": 11}),
              _call(500, {"movers": 9100, "cell_fill_max": 12}),
              _call(500, {"movers": 9200, "cell_fill_max": 16})]
    monkeypatch.setattr(profiling, "calls", lambda: record)
    assert read(run) == 12.0
    record[:] = [_call(500, {"movers": 9000}), _call(500, {"movers": 9000})]
    assert read(run) is None


@pytest.mark.parametrize("record", ["empty", "naive"])
def test_cell_fill_max_nothing_to_read(record):
    profiling.take_calls()
    if record == "naive":
        params, state = dam_break(n=150, dim=2, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]):
            solver.run(state, params, 4, method="naive", device="cpu")
        assert profiling.calls()[0]["steps"] == 4
    read = spec.metric_reader(HARNESS, "cell_fill_max")
    assert read(SimpleNamespace(trace=SimpleNamespace(steps_a=4))) is None
    assert read(SimpleNamespace(trace=None)) is None
    profiling.take_calls()


def _op(name, dur_us):
    kernel = "force_step_cont" if "true, 1>" in name else (
        "force_step" if "true, 0>" in name else None)
    return trace.DeviceOp(name=name, ts=0.0, dur=dur_us, kernel=kernel,
                          layer="kernels")


def test_force_step_cont_roofline_on_a_hand_made_trace():
    """The least time of a launch's bytes and operations (57 B a particle,
    49 operations a pair) over the mean of the continuity kernel's
    launches; the summation tier's kernel is not counted; without a
    launch it reads nothing."""
    read = spec.metric_reader(HARNESS, "force_step_cont_roofline")
    n, pairs = 4_825_800, 8.5 * 4_825_800
    ops = [_op("void force_kernel<16, 3, true, 1>(float const*)", 2000.0),
           _op("void force_kernel<16, 3, true, 1>(float const*)", 2200.0),
           _op("void force_kernel<8, 3, true, 0>(float const*)", 10.0)]
    run = SimpleNamespace(
        n=n, dim=3, harness=HARNESS,
        trace=SimpleNamespace(a=trace.Reading(1.0, 0.5, ops, {}),
                              pairs=pairs))
    want = 100.0 * max(n * 57 / roofline.HBM_BYTES_PER_S,
                       49.0 * pairs / roofline.F32_FLOPS_PER_S) / 2100e-6
    assert read(run) == pytest.approx(want)
    run.trace.a = trace.Reading(1.0, 0.5, ops[2:], {})
    assert read(run) is None
    assert read(SimpleNamespace(trace=None)) is None


def test_force_step_cont_counts_its_fields():
    count = spec.roofline_count(HARNESS, "force_step_cont")
    nbytes, flops = count(1000, 9000.0, 3)
    # float32 positions, velocities and carried density read and written,
    # the flag a byte
    assert nbytes == 1000 * ((3 + 3 + 1) * 4 * 2 + 1)
    assert flops == (32 + 17) * 9000.0


@pytest.mark.parametrize("name,kernel", [
    ("void force_kernel<16, 3, true, 1>(float const*, float const*)",
     "force_step_cont"),
    ("void force_kernel<8, 3, true, 1>(float const*)", "force_step_cont"),
    ("void force_kernel<16, 3, true, 0>(float const*)", "force_step"),
    ("void force_kernel<16, 3, false, 0>(float const*)", None),
    ("void consolidate_kernel<true>(float const*, int*)", "consolidate_rho"),
    ("void consolidate_kernel<false>(float const*, int*)", "consolidate")])
def test_kernel_patterns(name, kernel):
    """Each launch is named by one kernel file: the continuity kernels by
    their own, the summation tier's by theirs."""
    tables = spec.tables(HARNESS)
    hits = [k["name"] for k in tables["kernels"] if k["regex"].search(name)]
    assert hits == ([kernel] if kernel else [])


@pytest.mark.parametrize("trace_on", [0, 1])
def test_stand_in_runs_the_mix(tinycont, trace_on):
    mix = json.loads((ROOT / "benchmark" / "traffic"
                      / "rollout_cont_500.json").read_text())
    assert mix["kind"] == "rollout" and mix["steps_per_call"] == 500
    assert mix["method"] == mix["warm"]["method"] == "pallas_inc_cont"
    assert mix["warm"]["to_step"] == 3175
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "ddb3d_5m_cont.json").read_text())
    assert cfg["physics"]["cell_capacity"] == 16
    profiling.take_calls()
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = bench_run.main(["--workload", STAND_IN, "--seed",
                             str(2 ** 31 + 41), "--seconds", "0.3",
                             "--trace", str(trace_on)], device="cpu",
                            bench_json=tinycont.parent / "BENCHMARK.json",
                            harness=tinycont)
    calls = profiling.take_calls()
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["correct"] is True, line["checks"]
    metrics = line["metrics"]
    if not trace_on:
        assert {"setup_s", "particle_steps_per_s"} <= set(metrics)
    else:
        # the readers of the program's record (the CPU has no kernels for
        # the device's metrics)
        assert {"movers_per_step", "host_step_us", "seam_movers_per_step",
                "cell_fill_max"} <= set(metrics)
        fill = metrics["cell_fill_max"]["value"]
        assert fill == calls[0]["counters"]["cell_fill_max"]
        assert 0 < fill <= 16
