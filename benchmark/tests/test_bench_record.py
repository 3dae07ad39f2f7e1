"""The readers of the program's record (``fbench/record.py``):
``movers_per_step`` and ``host_step_us`` read traced window A's calls on
the tiny CPU stand-in of the cell, and read nothing where the record has
no ``inc.step`` span."""

from __future__ import annotations

import io
import json
import sys
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT
from fbench import spec
from gpufluidsimulator_torch.models import solver
from gpufluidsimulator_torch.models.scenes import dam_break
from gpufluidsimulator_torch.utils import profiling

sys.path.insert(0, str(ROOT / "benchmark"))
import run as bench_run  # noqa: E402

METRICS = ("movers_per_step", "host_step_us")


def test_read_in_the_traced_window(tiny):
    profiling.take_calls()
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = bench_run.main(["--workload", "tiny.rollout_inc", "--seed",
                             str(2 ** 31 + 5), "--seconds", "0.3",
                             "--trace", "1"], device="cpu",
                            bench_json=tiny.parent / "BENCHMARK.json",
                            harness=tiny)
    assert rc == 0, err.getvalue()
    metrics = json.loads(out.getvalue().strip().splitlines()[-1])["metrics"]
    calls = profiling.take_calls()
    # window A (one call) and window B (one call), in that order
    assert [c["name"] for c in calls] == ["solver.run", "solver.run"]
    a = calls[0]
    steps = a["spans"]["inc.step"]["count"]
    assert steps == a["steps"] == 20
    assert metrics["movers_per_step"]["value"] == \
        a["counters"]["movers"] / steps
    assert metrics["movers_per_step"]["value"] > 0
    assert metrics["host_step_us"]["value"] == pytest.approx(
        a["spans"]["inc.step"]["host_s"] / steps * 1e6)
    assert metrics["host_step_us"]["unit"] == "us"


@pytest.mark.parametrize("record", ["empty", "naive"])
def test_nothing_to_read(tiny, record):
    profiling.take_calls()
    if record == "naive":
        params, state = dam_break(n=150, dim=2, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]):
            solver.run(state, params, 4, method="naive", device="cpu")
        assert profiling.calls()[0]["steps"] == 4
    run = SimpleNamespace(trace=SimpleNamespace(steps_a=4))
    for name in METRICS:
        assert spec.metric_reader(tiny, name)(run) is None, name
        assert spec.metric_reader(tiny, name)(
            SimpleNamespace(trace=None)) is None, name
    profiling.take_calls()
