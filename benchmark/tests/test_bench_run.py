"""Whole runs of the harness on the CPU at a tiny size (the look for a
card skipped): the last line carries the contract's keys; a sound run is
correct under the cells' limits; the control and each fault the cells
can have, planted under the timed path, make ``correct`` false."""

from __future__ import annotations

import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from conftest import ROOT
from gpufluidsimulator_torch.models import solver
from gpufluidsimulator_torch.models.state import State
from gpufluidsimulator_torch.ops import render

sys.path.insert(0, str(ROOT / "benchmark"))
import run as bench_run  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_cell(tiny, workload, trace=0, seed=2 ** 31 + 11):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = bench_run.main(["--workload", workload, "--seed", str(seed),
                             "--seconds", "0.3", "--trace", str(trace)],
                            device="cpu",
                            bench_json=tiny.parent / "BENCHMARK.json",
                            harness=tiny)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return line, err.getvalue().strip().splitlines()


@pytest.mark.parametrize("workload,trace", [
    ("tiny.rollout_inc", 0), ("tiny.rollout_inc", 1), ("tiny.frames", 0),
    ("tiny.frames", 1)])
def test_last_line_has_the_contract_keys(tiny, workload, trace):
    line, err = run_cell(tiny, workload, trace)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["correct"] is True, line["checks"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
        assert len(line["metrics"]) >= 2
    # the numbers compared, each beside its limit, end standard error
    names = list(line["checks"])
    assert [e.split(":")[0] for e in err[-len(names):]] == \
        [f"check {n}" for n in names]


def _unchanged(state, params, n_steps, method="auto", device=None):
    return state.to(device)


def _half(state, params, n_steps, method="auto", device=None):
    out = RUN(state, params, n_steps, method, device)
    by_in = torch.argsort(state.ids.long())
    by_out = torch.argsort(out.ids.long())
    keep = torch.arange(state.n) % 2 == 0       # ids left out of the step
    pos, vel = out.pos.clone(), out.vel.clone()
    pos[by_out[keep]] = state.pos[by_in[keep]]
    vel[by_out[keep]] = state.vel[by_in[keep]]
    return out._replace(pos=pos, vel=vel)


def _altered(state, params, n_steps, method="auto", device=None):
    out = RUN(state, params, n_steps, method, device)
    m = max(1, out.n // 200)       # a run of 0.5% of the rows, misplaced
    pos = out.pos.clone()
    pos[:m], pos[out.n // 2:out.n // 2 + m] = \
        out.pos[out.n // 2:out.n // 2 + m], out.pos[:m]
    return out._replace(pos=pos)


RUN = solver.run
FRAME = render.render_frame


def _bright_pixel(state, params, **kw):
    fb = FRAME(state, params, **kw).clone()
    fb[3, 3] += fb.max()
    return fb


@pytest.mark.parametrize("workload", ["tiny.rollout_inc", "tiny.frames"])
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_faults_make_correct_false(tiny, monkeypatch, workload, fault):
    from fbench import bench
    setup = bench.Cell.setup

    def setup_then_break(self):      # the timed path breaks, not set-up
        setup(self)
        monkeypatch.setattr(solver, "run", fault)

    monkeypatch.setattr(bench.Cell, "setup", setup_then_break)
    line, _ = run_cell(tiny, workload)
    assert line["correct"] is False


TONEMAP = render.tonemap


def _dark_pixel(fb, *args, **kw):
    img = TONEMAP(fb, *args, **kw).copy()
    img[2, 2] ^= 64
    return img


@pytest.mark.parametrize("name,target,fault", [
    ("fb_rel", "render_frame", _bright_pixel),
    ("img_levels", "tonemap", _dark_pixel)])
def test_altered_frame_makes_correct_false(tiny, monkeypatch, name, target,
                                           fault):
    """A frame's framebuffer or image altered where it is produced."""
    monkeypatch.setattr(render, target, fault)
    line, _ = run_cell(tiny, "tiny.frames")
    assert line["correct"] is False
    assert line["checks"][name]["value"] > line["checks"][name]["limit"]


@pytest.mark.parametrize("workload", ["tiny.rollout_inc", "tiny.frames"])
def test_control_fails(tiny, workload):
    """The reference in bfloat16 put in the program's place fails the
    cell's limits."""
    from fbench import bench, check, spec
    cell = spec.load_cell(tiny.parent / "BENCHMARK.json", workload, tiny)
    c = bench.Cell(cell, 5, "cpu")
    c.setup()
    start = c.evolved
    ref = c.reference(start)
    ctl = c.reference(start, torch.bfloat16)
    nums = c.gaps(ctl, ref)
    render_ref = getattr(c.loop, "render_ref", None)
    if render_ref is not None:
        rfb, _ = render_ref(c, start, torch.zeros(1))
        cfb, _ = render_ref(c, start, torch.zeros(1), torch.bfloat16)
        nums["fb_rel"] = float((cfb.double() - rfb).abs().max()
                               / rfb.abs().max())
    ok, _ = check.verdict({k: v for k, v in nums.items()},
                          {k: v for k, v in cell.limits.items()
                           if k in nums})
    assert not ok, nums


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing on
    standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "ddb3d_1m.rollout_inc", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_state_type_is_the_programs():
    assert State._fields[:3] == ("pos", "vel", "rho")
