"""The port's spans and counters (``utils/profiling``): nothing without a
profiler session; under one, one call a ``solver.run``, its step and phase
spans, their host and self times, the movers and the drops by cause, and
the spans as nested ``user_annotation`` events of the profiler's trace.

On the CPU but for the tests marked ``cuda``, which skip without a card.
Imports nothing of JAX, so the card's tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tracing.py -q
"""

import json
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpufluidsimulator_torch as ft
from gpufluidsimulator_torch.models import solver
from gpufluidsimulator_torch.ops import inc, render, sph
from gpufluidsimulator_torch.ops import planes as pm
from gpufluidsimulator_torch.parallel import mesh as meshmod
from gpufluidsimulator_torch.parallel import sharded
from gpufluidsimulator_torch.utils import profiling

STEPS = 5
INC_PHASES = ("inc.bounds", "inc.density", "inc.force", "inc.compact",
              "inc.consolidate")
PALLAS_PHASES = ("pallas.binning", "pallas.density", "pallas.force",
                 "pallas.gather")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes share the host: one torch thread each; and
    every test starts from an empty record."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.take_calls()
    yield
    torch.set_num_threads(before)


def _scene(device="cpu", cell_capacity=3):
    """595 particles of a 2D dam break, thrown about (movers every step),
    at a cell capacity the lattice overfills (cell drops)."""
    params, state = ft.scenes.dam_break(n=600, dim=2, jitter=0.2, seed=1,
                                        device="cpu")
    g = torch.Generator().manual_seed(0)
    state = state._replace(vel=torch.randn(state.vel.shape, generator=g)
                           * 3.0)
    return params.replace(cell_capacity=cell_capacity), state.to(device)


def _traced(fn, device="cpu"):
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    return out, prof


def _annotations(prof, tmp_path):
    """The trace's user annotations: [(start, end, name)] in us."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
            for e in events if e.get("cat") == "user_annotation"]


def _well_nested(spans):
    """Every two intervals are disjoint or one holds the other."""
    for a0, a1, an in spans:
        for b0, b1, bn in spans:
            overlap = a0 < b1 and b0 < a1
            holds = (a0 <= b0 and b1 <= a1) or (b0 <= a0 and a1 <= b1)
            assert not overlap or holds, ((a0, a1, an), (b0, b1, bn))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _movers_by_hand(params, state, m_cap, steps):
    """The movers ``compact`` keeps, stepping ``inc.step_phases`` by hand
    with no profiler, and the state's overflow after the steps."""
    geom = pm.geometry(params)
    s = inc._convert_in(state, params, geom, False)
    seen = []
    compact = inc.compact

    def counting(channels, flags, cap):
        out = compact(channels, flags, cap)
        seen.append(int(out[1]))
        return out

    inc.compact = counting
    try:
        for _ in range(steps):
            s = sph.one_slab(inc.step_phases(s, params, geom, m_cap))
    finally:
        inc.compact = compact
    return sum(seen), int(s.overflow)


def test_span_is_null_without_a_profiler():
    null = profiling.span("inc.step")
    assert null is profiling.span("solver.run")
    with null:
        pass
    params, state = ft.scenes.dam_break(n=150, dim=2, device="cpu")
    solver.run(state, params, 2, method="naive", device="cpu")
    assert profiling.calls() == []


@pytest.mark.parametrize("m_cap", [None, 16])
def test_inc_run_records_one_call(tmp_path, monkeypatch, m_cap):
    """``None``: the mover capacity ``run_inc`` sizes (cell drops only);
    16: a capacity the movers overrun (drops of both causes)."""
    params, state = _scene()
    if m_cap is not None:
        monkeypatch.setattr(inc, "mover_capacity", lambda n: m_cap)
    cap = inc.mover_capacity(state.n)
    out, prof = _traced(lambda: solver.run(state, params, STEPS,
                                           method="pallas_inc",
                                           device="cpu"))
    calls = profiling.calls()
    assert profiling.calls() == calls           # read, not cleared
    assert len(calls) == 1
    c = calls[0]
    assert c["name"] == "solver.run" and c["steps"] == STEPS
    sp = c["spans"]
    for name in ("inc.step",) + INC_PHASES:
        assert sp[name]["count"] == STEPS, name
    for name in ("solver.run", "inc.to_planes", "inc.to_flat"):
        assert sp[name]["count"] == 1, name
    for name, s in sp.items():
        assert 0.0 <= s["self_s"] <= s["host_s"], name
    assert sum(sp[n]["host_s"] for n in INC_PHASES) \
        <= sp["inc.step"]["host_s"]
    assert sum(sp[n]["host_s"] for n in ("inc.to_planes", "inc.step",
                                         "inc.to_flat")) \
        <= sp["solver.run"]["host_s"]
    assert c["launches"] == {}                  # the CPU's plain versions

    movers, overflow = _movers_by_hand(params, state, cap, STEPS)
    cnt = c["counters"]
    assert cnt["movers"] == movers > 0
    assert cnt["drops_cell_capacity"] > 0
    assert (cnt["drops_mover_capacity"] > 0) == (m_cap is not None)
    assert cnt["drops_cell_capacity"] + cnt["drops_mover_capacity"] \
        == int(out.overflow) - int(state.overflow) == overflow

    ann = [a for a in _annotations(prof, tmp_path)
           if re.match(r"(solver|inc)\.", a[2])]
    _well_nested(ann)
    by = {}
    for a in ann:
        by.setdefault(a[2], []).append(a)
    assert {n: len(v) for n, v in by.items()} == {
        n: s["count"] for n, s in sp.items()}
    run = by["solver.run"][0]
    for step in by["inc.step"]:
        assert _inside(step, run)
    for name in INC_PHASES:
        for a in by[name]:
            assert any(_inside(a, step) for step in by["inc.step"]), name

    assert profiling.take_calls() == calls
    assert profiling.calls() == []


def test_counters_add_up_across_folds(monkeypatch):
    """Tallies past FOLD_EVERY are added up on the device, and read the
    same."""
    params, state = _scene()
    monkeypatch.setattr(profiling, "FOLD_EVERY", 2)
    _traced(lambda: solver.run(state, params, STEPS, method="pallas_inc",
                               device="cpu"))
    movers, overflow = _movers_by_hand(params, state,
                                       inc.mover_capacity(state.n), STEPS)
    c = profiling.take_calls()[0]["counters"]
    assert c["movers"] == movers
    assert c["drops_cell_capacity"] + c["drops_mover_capacity"] == overflow


def test_sharded_spans_nest(tmp_path):
    """Two slabs in lock step: no span is open across a ``yield``, so the
    spans of the two slabs' phases nest inside the step's, one after
    another."""
    params, state = _scene(cell_capacity=8)
    mesh = meshmod.make_mesh(devices=["cpu"] * 2)
    sim = sharded.ShardedSim(params, state, mesh=mesh, method="pallas_inc")
    _, prof = _traced(lambda: sim.step(STEPS))
    (c,) = profiling.take_calls()
    assert c["name"] == "sharded.run" and c["steps"] == STEPS
    sp = c["spans"]
    assert sp["inc.step"]["count"] == STEPS
    for name in INC_PHASES:
        assert sp[name]["count"] == 2 * STEPS, name
    # the ghost lanes of the planes and of rho, and the movers
    assert sp["sharded.exchange"]["count"] == 3 * STEPS
    assert sp["inc.to_planes"]["count"] == 1
    assert sp["inc.to_flat"]["count"] == 2
    assert c["counters"]["movers"] > 0
    ann = _annotations(prof, tmp_path)
    _well_nested(ann)
    steps = [a for a in ann if a[2] == "inc.step"]
    assert len(steps) == STEPS
    for a in ann:
        if a[2] in INC_PHASES + ("sharded.exchange",):
            assert any(_inside(a, s) for s in steps), a


def test_pallas_and_render_spans():
    params, state = _scene(cell_capacity=8)
    out, _ = _traced(lambda: solver.run(state, params, 3, method="pallas",
                                        device="cpu"))
    _traced(lambda: render.tonemap(render.render_frame(out, params,
                                                       width=32,
                                                       height=24)))
    run, splat, tone = profiling.take_calls()
    assert run["name"] == "solver.run" and run["steps"] == 3
    for name in ("pallas.step",) + PALLAS_PHASES:
        assert run["spans"][name]["count"] == 3, name
    assert run["counters"] == {"drops_cell_capacity": 0}
    assert splat["name"] == "render.splat" and splat["steps"] == 0
    assert tone["name"] == "render.tonemap"
    assert set(tone["spans"]) == {"render.tonemap"}


def test_format_calls_lines():
    params, state = _scene()
    _traced(lambda: solver.run(state, params, STEPS, method="pallas_inc",
                               device="cpu"))
    lines = profiling.format_calls(profiling.take_calls())
    assert lines[0] == f"call 0: solver.run, {STEPS} steps"
    assert any(re.match(r"  inc\.step +count +5 +host +[\d.]+ ms +self", ln)
               for ln in lines)
    assert any(ln.startswith("  movers a step ") for ln in lines)
    assert any(ln.startswith("  drops: cell capacity ") for ln in lines)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# device kernel name -> the spans whose launches it may be (``to_flat``
# sweeps the density once for the returned state's diagnostics)
KERNEL_SPANS = {"occ_rowmax_kernel": ("inc.bounds", "inc.to_flat"),
                "density_kernel<": ("inc.density", "inc.to_flat"),
                "force_kernel<": ("inc.force",),
                "compact_kernel": ("inc.compact", "inc.to_flat"),
                "consolidate_kernel<": ("inc.consolidate",)}


@pytest.mark.cuda
def test_launches_lie_in_their_phase_spans(cuda, tmp_path):
    params, state = _scene(cuda, cell_capacity=8)
    solver.run(state, params, 2, method="pallas_inc", device=cuda)
    torch.cuda.synchronize()
    profiling.take_calls()
    _, prof = _traced(lambda: solver.run(state, params, STEPS,
                                         method="pallas_inc", device=cuda),
                      cuda)
    (c,) = profiling.take_calls()
    for k in ("force_step", "density", "occ_rowmax", "compact",
              "consolidate"):
        assert c["launches"][k] >= STEPS, c["launches"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    ann = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
           for e in events if e.get("cat") == "user_annotation"]
    seen = dict.fromkeys(KERNEL_SPANS, 0)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for pat, names in KERNEL_SPANS.items():
            if pat in e["name"]:
                t = launch_ts[e["args"]["correlation"]]
                assert any(a[2] in names and a[0] <= t <= a[1]
                           for a in ann), (e["name"], names)
                seen[pat] += 1
    assert all(n >= STEPS for n in seen.values()), seen


@pytest.mark.cuda
def test_recorded_steps_never_wait_for_the_card(cuda, monkeypatch):
    """Spans and tallies (and their fold) add no host synchronisation to
    a step; the record is read after."""
    params, state = _scene(cuda, cell_capacity=8)
    geom = pm.geometry(params)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
    m_cap = inc.mover_capacity(state.n)
    monkeypatch.setattr(profiling, "FOLD_EVERY", 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profiling.span("test.call"):
                for _ in range(STEPS):
                    s = inc.step_planes(s, params, geom, m_cap)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    (c,) = profiling.take_calls()
    assert c["steps"] == STEPS and c["counters"]["movers"] > 0
