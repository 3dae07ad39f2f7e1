"""PyTorch port vs JAX package: the tools on the CPU - the renderer,
checkpoints, metrics, profiling and the debug harness.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart.  Tolerances, and why:
  * splat framebuffers: within 1e-6 of their maximum - the port sums each
    pixel exactly in fixed point, the reference in float32 in scatter
    order;
  * tonemap and PNG bytes from equal images: equal (the same numpy code);
  * checkpoints move values without arithmetic: equal, across packages;
  * invariants: 1e-12 relative (the same float64 numpy code on the same
    float32 values);
  * resumed runs on the CPU: bitwise equal to the uninterrupted ones.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.ops import inc as jinc
from gpufluidsimulator_tpu.ops import render as jrender
from gpufluidsimulator_tpu.utils import checkpoint as jckpt
from gpufluidsimulator_tpu.utils import metrics as jmetrics

import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.ops import inc as tinc
from gpufluidsimulator_torch.ops import planes as tpm
from gpufluidsimulator_torch.ops import render as trender
from gpufluidsimulator_torch.utils import checkpoint as tckpt
from gpufluidsimulator_torch.utils import debug as tdebug
from gpufluidsimulator_torch.utils import metrics as tmetrics
from gpufluidsimulator_torch.utils import profiling as tprof


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share the host: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(jp, js):
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    ts = convert.state_from_numpy(*(np.asarray(a) for a in js),
                                  device="cpu")
    return tp, ts


def _random_state(dim, n=400, seed=0):
    """numpy (pos, vel, rho, pres, ids, overflow): positions over the unit
    box and a little past it, one particle far out of frame."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.02, 1.02, (n, dim)).astype(np.float32)
    pos[0] = 50.0
    vel = rng.normal(0.0, 0.7, (n, dim)).astype(np.float32)
    rho = rng.uniform(900.0, 1100.0, n).astype(np.float32)
    pres = np.zeros(n, np.float32)
    ids = np.arange(n, dtype=np.int32)
    return pos, vel, rho, pres, ids, np.int32(0)


def _params(dim):
    return jfs.SimParams(dim=dim, h=0.05, gravity=(0.0, -9.81, 0.0)[:dim],
                         bounds_min=(0.0,) * dim, bounds_max=(1.0,) * dim)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("color_by", ["speed", "density", "none"])
def test_render_frame_matches_reference(dim, color_by):
    arrays = _random_state(dim, seed=dim)
    jp = _params(dim)
    js = jfs.State(*(jnp.asarray(a) for a in arrays))
    tp, ts = _port(jp, js)
    want = np.asarray(jrender.render_frame(js, jp, width=96, height=80,
                                           color_by=color_by))
    got = trender.render_frame(ts, tp, width=96, height=80,
                               color_by=color_by)
    assert got.dtype == torch.float32 and got.shape == (80, 96)
    got = got.numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the out-of-frame particle adds nothing: the sums match without it
    js1 = jfs.State(*(jnp.asarray(a[1:] if np.ndim(a) else a)
                      for a in arrays))
    want1 = np.asarray(jrender.render_frame(js1, jp, width=96, height=80,
                                            color_by=color_by))
    assert np.abs(got - want1).max() <= 1e-6 * np.abs(want1).max()
    # equal images tonemap and encode to equal bytes
    assert np.array_equal(trender.tonemap(want), jrender.tonemap(want))
    assert np.array_equal(trender.tonemap(torch.tensor(want)),
                          jrender.tonemap(want))


def test_png_and_splat_basics(tmp_path):
    img = (np.arange(32 * 32 * 3) % 255).astype(np.uint8).reshape(32, 32, 3)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    trender.write_png(a, img)
    jrender.write_png(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    tp = tfs.SimParams(dim=2, gravity=(0.0, -9.81), bounds_min=(0.0, 0.0),
                       bounds_max=(1.0, 1.0), h=0.05)
    fb = trender.splat(torch.tensor([[0.5, 0.5], [0.25, 0.75]]), tp,
                       width=64, height=64)
    assert abs(float(fb.sum()) - 2.0) < 1e-5     # bilinear weights sum to 1
    fb = trender.splat(torch.tensor([[50.0, 50.0]]), tp, width=32,
                       height=32)
    assert float(fb.sum()) == 0.0
    for dim in (2, 3):
        np.testing.assert_array_equal(trender._camera_matrix(dim, 30, 20),
                                      jrender._camera_matrix(dim, 30, 20))


def test_golden_frame_deterministic(tmp_path):
    """The same state renders to the same PNG bytes."""
    tp, ts = tfs.scenes.dam_break(n=500, dim=2, jitter=0.2, seed=1,
                                  device="cpu")
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    trender.save_frame(a, ts, tp, width=128, height=128)
    trender.save_frame(b, ts, tp, width=128, height=128)
    assert open(a, "rb").read() == open(b, "rb").read()


def _assert_states_equal(a, b):
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_across_packages(tmp_path):
    jp, js = jfs.scenes.double_dam_break(n=800, dim=2, jitter=0.1, seed=4)
    tp, ts = _port(jp, js)
    ts = ts._replace(overflow=torch.tensor(3, dtype=torch.int32))
    port_file = str(tmp_path / "port.npz")
    tckpt.save(port_file, ts, tp, step=42)
    js2, jp2, step = jckpt.load(port_file)
    assert step == 42 and jp2 == jp
    for x, y in zip(ts, js2):
        assert np.asarray(y).dtype == x.numpy().dtype
        assert np.array_equal(x.numpy(), np.asarray(y))
    ref_file = str(tmp_path / "ref.npz")
    jckpt.save(ref_file, js, jp, step=7)
    ts2, tp2, step = tckpt.load(ref_file, device="cpu")
    assert step == 7 and tp2 == tp and tp2.obstacles == tp.obstacles
    for x, y in zip(ts2, js):
        assert x.dtype == torch.from_numpy(np.array(y)).dtype
        assert np.array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("continuity", [False, True])
def test_planes_checkpoint_across_packages(tmp_path, continuity):
    tp, ts = tfs.scenes.dam_break(n=500, dim=2, jitter=0.2, seed=1,
                                  device="cpu")
    geom = tpm.geometry(tp)
    s = tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom,
                       continuity=continuity)
    if continuity:
        rng = np.random.default_rng(5)
        s = s._replace(rhop=torch.from_numpy(rng.uniform(
            900, 1100, tuple(s.rhop.shape)).astype(np.float32)), age=37)
    port_file = str(tmp_path / "port_planes.npz")
    tckpt.save_planes(port_file, s, tp, step=9, n=ts.n)
    j, jp, step, n = jckpt.load_planes(port_file)
    assert (step, n) == (9, ts.n)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    assert int(j.mig_overflow) == 0
    for name in ("fields6", "idp", "overflow") + (
            ("rhop",) if continuity else ()):
        assert np.array_equal(getattr(s, name).numpy(),
                              np.asarray(getattr(j, name)))
    assert (j.age is None) if not continuity else int(j.age) == 37

    rng = np.random.default_rng(6)
    shape = (2, 1, 1, 8, 128)
    jstate = jinc.IncState(
        fields6=jnp.asarray(rng.normal(size=(6,) + shape), jnp.float32),
        idp=jnp.asarray(rng.integers(-1, 500, shape), jnp.float32),
        overflow=jnp.int32(2), mig_overflow=jnp.int32(0),
        rhop=(jnp.asarray(rng.uniform(900, 1100, shape), jnp.float32)
              if continuity else None),
        age=jnp.int32(65) if continuity else None)
    jp = _params(2)
    ref_file = str(tmp_path / "ref_planes.npz")
    jckpt.save_planes(ref_file, jstate, jp, step=11, n=400)
    t, tp2, step, n = tckpt.load_planes(ref_file, device="cpu")
    assert (step, n) == (11, 400)
    assert dataclasses.asdict(tp2) == dataclasses.asdict(jp)
    for name in ("fields6", "idp", "overflow") + (
            ("rhop",) if continuity else ()):
        assert np.array_equal(getattr(t, name).numpy(),
                              np.asarray(getattr(jstate, name)))
    if continuity:
        assert type(t.age) is int and t.age == 65
    else:
        assert t.rhop is None and t.age is None


def test_load_planes_refuses_mig_overflow(tmp_path):
    """A nonzero mig_overflow, which a sharded slab's IncState carries,
    survives save_planes / load_planes (it was refused before IncState had
    the field), and the reference reads it back alike."""
    tp, ts = tfs.scenes.dam_break(n=300, dim=2, device="cpu")
    geom = tpm.geometry(tp)
    s = tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom)
    s = s._replace(mig_overflow=torch.tensor(3, dtype=torch.int32))
    path = str(tmp_path / "p.npz")
    tckpt.save_planes(path, s, tp, step=1, n=ts.n)
    t, _, step, n = tckpt.load_planes(path, device="cpu")
    assert (step, n) == (1, ts.n)
    assert t.mig_overflow.dtype == torch.int32 and int(t.mig_overflow) == 3
    assert torch.equal(t.overflow, s.overflow)
    j, _, _, _ = jckpt.load_planes(path)
    assert int(j.mig_overflow) == 3


def test_resume_bitwise_naive(tmp_path):
    tp, ts = tfs.scenes.dam_break(n=400, dim=2, jitter=0.2, seed=3,
                                  device="cpu")
    full = tfs.run(ts, tp, 60, method="naive", device="cpu")
    half = tfs.run(ts, tp, 30, method="naive", device="cpu")
    path = str(tmp_path / "mid.npz")
    tckpt.save(path, half, tp, step=30)
    loaded, tp2, step = tckpt.load(path, device="cpu")
    assert step == 30 and tp2 == tp
    resumed = tfs.run(loaded, tp2, 30, method="naive", device="cpu")
    _assert_states_equal(full, resumed)


def test_resume_bitwise_pallas_inc(tmp_path, monkeypatch):
    """A flat checkpoint resumes a pallas_inc run bitwise; a planes
    checkpoint in the middle of a step_planes loop resumes it bitwise on
    both tiers (the continuity tier across a re-sum step)."""
    tp, ts = tfs.scenes.dam_break(n=600, dim=2, jitter=0.2, seed=2,
                                  device="cpu")
    sim = tfs.FluidSim(tp, ts, method="pallas_inc", device="cpu")
    sim.step(4)
    path = str(tmp_path / "flat.npz")
    tckpt.save(path, sim.state, tp, step=4)
    loaded, tp2, _ = tckpt.load(path, device="cpu")
    a = tfs.FluidSim(tp, sim.state, method="pallas_inc", device="cpu")
    b = tfs.FluidSim(tp2, loaded, method="pallas_inc", device="cpu")
    a.step(4)
    b.step(4)
    _assert_states_equal(a.state, b.state)

    monkeypatch.setattr(tinc, "RESUM_EVERY", 4)
    geom = tpm.geometry(tp)
    m_cap = tinc.mover_capacity(ts.n)
    for continuity in (False, True):
        s = tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom,
                           continuity=continuity)
        for _ in range(3):
            s = tinc.step_planes(s, tp, geom, m_cap)
        path = str(tmp_path / f"planes{continuity}.npz")
        tckpt.save_planes(path, s, tp, step=3, n=ts.n)
        r, tp3, step, n = tckpt.load_planes(path, device="cpu")
        assert (step, n) == (3, ts.n)
        for _ in range(3):                     # ages 3..5: re-sum at 4
            s = tinc.step_planes(s, tp, geom, m_cap)
            r = tinc.step_planes(r, tp3, geom, m_cap)
        assert s.age == r.age
        for x, y in zip(s, r):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y)


def test_rotate_and_latest(tmp_path):
    tp, ts = tfs.scenes.dam_break(n=100, dim=2, device="cpu")
    d = str(tmp_path / "ckpts")
    assert tckpt.latest(d) is None
    for step in range(5):
        tckpt.rotate(d, ts, tp, step, keep=3)
    names = sorted(os.listdir(d))
    assert names == [f"ckpt_00000000{i}.npz" for i in (2, 3, 4)]
    assert tckpt.latest(d).endswith("ckpt_000000004.npz")


def test_invariants_match_reference():
    jp, js = jfs.scenes.double_dam_break(n=800, dim=2, jitter=0.3, seed=8)
    js = jfs.run(js, jp, 5, method="naive")
    tp, ts = _port(jp, js)
    want = jmetrics.invariants(js, jp)
    got = tmetrics.invariants(ts, tp)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, (bool, int)):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0,
                                       err_msg=k)


def test_run_metrics_dumps(tmp_path):
    tp, ts = tfs.scenes.dam_break(n=200, dim=2, device="cpu")
    m = tmetrics.RunMetrics(tp, ts.n, "naive")
    for step in (10, 20):
        m.record(step, ts, tp)
    s = m.summary()
    assert s["steps"] == 20 and s["n_particles"] == ts.n
    assert len(s["samples"]) == 2
    m.dump_json(str(tmp_path / "m.json"))
    m.dump_csv(str(tmp_path / "m.csv"))
    lines = open(tmp_path / "m.csv").read().splitlines()
    assert len(lines) == 3 and "momentum" not in lines[0]


def test_profiling(tmp_path):
    tp, ts = tfs.scenes.dam_break(n=150, dim=2, device="cpu")
    from gpufluidsimulator_torch.models import solver
    t = tprof.slope_time(lambda s: solver.METHODS["naive"](s, tp), ts,
                         k1=1, k2=3, reps=1)
    assert t > 0
    d = str(tmp_path / "trace")
    with tprof.trace(d):
        solver.METHODS["naive"](ts, tp)
    found = [f for _, _, files in os.walk(d) for f in files
             if f.endswith(".json.gz")]
    assert found


def test_cli_prints_the_record(tmp_path, capsys):
    """``run --profile-dir`` prints the program's record after the trace:
    per call each span's count, host ms and self ms, the movers a step,
    the drops by cause (and, on the card, the launches by kernel)."""
    from gpufluidsimulator_torch.utils.cli import main
    rc = main(["run", "-n", "300", "--dim", "2", "--steps", "8",
               "--report-every", "4", "--method", "pallas_inc",
               "--profile-dir", str(tmp_path / "trace"), "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    at = next(i for i, ln in enumerate(out)
              if ln.startswith("profiler trace -> "))
    record = out[at + 1:]
    heads = [ln for ln in record if ln.startswith("call ")]
    assert heads == ["call 0: solver.run, 4 steps",
                     "call 1: solver.run, 4 steps"]
    for name in ("solver.run", "inc.to_planes", "inc.step", "inc.bounds",
                 "inc.density", "inc.force", "inc.compact",
                 "inc.consolidate", "inc.to_flat"):
        rows = [ln.split() for ln in record if ln.split()[:1] == [name]]
        assert len(rows) == 2, name
        for r in rows:
            assert r[1] == "count" and r[3] == "host" and r[5] == "ms"
            assert 0.0 <= float(r[7]) <= float(r[4])     # self <= host
    assert sum(ln.startswith("  movers a step ") for ln in record) == 2
    assert sum(ln.startswith("  drops: cell capacity 0, mover capacity 0")
               for ln in record) == 2
    assert tprof.calls() == []          # printed and cleared


def test_checked_step():
    tp, ts = tfs.scenes.dam_break(n=400, dim=2, device="cpu")
    out = tdebug.checked_step(tp, method="pallas")(ts)
    assert torch.isfinite(out.pos).all()
    with pytest.raises(RuntimeError, match="overflow"):
        tdebug.checked_step(tp.replace(cell_capacity=1), "pallas")(ts)
    bad = ts.pos.clone()
    bad[7, 0] = float("nan")
    with pytest.raises(RuntimeError, match="non-finite"):
        tdebug.checked_step(tp, method="naive")(ts._replace(pos=bad))


def test_determinism_harness():
    tp, ts = tfs.scenes.dam_break(n=300, dim=2, jitter=0.2, seed=2,
                                  device="cpu")
    tdebug.assert_deterministic(tp, ts, n_steps=5, method="pallas",
                                device="cpu")
    tdebug.assert_deterministic(tp, ts, n_steps=5, method="naive",
                                device="cpu")
