"""PyTorch port vs JAX package: the whole full-rebuild step on the CPU.

The port runs with ``device="cpu"``, where every kernel wrapper takes its
plain PyTorch version; the JAX side runs as its own tests run it (Pallas
interpret mode).  The rank-plane path returns particles slot-sorted, and
the two packages sort unstably, so states are compared after re-aligning
by ``ids``.  Tolerances are relative to the largest magnitude:
rho <= 1e-5, pos <= 1e-6, vel <= 1e-4 for one step against the JAX rank-plane
step (summation order and rsqrt differ), pos <= 1e-5 against the JAX
all-pairs step.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.models import solver as jsolver
from gpufluidsimulator_tpu.ops import physics as jphysics
from gpufluidsimulator_tpu.ops import planes as jpm

import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.models import solver as tsolver
from gpufluidsimulator_torch.ops import physics as tphysics

REPO = Path(__file__).resolve().parent.parent


def _port(jp, js):
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    ts = convert.state_from_numpy(*(np.asarray(a) for a in js),
                                  device="cpu")
    return tp, ts


def _aligned(state):
    ids = np.asarray(state.ids)
    o = np.argsort(ids)
    return (np.asarray(state.pos)[o], np.asarray(state.vel)[o],
            np.asarray(state.rho)[o])


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


def test_pallas_step_matches_jax_pallas():
    """tests/test_pallas_vs_naive.py's 2D case, rank-plane step vs
    rank-plane step."""
    jp, js = jfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11)
    tp, ts = _port(jp, js)
    sj = jsolver.step(js, jp, method="pallas")
    st = tsolver.step(ts, tp, method="pallas", device="cpu")
    assert int(st.overflow) == int(sj.overflow) == 0
    pj, vj, rj = _aligned(sj)
    pt, vt, rt = _aligned(st)
    assert _rel(rt, rj) <= 1e-5
    assert _rel(pt, pj) <= 1e-6
    assert _rel(vt, vj) <= 1e-4
    # pressure follows rho through the same EOS
    o_j, o_t = np.argsort(np.asarray(sj.ids)), np.argsort(st.ids.numpy())
    assert _rel(st.pres.numpy()[o_t], np.asarray(sj.pres)[o_j]) <= 1e-4


@pytest.mark.parametrize("scene,steps", [("dam_break", 1),
                                         ("double_dam_break", 20)])
def test_pallas_3d_matches_jax_naive(scene, steps):
    """3D, n=1,200: one step of the dam break, and 20 steps of the double
    dam break (box pillar + sphere obstacles), against the JAX all-pairs
    method."""
    kw = dict(jitter=0.3, seed=11) if scene == "dam_break" else {}
    jp, js = jfs.scenes.SCENES[scene](n=1200, dim=3, **kw)
    tp, ts = _port(jp, js)
    sj = jfs.run(js, jp, steps, method="naive")
    st = tfs.run(ts, tp, steps, method="pallas", device="cpu")
    assert int(st.overflow) == 0
    pj, _, _ = _aligned(sj)
    pt, _, _ = _aligned(st)
    assert _rel(pt, pj) <= 1e-5


@pytest.mark.parametrize("dim,n", [(2, 600), (3, 1200)])
def test_naive_step_matches_jax_naive(dim, n):
    jp, js = jfs.scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=11)
    tp, ts = _port(jp, js)
    sj = jfs.step(js, jp, method="naive")
    st = tfs.step(ts, tp, method="naive", device="cpu")
    # the all-pairs step keeps spawn order
    assert np.array_equal(st.ids.numpy(), np.asarray(sj.ids))
    assert _rel(st.rho.numpy(), np.asarray(sj.rho)) <= 1e-5
    assert _rel(st.pos.numpy(), np.asarray(sj.pos)) <= 1e-6
    assert _rel(st.vel.numpy(), np.asarray(sj.vel)) <= 1e-4


def test_overflow_matches_jax_and_stays_finite():
    """cell_capacity=1 forces rank >= K drops: the count equals the JAX
    binning's, ids stay a permutation, every particle (the dropped ones
    included) integrates to a finite in-bounds position."""
    jp, js = jfs.scenes.dam_break(n=800, dim=2, jitter=0.4, seed=3)
    jp = jp.replace(cell_capacity=1)
    tp, ts = _port(jp, js)
    jt = jpm.build_planes(js.pos, js.vel, js.ids, jp, jpm.geometry(jp))
    st = tsolver.step(ts, tp, method="pallas", device="cpu")
    assert int(st.overflow) == int(jt.overflow) > 0
    assert np.array_equal(np.sort(st.ids.numpy()), np.arange(ts.n))
    pos = st.pos.numpy()
    assert np.isfinite(pos).all()
    assert (pos >= np.asarray(tp.bounds_min) - 1e-6).all()
    assert (pos <= np.asarray(tp.bounds_max) + 1e-6).all()
    # dropped particles feel gravity only and carry rest density
    assert (st.rho.numpy() == tp.rest_density).sum() >= int(st.overflow)


def test_ids_permutation_after_30_steps():
    jp, js = jfs.scenes.dam_break(n=500, dim=2)
    tp, ts = _port(jp, js)
    st = tfs.run(ts, tp, 30, method="pallas", device="cpu")
    assert np.array_equal(np.sort(st.ids.numpy()), np.arange(ts.n))
    assert int(st.overflow) == 0
    assert torch.isfinite(st.pos).all()


def test_fluidsim_get_positions_unsorts():
    """FluidSim(pallas) keeps rows slot-sorted; get_positions/velocities
    return spawn order, which the all-pairs method never leaves."""
    tp, ts = tfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11,
                                  device="cpu")
    sim = tfs.FluidSim(tp, ts, method="pallas", device="cpu")
    ref = tfs.FluidSim(tp, ts, method="naive", device="cpu")
    sim.step(1)
    ref.step(1)
    assert not np.array_equal(sim.state.ids.numpy(), np.arange(ts.n))
    assert _rel(sim.get_positions(), ref.get_positions()) <= 1e-6
    assert _rel(sim.get_velocities(), ref.get_velocities()) <= 1e-4


def test_rollout_matches_jax_naive():
    jp, js = jfs.scenes.dam_break(n=300, dim=2)
    tp, ts = _port(jp, js)
    fj, tj = jfs.rollout(js, jp, 4, method="naive", record_every=2)
    ft, tt = tfs.rollout(ts, tp, 4, method="naive", record_every=2,
                         device="cpu")
    assert tuple(tt.shape) == tuple(tj.shape) == (2, ts.n, 2)
    assert _rel(tt.numpy(), np.asarray(tj)) <= 1e-6
    assert _rel(ft.pos.numpy(), np.asarray(fj.pos)) <= 1e-6


def test_physics_matches_jax():
    """EOS (linear, Tait), collide with a box and a sphere (first-axis
    argmax on box ties), and its axis-split form."""
    jp, _ = jfs.scenes.double_dam_break(n=600, dim=3)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    rng = np.random.default_rng(7)
    pos = rng.uniform(-0.05, 1.05, (4000, 3)).astype(np.float32)
    pos[:8] = np.float32(0.5)                  # box centre: q ties on all axes
    vel = rng.standard_normal((4000, 3)).astype(np.float32)
    pj, vj = jphysics.collide(jnp.asarray(pos), jnp.asarray(vel), jp)
    pt, vt = tphysics.collide(torch.from_numpy(pos), torch.from_numpy(vel),
                              tp)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-5)
    ps, vs = tphysics.collide_axes(list(torch.from_numpy(pos).T),
                                   list(torch.from_numpy(vel).T), tp)
    assert torch.equal(torch.stack(ps, 1), pt)
    assert torch.equal(torch.stack(vs, 1), vt)
    rho = rng.uniform(900.0, 1100.0, 1000).astype(np.float32)
    for eos in ("linear", "tait"):
        jq, tq = jp.replace(eos=eos), tp.replace(eos=eos)
        np.testing.assert_allclose(
            tphysics.eos_pressure(torch.from_numpy(rho), tq).numpy(),
            np.asarray(jphysics.eos_pressure(jnp.asarray(rho), jq)),
            rtol=1e-5, atol=1e-3)


def test_methods_and_auto_resolution():
    # native steps on the host: facade-only, as in the reference
    with pytest.raises(ValueError, match="native"):
        tsolver.resolve_method("native", 100)
    with pytest.raises(ValueError):
        jsolver.resolve_method("native", 100)
    assert tsolver.resolve_method("gridded", 100) == "gridded"
    assert tsolver.resolve_method("pallas_inc", 100) == "pallas_inc"
    assert tsolver.resolve_method("pallas_inc_cont", 100) \
        == "pallas_inc_cont"
    assert tsolver._run_method("pallas_inc_cont", 16, 40000) \
        == "pallas_inc_cont"
    with pytest.raises(ValueError):
        tsolver.resolve_method("nope", 100)
    assert tsolver.resolve_method("auto", 8192) == "naive"
    assert tsolver.resolve_method("auto", 8193) == "pallas"
    assert jsolver.resolve_method("auto", 8192) == "naive"
    assert jsolver.resolve_method("auto", 8193) == "pallas"
    tp, ts = tfs.scenes.dam_break(n=40000, dim=2, device="cpu")
    native = tfs.FluidSim(tp, ts, method="native", device="cpu")
    assert native.method == "native"
    # the reference's run() upgrades long 'auto' rollouts at scale to the
    # incremental pipeline, which the port now has
    sim = tfs.FluidSim(tp, ts, method="auto", device="cpu")
    assert sim.method == "pallas"
    assert tsolver._run_method("auto", 16, ts.n) == "pallas_inc"
    assert tsolver._run_method("auto", 15, ts.n) == "pallas"
    assert tsolver._run_method("pallas", 16, ts.n) == "pallas"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfs.scenes.dam_break(n=300, dim=2)
    tp, ts = tfs.scenes.dam_break(n=300, dim=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfs.FluidSim(tp, ts, method="naive")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfs.step(ts, tp, method="naive")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfs.run(ts, tp, 1, method="pallas", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfs.make_state(np.zeros((4, 2), np.float32))


# imported besides every module of the package: the port's float64 oracle
# and its acceptance scripts
PORT_ALSO = ("gpufluidsimulator_torch.oracle.numpy_ref",
             "scripts.torch_accept_cont", "scripts.torch_sweep_cont_accept",
             "scripts.torch_soak", "scripts.torch_invariants")


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import gpufluidsimulator_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for name in {PORT_ALSO!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'gpufluidsimulator_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
