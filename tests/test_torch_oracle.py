"""The port's float64 oracle, and the port held to it on the CPU.

``gpufluidsimulator_torch/oracle/numpy_ref.py`` is a copy of the
reference's NumPy oracle with the same float64 arithmetic in the same
order: on the same inputs it returns equal arrays, bit for bit.  The port's
paths (``device="cpu"``, the plain versions of its kernels) are then held
to it with the reference's own bars (``tests/test_naive_vs_oracle.py``,
``tests/test_native_oracle.py``):

  * one naive step: rho 1e-5, pos 1e-5, vel 1e-4, relative to the largest
    magnitude (f32 against f64);
  * 200 naive steps of the lattice dam break: pos 1e-4;
  * the native C++ engine against the NumPy oracle over 20 steps, with and
    without cell lists: 1e-12 (the same physics, another summation order);
  * the statistical acceptance (``scripts/torch_accept_cont.py``): each
    observable within max(8 x the oracle's 1-ulp envelope, its floor);
  * under ``slow``: the whole 1000-step statistical acceptance on both
    incremental tiers, and 1000 steps at dt/2 on ``pallas`` and
    ``pallas_inc`` within 1e-3 and ``pallas_inc_cont`` within 1e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.oracle import numpy_ref as jref

import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.models import solver as tsolver
from gpufluidsimulator_torch.oracle import native
from gpufluidsimulator_torch.oracle import numpy_ref as tref
from scripts import torch_accept_cont as acc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the plain versions run many small
    ops, and several test processes share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel_err(a, b):
    scale = np.maximum(np.abs(b).max(), 1e-9)
    return np.abs(a - b).max() / scale


def _f64(t):
    return t.detach().cpu().double().numpy()


# reference scene, kwargs, params changes: jittered 2D and 3D dam breaks,
# the obstacle scene and the Tait EOS
ORACLE_CASES = {
    "dam_break_2d": (jfs.scenes.dam_break,
                     dict(n=300, dim=2, jitter=0.3, seed=2), {}),
    "dam_break_3d": (jfs.scenes.dam_break,
                     dict(n=400, dim=3, jitter=0.3, seed=2), {}),
    "double_dam_obstacles_2d": (jfs.scenes.double_dam_break,
                                dict(n=300, dim=2, jitter=0.2, seed=3), {}),
    "tait_2d": (jfs.scenes.dam_break, dict(n=300, dim=2, jitter=0.3, seed=4),
                dict(eos="tait")),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_numpy_ref_equals_reference_bitwise(case):
    fn, kw, change = ORACLE_CASES[case]
    jp, js = fn(**kw)
    jp = jp.replace(**change)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    pos = np.asarray(js.pos, np.float64)
    rng = np.random.default_rng(7)
    vel = 0.5 * rng.standard_normal(pos.shape)       # viscosity at work

    rho_t, rho_j = tref.density(pos, tp), jref.density(pos, jp)
    assert np.array_equal(rho_t, rho_j)
    pres_t, pres_j = tref.pressure(rho_t, tp), jref.pressure(rho_j, jp)
    assert np.array_equal(pres_t, pres_j)
    assert np.array_equal(tref.accel(pos, vel, rho_t, pres_t, tp),
                          jref.accel(pos, vel, rho_j, pres_j, jp))
    for a, b in zip(tref.step(pos, vel, tp), jref.step(pos, vel, jp)):
        assert np.array_equal(a, b)
    got = tref.run(pos.copy(), vel.copy(), tp, 20)
    want = jref.run(pos.copy(), vel.copy(), jp, 20)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    # the run moved the particles and, in the obstacle scene, met them
    assert np.abs(got[0] - pos).max() > 1e-4


def test_numpy_ref_imports_numpy_only():
    src = open(tref.__file__).read()
    imports = sorted({line.split()[1] for line in src.splitlines()
                      if line.startswith(("import ", "from "))})
    assert imports == ["__future__", "math", "numpy"]


@pytest.mark.parametrize("dim", [2, 3])
def test_single_step_matches_oracle(dim):
    params, state = tfs.scenes.dam_break(n=256 if dim == 2 else 512,
                                         dim=dim, jitter=0.2, seed=1,
                                         device="cpu")
    p0, v0 = _f64(state.pos), _f64(state.vel)
    op, ov, orho, _ = tref.step(p0, v0, params)
    st = tsolver.step(state, params, method="naive", device="cpu")
    assert _rel_err(_f64(st.rho), orho) < 1e-5
    assert _rel_err(_f64(st.pos), op) < 1e-5
    assert _rel_err(_f64(st.vel), ov) < 1e-4


def test_trajectory_matches_oracle_200_steps():
    """The lattice dam break collapses in order: f32 rounding is not
    amplified, so 200 naive steps track the float64 oracle within 1e-4."""
    params, state = tfs.scenes.dam_break(n=400, dim=2, device="cpu")
    p, v, _, _ = tref.run(_f64(state.pos), _f64(state.vel), params, 200)
    st = tfs.run(state, params, 200, method="naive", device="cpu")
    assert _rel_err(_f64(st.pos), p) < 1e-4


@pytest.mark.skipif(not native.available(),
                    reason="native fluidcore not built")
@pytest.mark.parametrize("dim,n", [(2, 500), (3, 900)])
def test_native_matches_numpy_oracle(dim, n):
    params, state = tfs.scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=13,
                                         device="cpu")
    p0, v0 = _f64(state.pos), _f64(state.vel)
    pr, _, rr, _ = tref.run(p0.copy(), v0.copy(), params, 20)
    for use_grid in (False, True):
        pn, _, rn, _ = native.run(p0, v0, params, 20, use_grid=use_grid)
        assert _rel_err(pn, pr) < 1e-12, f"grid={use_grid}"
        assert _rel_err(rn, rr) < 1e-12


@pytest.mark.skipif(not native.available(),
                    reason="native fluidcore not built")
def test_statistical_acceptance_protocol_one_checkpoint():
    """scripts/torch_accept_cont.py's protocol at a small size: one
    50-step checkpoint of pallas_inc, the same tolerance formula."""
    params, state = acc.scene(n=1024, device="cpu")
    result = acc.accept(params, state, ("pallas_inc",), checkpoints=(50,),
                        device="cpu")
    (run,) = result["runs"]
    (row,) = run["rows"]
    assert row["step"] == 50 and row["overflow"] == 0
    assert np.allclose(row["tol"], np.maximum(
        acc.ENVELOPE_FACTOR * np.asarray(row["envelope"]), acc.FLOORS))
    assert abs(row["ke_signed"]) == row["got"][2]
    assert acc.failures(result, com_fall=None) == []
    # the column has started to fall
    assert run["com_fall"] > 0.0


@pytest.mark.slow
@pytest.mark.skipif(not native.available(),
                    reason="native fluidcore not built")
@pytest.mark.parametrize("method", ["pallas_inc", "pallas_inc_cont"])
def test_full_cfl_1000_steps_statistical_acceptance(method):
    """tests/test_naive_vs_oracle.py:44-117 on the port: four checkpoints
    of 250 steps at full CFL, and the centre of mass fallen by more than
    0.02."""
    params, state = acc.scene(device="cpu")
    result = acc.accept(params, state, (method,), device="cpu")
    assert acc.failures(result) == []


@pytest.mark.slow
@pytest.mark.parametrize("method,bound", [("pallas", 1e-3),
                                          ("pallas_inc", 1e-3),
                                          ("pallas_inc_cont", 1e-2)])
def test_trajectory_matches_oracle_1000_steps(method, bound):
    """tests/test_naive_vs_oracle.py:119-166 on the port: 1000 steps at half
    the CFL dt (at full CFL a 1-ulp self-perturbation of the oracle crosses
    1e-3 by step 550, docs/chaos_bound.json), particles re-aligned by id.
    The continuity tier's bar is the reference's 1e-2: its density
    evolution is an O(dt)-different formulation."""
    params, state = tfs.scenes.dam_break(n=4096, dim=2, device="cpu")
    params = params.replace(dt=params.dt * 0.5)
    p, v = _f64(state.pos), _f64(state.vel)
    if native.available():
        p, v, _, _ = native.run(p, v, params, 1000, use_grid=False)
    else:
        p, v, _, _ = tref.run(p, v, params, 1000)
    st = tfs.run(state, params, 1000, method=method, device="cpu")
    order = np.argsort(st.ids.numpy())
    err = _rel_err(_f64(st.pos)[order], p)
    assert err < bound, f"rel_err {err:.2e} at dt/2"
    assert int(st.overflow) == 0
