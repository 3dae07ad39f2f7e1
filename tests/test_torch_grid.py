"""PyTorch port vs JAX package: the uniform-grid cell table (``ops/grid.py``)
and the gridded method (``ops/gridded.py``, ``method="gridded"``), on the
CPU with identical inputs.

Binning is exact: cell ids, strides, stencil offsets and the whole cell
table (positions, velocities, validity, slots, overflow) equal the
reference's bit for bit, since both sort stably.  Density and acceleration
agree within 1e-5 relative to the largest magnitude (float32 sums in
another order); one step within pos 1e-6 and vel 1e-5; 50 steps of the 2D
obstacle scene within pos 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.models import solver as jsolver
from gpufluidsimulator_tpu.ops import grid as jgrid
from gpufluidsimulator_tpu.ops import gridded as jgridded
from gpufluidsimulator_tpu.ops import physics as jphysics

import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.models import solver as tsolver
from gpufluidsimulator_torch.ops import grid as tgrid
from gpufluidsimulator_torch.ops import gridded as tgridded
from gpufluidsimulator_torch.ops import physics as tphysics

CASES = ["2d", "3d", "overflow", "aniso"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share the host: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scene(case):
    """2D n=600 and 3D n=1,200 dam breaks; a cell capacity of 2 that drops
    particles; and 2D x cells of one lattice spacing (x halfwidth 2)."""
    dim, n = (3, 1200) if case == "3d" else (2, 600)
    jp, js = jfs.scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=11)
    if case == "overflow":
        jp = jp.replace(cell_capacity=2)
    if case == "aniso":
        dx = (jp.particle_mass / jp.rest_density) ** 0.5
        jp = jp.replace(cell_aniso=(dx, 2 * dx))
        assert jp.x_halfwidth == 2
    return jp, js


def _port(jp, js):
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    ts = convert.state_from_numpy(*(np.asarray(a) for a in js),
                                  device="cpu")
    return tp, ts


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


@pytest.mark.parametrize("case", CASES)
def test_grid_helpers_and_cell_id_exact(case):
    jp, js = _scene(case)
    tp, _ = _port(jp, js)
    for name in ("halfwidths", "padded_res", "num_padded_cells", "strides",
                 "neighbor_offsets"):
        assert getattr(tgrid, name)(tp) == getattr(jgrid, name)(jp), name
    # positions outside the box too: both clip into the edge cells
    rng = np.random.default_rng(0)
    extra = rng.uniform(-0.2, 1.2, (64, jp.dim)).astype(np.float32)
    pos = np.concatenate([np.asarray(js.pos), extra])
    want = np.asarray(jgrid.cell_id(jnp.asarray(pos), jp))
    got = tgrid.cell_id(torch.from_numpy(pos), tp)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", CASES)
def test_build_cell_table_exact(case):
    jp, js = _scene(case)
    tp, ts = _port(jp, js)
    jt = jgrid.build_cell_table(js.pos, js.vel, jp)
    tt = tgrid.build_cell_table(ts.pos, ts.vel, tp)
    for field in ("pos", "vel", "valid", "slot"):
        a, b = getattr(tt, field).numpy(), np.asarray(getattr(jt, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert int(tt.overflow) == int(jt.overflow)
    assert (int(tt.overflow) > 0) == (case == "overflow")
    # per-particle gather, dropped rows filled
    field = np.array(jt.pos)[..., :1]
    want = jgrid.gather_per_particle(jnp.asarray(field), jt.slot, -7.0)
    got = tgrid.gather_per_particle(torch.from_numpy(field), tt.slot, -7.0)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", CASES)
def test_density_and_accel_dense_match_jax(case):
    jp, js = _scene(case)
    tp, ts = _port(jp, js)
    jt = jgrid.build_cell_table(js.pos, js.vel, jp)
    tt = tgrid.build_cell_table(ts.pos, ts.vel, tp)
    rho_j = np.asarray(jgridded.density_dense(jt, jp))
    rho_t = tgridded.density_dense(tt, tp).numpy()
    valid = np.asarray(jt.valid)
    assert _rel(rho_t[valid], rho_j[valid]) <= 1e-5
    # the same density into both force sweeps
    rho = np.where(valid, rho_j, jp.rest_density).astype(np.float32)
    pres_j = jphysics.eos_pressure(jnp.asarray(rho), jp)
    pres_t = tphysics.eos_pressure(torch.from_numpy(rho), tp)
    acc_j = np.asarray(jgridded.accel_dense(jt, jnp.asarray(rho), pres_j, jp))
    acc_t = tgridded.accel_dense(tt, torch.from_numpy(rho), pres_t,
                                 tp).numpy()
    assert _rel(acc_t[valid], acc_j[valid]) <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_gridded_step_matches_jax(case):
    jp, js = _scene(case)
    tp, ts = _port(jp, js)
    sj = jsolver.step(js, jp, method="gridded")
    st = tsolver.step(ts, tp, method="gridded", device="cpu")
    assert int(st.overflow) == int(sj.overflow)
    assert np.array_equal(st.ids.numpy(), np.asarray(sj.ids))
    assert _rel(st.pos.numpy(), np.asarray(sj.pos)) <= 1e-6
    assert _rel(st.vel.numpy(), np.asarray(sj.vel)) <= 1e-5
    assert _rel(st.rho.numpy(), np.asarray(sj.rho)) <= 1e-5
    assert _rel(st.pres.numpy(), np.asarray(sj.pres)) <= 1e-4
    if case == "overflow":
        # dropped particles: rest density, no pressure
        dropped = tgrid.build_cell_table(ts.pos, ts.vel, tp).slot < 0
        assert (st.rho[dropped] == tp.rest_density).all()
        assert (st.pres[dropped] == 0.0).all()


def test_gridded_obstacle_run_matches_jax():
    """50 steps of the 2D double dam break (box pillar + sphere)."""
    jp, js = jfs.scenes.double_dam_break(n=1200, dim=2)
    tp, ts = _port(jp, js)
    sj = jfs.run(js, jp, 50, method="gridded")
    sim = tfs.FluidSim(tp, ts, method="gridded", device="cpu")
    sim.step(50)
    assert int(sim.state.overflow) == int(sj.overflow) == 0
    assert _rel(sim.get_positions(), np.asarray(sj.pos)) <= 1e-4


def test_gridded_registered_and_auto_unchanged(monkeypatch):
    for n in (100, 8192, 8193, 65536):
        assert tsolver.resolve_method("auto", n) \
            == jsolver.resolve_method("auto", n)
    assert tsolver.resolve_method("gridded", 10) == "gridded"
    assert tsolver._run_method("gridded", 100, 65536) == "gridded"
    tp, ts = tfs.scenes.dam_break(n=300, dim=2, device="cpu")
    traj_state, traj = tfs.rollout(ts, tp, 4, method="gridded",
                                   record_every=2, device="cpu")
    assert traj.shape == (2, ts.n, 2)
    assert torch.equal(traj[-1], traj_state.pos)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfs.FluidSim(tp, ts, method="gridded")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfs.run(ts, tp, 1, method="gridded")
