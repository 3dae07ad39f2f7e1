"""The x-tile seam of the rank planes on the incremental path.

A scene whose grid is 140 cells wide has planes of two x tiles (126
interior cells each); its seam lies at x cell 126.  A low slab of fluid
(2,400 particles, 40 x 12 x 5 lattice spacings) stands just left of the
seam and is thrown right at 4 m/s (0.1 of a cell a step), so its front
crosses into the second tile a few steps in, while the rest of it still
reads its neighbours across the seam.

- ``solver.run(method="pallas_inc")`` on the CPU against the benchmark's
  plain reference (``benchmark/fbench/reference.py``: float64 PyTorch, a
  cell list of its own, nothing of the port), particles matched by id.
- The step's ``seam_movers`` counter against a plain count from the
  states before and after each step, and 0 on planes of one tile; no
  count is made while no profiler session records.

Imports nothing of JAX.
"""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpufluidsimulator_torch as ft
from gpufluidsimulator_torch.models import solver
from gpufluidsimulator_torch.ops import inc
from gpufluidsimulator_torch.ops import planes as pm
from gpufluidsimulator_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from fbench import check, program, scene  # noqa: E402
from fbench.reference import Reference  # noqa: E402

DX = 0.008                 # lattice spacing; h = 1.3 DX, the cell = h
NX = 140                   # past 126 * 1.06: snap_cell cannot fold it
STEPS = 16                 # the reference comparison's steps
COUNTED_STEPS = 8          # steps whose seam movers are counted by hand
SEED = 2 ** 31 + 7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes share the host: one torch thread each; and
    every test starts from an empty record."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.take_calls()
    yield
    torch.set_num_threads(before)


def _scene():
    """-> (constants, params, state): the harness's scene generator and
    the port's parameters from it (``fbench.scene``, ``fbench.program``),
    as a benchmark cell makes them, with the slab thrown right."""
    h = 1.3 * DX
    seam = pm.TILE_X * h
    cfg = {
        "scene": {"dim": 3, "n_request": 2400,
                  "fluid_volume": [40 * DX, 12 * DX, 5 * DX],
                  "height": 12 * DX,
                  "fluid_boxes": [[[seam - 40 * DX, 0.0, 0.0],
                                   [seam, 12 * DX, 5 * DX]]],
                  "bounds": [[0.0, 0.0, 0.0], [NX * h, 14 * DX, 5 * DX]],
                  "obstacles": []},
        "physics": {"eta": 1.3, "cfl": 0.35, "sound_speed_factor": 10.0,
                    "rest_density": 1000.0, "viscosity": 0.25,
                    "gravity": [0.0, -9.81, 0.0], "restitution": 0.5,
                    "eos": "linear", "clamp_negative_pressure": True,
                    "cell_capacity": 8, "precision": "float32"},
        "assumed": {"jitter": 0.05},
    }
    const = scene.constants(cfg)
    params = program.params(const)
    pos = torch.from_numpy(scene.positions(cfg, SEED))
    vel = torch.zeros_like(pos)
    vel[:, 0] = 4.0
    return const, params, program.state(pos, "cpu")._replace(vel=vel)


def _tile(pos, params, geom):
    """(N,) the x tile of each position's cell."""
    cid = pm.cell_linear_parts(pos, params, geom)
    return (cid // (geom.py * pm.LANES)) % geom.n_bx


def test_two_tiles_against_the_reference():
    const, params, state = _scene()
    geom = pm.geometry(params)
    assert geom.n_bx == 2
    assert (_tile(state.pos, params, geom) == 0).all()

    out = solver.run(state, params, STEPS, method="pallas_inc",
                     device="cpu")
    assert int(out.overflow) == 0
    assert torch.equal(torch.sort(out.ids).values, state.ids)
    crossed = int((_tile(out.pos, params, geom) == 1).sum())
    assert crossed >= 20, crossed

    x, v, rho, _ = Reference(const, torch.float64).run(
        state.pos, state.vel, STEPS)
    gaps = check.state_gaps(out.ids, out.pos, out.vel, out.rho, state.ids,
                            x, v, rho, const.h, const.stiffness ** 0.5,
                            const.rest_density)
    # float32 against float64 over 16 steps reads 7.0e-5 (positions, in
    # h), 1.4e-5 (velocities, over the sound speed) and 4.8e-5 (density,
    # over rho0) on this scene; the reference's own pair arithmetic in
    # bfloat16 reads 1.6e-2, 5.9e-3 and 2.0e-2.  Each limit sits 14x and
    # more above the float32 reading and 12x and more below bfloat16's;
    # a neighbour lost or doubled across the seam moves a density by some
    # 3e-2 (one of about 30 neighbours) and fails it.
    assert gaps["pos_p999_h"] < 1e-3, gaps
    assert gaps["vel_p999_c"] < 5e-4, gaps
    assert gaps["rho_p999"] < 1e-3, gaps


def _by_id(s: inc.IncState, geom):
    """The positions of the planes' particles, row k holding id k."""
    valid = (s.fields6[0] < pm.SENTINEL * 0.5) & pm.interior_mask(geom)[None]
    pos = torch.stack([s.fields6[d][valid] for d in range(3)], dim=-1)
    return pos[torch.argsort(s.idp[valid])]


def test_seam_movers_counts_the_tile_crossers():
    """Per step: the particles the step moved to another cell whose x tile
    differs between the states before and after it.  The slab straddles
    the seam, stirred, so that movers leave slots of both tiles and cross
    both ways."""
    _, params, state = _scene()
    geom = pm.geometry(params)
    g = torch.Generator().manual_seed(3)
    state = state._replace(
        pos=state.pos + torch.tensor([15 * DX, 0.0, 0.0]),
        vel=torch.randn(state.vel.shape, generator=g) * 6.0)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
    m_cap = inc.mover_capacity(state.n)
    counted, by_hand = [], []
    for _ in range(COUNTED_STEPS):
        before = _by_id(s, geom)
        with profile(activities=[ProfilerActivity.CPU]):
            s = inc.step_planes(s, params, geom, m_cap)
        (call,) = profiling.take_calls()
        counted.append(call["counters"]["seam_movers"])
        after = _by_id(s, geom)
        moved = pm.cell_linear_parts(before, params, geom) \
            != pm.cell_linear_parts(after, params, geom)
        by_hand.append(int((moved & (_tile(before, params, geom)
                                     != _tile(after, params, geom))).sum()))
    assert int(s.overflow) == 0
    assert counted == by_hand
    assert sum(counted) >= 30, counted


def test_seam_movers_zero_on_one_tile_and_free_untraced(monkeypatch):
    """One tile: the counter reads 0 while movers move.  Without a
    profiler session the step never counts."""
    params, state = ft.scenes.dam_break(n=600, dim=2, jitter=0.2, seed=1,
                                        device="cpu")
    assert pm.geometry(params).n_bx == 1
    state = state._replace(vel=torch.randn(
        state.vel.shape, generator=torch.Generator().manual_seed(0)) * 3.0)
    with profile(activities=[ProfilerActivity.CPU]):
        solver.run(state, params, 4, method="pallas_inc", device="cpu")
    (call,) = profiling.take_calls()
    assert call["counters"]["movers"] > 0
    assert call["counters"]["seam_movers"] == 0

    def refuse(*args, **kw):
        raise AssertionError("seam_movers counted without a profiler")

    monkeypatch.setattr(inc, "seam_movers", refuse)
    solver.run(state, params, 4, method="pallas_inc", device="cpu")
