"""The continuity tier at cell capacity 16, across an x-tile seam, and the
counters that size the capacity.

- ``solver.run(method="pallas_inc_cont")`` with ``cell_capacity=16`` on
  a small double dam break whose planes are two x tiles wide (140 cells;
  the seam at x cell 126 cuts the right column), for more steps than the
  tier's re-sum period (shortened to 16), against the benchmark's plain
  reference (``benchmark/fbench/reference.py``: float64 PyTorch, its own
  cell list and its own continuity sum, nothing of the port), particles
  matched by id.
- A cell crowded with 12 particles: at ``cell_capacity=8`` the
  conversion and the steps count the excess in ``overflow`` and in the
  ``drops_cell_capacity`` counter; at 16 every id is kept.
- The step counter ``cell_fill_max`` against a plain count of the
  particles of each cell after each step, on one tile and on two; without
  a profiler session it is never computed.

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
NX = 140                   # cells across: past 126 * 1.06, so two x tiles
COLUMN = 20                # lattice spacings a column is wide
RESUM_EVERY = 16           # the tier's re-sum period, shortened from 64
STEPS = 24                 # so that the carried density is summed at age
#                            0 and re-summed at age 16 inside the run
SEED = 2 ** 31 + 29


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes share the host: one torch thread each; and
    every test starts from an empty record."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.take_calls()
    yield
    torch.set_num_threads(before)


def _scene(capacity: int = 16, nx: int = NX):
    """-> (constants, params, state): a double dam break ``nx`` cells
    wide, 12 spacings high and 5 deep, made by the harness's scene
    generator and turned into the port's parameters as a benchmark cell
    does (``fbench.scene``, ``fbench.program``)."""
    h = 1.3 * DX
    width = nx * h
    cfg = {
        "scene": {"dim": 3, "n_request": 2 * COLUMN * 12 * 5,
                  "fluid_volume": [2 * COLUMN * DX, 12 * DX, 5 * DX],
                  "height": 12 * DX,
                  "fluid_boxes": [
                      [[0.0, 0.0, 0.0], [COLUMN * DX, 12 * DX, 5 * DX]],
                      [[width - COLUMN * DX, 0.0, 0.0],
                       [width, 12 * DX, 5 * DX]]],
                  "bounds": [[0.0, 0.0, 0.0], [width, 16 * DX, 5 * DX]],
                  "obstacles": []},
        "physics": {"eta": 1.3, "cfl": 0.35, "sound_speed_factor": 10.0,
                    "rest_density": 1000.0, "viscosity": 0.25,
                    "gravity": [0.0, -9.81, 0.0], "restitution": 0.5,
                    "eos": "linear", "clamp_negative_pressure": True,
                    "cell_capacity": capacity, "precision": "float32"},
        "assumed": {"jitter": 0.05},
    }
    const = scene.constants(cfg)
    params = program.params(const)
    return const, params, program.state(scene.positions(cfg, SEED), "cpu")


def _tile(pos, params, geom):
    """(N,) the x tile of each position's cell."""
    cid = pm.cell_linear_parts(pos, params, geom)
    return (cid // (geom.py * pm.LANES)) % geom.n_bx


def test_k16_two_tiles_against_the_reference(monkeypatch):
    monkeypatch.setattr(inc, "RESUM_EVERY", RESUM_EVERY)
    const, params, state = _scene()
    geom = pm.geometry(params)
    assert geom.n_bx == 2 and geom.k == 16
    tiles = _tile(state.pos, params, geom)
    assert (tiles == 0).any() and (tiles == 1).any()

    out = solver.run(state, params, STEPS, method="pallas_inc_cont",
                     device="cpu")
    assert int(out.overflow) == 0
    assert torch.equal(torch.sort(out.ids).values, state.ids)
    assert int(check.Guard(const, "cpu")(out)) == 0

    x, v, rho, _ = Reference(const, torch.float64, RESUM_EVERY).run(
        state.pos, state.vel, STEPS, continuity=True)
    gaps = check.state_gaps(out.ids, out.pos, out.vel, out.rho, state.ids,
                            x, v, rho, const.h, const.stiffness ** 0.5,
                            const.rest_density)
    # float32 against float64 over these 24 steps reads 5.6e-5 (positions,
    # in h), 7.7e-6 (velocities, over the sound speed) and 4.2e-5
    # (density, over rho0); the reference's own pair arithmetic in
    # bfloat16 reads 2.8e-2, 4.3e-3 and 3.1e-2, and the float64 reference
    # without its re-sum at age 16 reads 6.7e-3, 1.9e-3 and 1.3e-2.  Each
    # limit sits 9x and more above the float32 reading and 13x and more
    # below both: a re-sum skipped, or a neighbour lost or doubled across
    # the seam (some 3e-2 of a density), fails each of them.
    assert gaps["pos_p999_h"] < 5e-4, gaps
    assert gaps["vel_p999_c"] < 1e-4, gaps
    assert gaps["rho_p999"] < 5e-4, gaps


def _crowded(capacity: int, nx: int = NX):
    """A double dam break with 12 extra particles packed into one cell of
    the left column's top layer."""
    _, params, state = _scene(capacity, nx)
    centre = torch.tensor([10.5, 8.5, 2.5]) * params.cell
    g = torch.Generator().manual_seed(5)
    extra = centre + (torch.rand((12, 3), generator=g) - 0.5) * 0.2 \
        * params.cell
    pos = torch.cat([state.pos, extra.to(torch.float32)])
    return params, ft.make_state(pos, device="cpu")


@pytest.mark.parametrize("capacity", [8, 16])
def test_crowded_cell_counts_or_keeps_the_excess(capacity):
    """The cell holds its lattice particles and 12 more: at K = 8 the
    conversion (``build_planes``) keeps 8 of them and the excess is
    counted as dropped for cell capacity, in ``overflow`` as in the
    counter; at K = 16 the cell and every id are kept."""
    params, state = _crowded(capacity)
    geom = pm.geometry(params)
    cid = pm.cell_linear_parts(state.pos, params, geom)
    crowded = int(torch.bincount(cid).max())
    assert 12 < crowded <= 16
    with profile(activities=[ProfilerActivity.CPU]):
        out = solver.run(state, params, 3, method="pallas_inc_cont",
                         device="cpu")
    (call,) = profiling.take_calls()
    c = call["counters"]
    missing = state.n - int((out.ids >= 0).sum())
    if capacity == 8:
        assert c["drops_cell_capacity"] >= crowded - 8
        assert c["drops_mover_capacity"] == 0
        assert int(out.overflow) == c["drops_cell_capacity"] == missing
    else:
        assert int(out.overflow) == 0 and missing == 0
        assert c["drops_cell_capacity"] == 0
        assert torch.equal(torch.sort(out.ids).values,
                           torch.arange(state.n, dtype=out.ids.dtype))


def _fill_by_hand(s: inc.IncState, params, geom) -> int:
    """The most particles any cell of the planes holds, from their
    positions' cells."""
    valid = (s.fields6[0] < pm.SENTINEL * 0.5) & pm.interior_mask(geom)[None]
    pos = torch.stack([s.fields6[d][valid] for d in range(3)], dim=-1)
    return int(torch.bincount(pm.cell_linear_parts(pos, params, geom)).max())


@pytest.mark.parametrize("tiles", [1, 2])
def test_cell_fill_max_is_the_fullest_cell(tiles, monkeypatch):
    """Per step, under a profiler: the counter equals a plain count of the
    particles in each cell after the step (the crowded cell's, its
    pressure softened so that the steps do not blow it apart at once).
    On the continuity tier, one tile (the scene 60 cells wide) and two.
    Without a profiler session the step never asks ``consolidate`` for
    it."""
    params, state = _crowded(16, NX if tiles == 2 else 60)
    params = params.replace(stiffness=params.stiffness * 1e-4)
    geom = pm.geometry(params)
    assert geom.n_bx == tiles
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom,
                      continuity=True)
    m_cap = inc.mover_capacity(state.n)
    counted, by_hand = [], []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU]):
            s = inc.step_planes(s, params, geom, m_cap)
        (call,) = profiling.take_calls()
        counted.append(call["counters"]["cell_fill_max"])
        by_hand.append(_fill_by_hand(s, params, geom))
    assert int(s.overflow) == 0
    assert counted == by_hand
    assert max(counted) == 14, counted

    consolidate = inc.consolidate

    def untraced(*args, **kw):
        assert args[6:] == (None,) and "fill_max" not in kw
        return consolidate(*args, **kw)

    monkeypatch.setattr(inc, "consolidate", untraced)
    inc.step_planes(s, params, geom, m_cap)
    assert profiling.calls() == []
