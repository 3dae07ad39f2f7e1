"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Marked ``cuda``; every test skips without a CUDA device.

Imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q

Small scenes that reach the branches the config-3 and config-4 checks in
``chip_smoke.py`` do not: 2D, several x tiles (halo lanes), the Tait EOS,
a cell capacity of 16 (the kernels' second rank width), particles inside both obstacles and through the
walls, forced drops, every form and switch of the continuity step, the
force kernels' and the density sweep's march (a box filled to its z
walls over an odd number of planes, a tile of more queries than threads,
ring planes packed past their capacity, whose overflows the kernels
count; for the density sweep also planes two x tiles wide in 3D), 27
cells at full capacity above an empty 8-row block (occ_q 0; for the
density sweep also at K = 16, in 2D and across two x tiles, and with
bounds zeroed on purpose), the gather's edges (3, 4 and 5 channels, a
count that is not a multiple of 32, slots past the end), the
compaction's edges (no flag, every flag, the first and last slot, 1 and
8 channels, a partial last chunk, calls in a row), and the packed-pair
sweep with a sentinel tail, a query tile whose three candidate ranges
are empty, particles on cell corners, query groups across row and plane
wraps, and tiles whose ranges it stages in several windows; and the
sharded methods on two slabs of the card against two CPU slabs, with a
lock-step 3-slab step under sync debug mode "error".
Tolerances as in ``chip_smoke.py``: occupancy, placement, gather,
compaction and consolidation exact; density and the packed sweep relative
1e-5 and force 1e-4 (summation order and ``rsqrtf``); the fused force
steps relative 1e-6 on positions and 1e-4 on velocities, the continuity
step's rho relative 1e-5, with mover flags equal except on slots within
1e-5 of a cell face (FMA contraction moves a position by a rounding).
"""

import numpy as np
import pytest
import torch

import gpufluidsimulator_torch as ft
from gpufluidsimulator_torch import _build
from gpufluidsimulator_torch.ops import planes as pm
from gpufluidsimulator_torch.ops import inc, mxu_sweep, naive, physics, route
from gpufluidsimulator_torch.ops import sph

pytestmark = pytest.mark.cuda

CASES = ["2d", "3d", "multi_tile", "3d_tait", "3d_k16"]
# the force kernels' edge: 27 cells at full capacity K around one query
# cell, in the y block above an empty one (occ_q 0 beside full cells)
FORCE_EDGE = "full_stencil"
# the force kernels' march (csrc/ring.cuh): a box filled to its z walls,
# over an odd number of planes (the columns' last is cut short); one tile
# of 372 queries; cells at full capacity over more than a ring plane
# holds, in 3D, in 2D and at K = 16 (planes staged and walked in windows)
RING_CASES = ["z_edges", "many_queries", "ring_overflow", "ring_overflow_2d",
              "ring_overflow_k16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _full_cells(params, xs, zs=(0,)):
    """K particles (numpy-seeded) in each cell of xs x (8, 9, 10) [x zs]:
    y block 1 of the interior holds them, y block 0 (cells 0..7) none."""
    rng = np.random.default_rng(4)
    k, dim = params.cell_capacity, params.dim
    corner = np.array([(x, y, z)[:dim] for x in xs for y in (8, 9, 10)
                       for z in zs], dtype=np.float64)
    pos = (corner[:, None, :]
           + rng.uniform(0.05, 0.95, (corner.shape[0], k, dim))) \
        * np.asarray(params.cells_axis) + np.asarray(params.bounds_min)
    pos = pos.reshape(-1, dim).astype(np.float32)
    return params, ft.make_state(pos, np.zeros_like(pos), device="cpu")


def _packed_cells(params, cells, per_cell, seed=4):
    """``per_cell`` particles (numpy-seeded) in each of the grid cells
    ``cells`` (an (n, dim) int array)."""
    rng = np.random.default_rng(seed)
    dim = params.dim
    pos = (np.asarray(cells, np.float64)[:, None, :]
           + rng.uniform(0.05, 0.95, (len(cells), per_cell, dim))) \
        * np.asarray(params.cells_axis) + np.asarray(params.bounds_min)
    pos = pos.reshape(-1, dim).astype(np.float32)
    return params, ft.make_state(pos, np.zeros_like(pos), device="cpu")


def _ring_scene(case):
    """RING_CASES' scenes (see there)."""
    dim = 2 if case == "ring_overflow_2d" else 3
    params, _ = ft.scenes.dam_break(n=1200, dim=dim, device="cpu")
    if case == "z_edges":
        # 13 cells along z: 15 planes, an odd count
        params = params.replace(bounds_max=(1.0, 1.0, 1.0 + params.cell))
        state = ft.scenes.spawn_box(params, params.bounds_min,
                                    params.bounds_max, jitter=0.3, seed=5,
                                    device="cpu")
        assert pm.geometry(params).pz == 15
        return params, state
    # 42 cells along x
    params = params.replace(bounds_max=(3.5,) + params.bounds_max[1:])
    if case == "many_queries":
        # lanes 1..31 of x tile 0, the 4 rows of one tile, one z plane
        cells = [(x, y, 3) for x in range(31) for y in range(4)]
        return _packed_cells(params, cells, 3)
    # 40 x 6 (x 5 in 3D) cells at capacity: a ring plane's 6 x 34 cells
    # hold 8 or 16 ranks each
    if case == "ring_overflow_k16":
        params = params.replace(cell_capacity=16)
    zs = range(1, 6) if dim == 3 else (0,)
    cells = [(x, y, z)[:dim] for x in range(40) for y in range(6)
             for z in zs]
    return _packed_cells(params, cells, params.cell_capacity)


def _ring_check(case, device, before):
    """The force kernels' ring overflows since ``before``: some in the
    packed cases, none elsewhere."""
    overflows = sph.ring_overflows(device) - before
    if case.startswith("ring_overflow"):
        assert overflows > 0
    else:
        assert overflows == 0


def _multi_tile_params():
    params, _ = ft.scenes.dam_break(n=900, dim=2, jitter=0.2, seed=5,
                                    device="cpu")
    return params.replace(bounds_min=(0.0, 0.0), bounds_max=(4.0, 1.0))


def _scene(case):
    if case in RING_CASES:
        return _ring_scene(case)
    if case == FORCE_EDGE:
        # cells x, z in 2..4 and y in 8..10 (y block 1) hold K particles
        # each; y block 0 (cells 0..7) holds none
        params, _ = ft.scenes.double_dam_break(n=1200, dim=3, device="cpu")
        return _full_cells(params, (2, 3, 4), (2, 3, 4))
    if case == "multi_tile":
        params = _multi_tile_params()
        bx = 126 * params.cell
        state = ft.scenes.spawn_box(params, [bx - 0.2, 0.0],
                                    [bx + 0.2, 0.25], jitter=0.2, seed=5,
                                    device="cpu")
        assert pm.geometry(params).n_bx > 1
        return params, state
    dim, n = (2, 600) if case == "2d" else (3, 1200)
    params, state = ft.scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=11,
                                        device="cpu")
    if case == "3d_tait":
        params = params.replace(eos="tait")
    if case == "3d_k16":
        params = params.replace(cell_capacity=16)
    return params, state


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-9))


@pytest.mark.parametrize("case", CASES + [FORCE_EDGE] + RING_CASES)
def test_kernels_match_plain(cuda, case):
    params, state = _scene(case)
    geom = pm.geometry(params)
    table = pm.build_planes(*(t.to(cuda) for t in
                              (state.pos, state.vel, state.ids)),
                            params, geom)
    planes = table.planes
    if case == FORCE_EDGE:
        occ_q, _ = pm.occupancy_bounds(planes, params, geom)
        assert int(occ_q[:, :, 0].max()) == 0
        assert int(occ_q[:, :, 1].max()) == geom.k
    before = dict(_build.launches)

    got = pm.occ_rowmax(planes[pm.FIELD_X], geom)
    assert torch.equal(got, pm.occ_rowmax_plain(planes[pm.FIELD_X]))

    fields = torch.cat([table.pos_s.T, table.vel_s.T]).contiguous()
    got = route.place(fields, table.slot, table.ok, geom, params.dim)
    want = route.place_plain(fields, table.slot, table.ok, geom, params.dim)
    assert torch.equal(got, want)

    occ_q, occ_s = pm.occupancy_bounds(planes, params, geom)
    pos_planes = planes[:pm.N_POS_FIELDS]
    rho = sph.density_planes(pos_planes, occ_q, occ_s, params, geom)
    rho_plain = sph.density_plain(pos_planes, params, geom)
    assert _rel(rho, rho_plain) <= 1e-5
    rho = pm.halo_x(rho)

    ring = sph.ring_overflows(cuda)
    acc = sph.accel_planes(planes, rho, occ_q, occ_s, params, geom)
    assert _rel(acc, sph.accel_plain(planes, rho, params, geom)) <= 1e-4
    _ring_check(case, cuda, ring)

    stack = torch.cat([acc, rho[None]]).contiguous()
    got = route.gather(stack, table.slot)
    assert torch.equal(got, route.gather_plain(stack, table.slot))
    torch.cuda.synchronize()
    # occ_rowmax twice: directly and through occupancy_bounds
    want_counts = dict.fromkeys(before, 0)
    want_counts.update(occ_rowmax=2, place=1, density=1, force=1, gather=1)
    assert {k: _build.launches[k] - before[k] for k in before} == want_counts


@pytest.mark.parametrize("case", CASES)
def test_step_on_card_matches_cpu(cuda, case):
    params, state = _scene(case)
    gpu = ft.FluidSim(params, state, method="pallas", device=cuda)
    cpu = ft.FluidSim(params, state, method="pallas", device="cpu")
    gpu.step(1)
    cpu.step(1)
    assert int(gpu.state.overflow) == int(cpu.state.overflow)
    og = np.argsort(gpu.state.ids.cpu().numpy())
    oc = np.argsort(cpu.state.ids.numpy())
    for key, tol in (("rho", 1e-5), ("pos", 1e-6), ("vel", 1e-4)):
        a = getattr(gpu.state, key).cpu()[og]
        b = getattr(cpu.state, key)[oc]
        assert _rel(a, b) <= tol, key


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    params, state = _scene("2d")
    geom = pm.geometry(params)
    x = torch.full((geom.k, geom.pz, geom.n_bx, geom.py, pm.LANES),
                   pm.SENTINEL, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        pm.occ_rowmax(x, geom)
    with pytest.raises(ValueError, match="contiguous"):
        pm.occ_rowmax(x.float().transpose(-1, -2).contiguous()
                      .transpose(-1, -2), geom)


# the density sweep's edges: full cells above an empty 8-row block (occ_q 0
# beside full cells) at K = 16 in 3D, in 2D, and in 2D across the boundary
# of two x tiles (x cells 125..127; each tile stages the other's halo lane)
DENSITY_EDGES = ["full_stencil_k16", "full_stencil_2d", "full_stencil_tiles"]


def _density_edge(case):
    if case == "full_stencil_k16":
        params, _ = ft.scenes.double_dam_break(n=1200, dim=3, device="cpu")
        return _full_cells(params.replace(cell_capacity=16), (2, 3, 4),
                           (2, 3, 4))
    if case == "full_stencil_2d":
        params, _ = ft.scenes.dam_break(n=600, dim=2, device="cpu")
        return _full_cells(params, (2, 3, 4))
    params = _multi_tile_params()
    assert pm.geometry(params).n_bx > 1
    return _full_cells(params, (125, 126, 127))


@pytest.mark.parametrize("case", DENSITY_EDGES)
def test_density_edges_match_plain(cuda, case):
    """The density sweep against its plain version (relative 1e-5) where
    its tile meets its bounds: an 8-row block whose occ_q is 0 below 8-row
    blocks of full cells, at K = 16, in 2D and across x tiles; one launch.
    Then with the bounds zeroed on purpose: occ_q 0 everywhere skips every
    block (no query, nothing staged: rho all 0), and occ_s 0 everywhere
    stages nothing (every query sums no candidate, not even itself)."""
    params, state = _density_edge(case)
    geom = pm.geometry(params)
    table = pm.build_planes(*(t.to(cuda) for t in
                              (state.pos, state.vel, state.ids)),
                            params, geom)
    assert bool(table.ok.all())
    pos_planes = table.planes[:pm.N_POS_FIELDS]
    occ_q, occ_s = pm.occupancy_bounds(table.planes, params, geom)
    assert int(occ_q[:, :, 0].max()) == 0
    assert int(occ_q[:, :, 1].max()) == geom.k
    before = dict(_build.launches)
    rho = sph.density_planes(pos_planes, occ_q, occ_s, params, geom)
    torch.cuda.synchronize()
    launched = {k: _build.launches[k] - before[k] for k in before}
    want = sph.density_plain(pos_planes, params, geom)
    assert _rel(rho, want) <= 1e-5
    assert torch.equal(rho == 0, want == 0)
    assert launched == {k: int(k == "density") for k in before}
    for zq, zs in ((torch.zeros_like(occ_q), occ_s),
                   (occ_q, torch.zeros_like(occ_s))):
        got = sph.density_planes(pos_planes, zq, zs, params, geom)
        assert not got.any()


# the density sweep's march (csrc/ring.cuh): planes two x tiles wide in 3D
# (a box across x cell 126), 2D, K = 16, and RING_CASES' packed cells,
# whose ring planes hold more valid slots than the density sweep's ring
DENSITY_RING_CASES = ["tiles_3d", "2d", "3d_k16", "ring_overflow",
                      "ring_overflow_2d", "ring_overflow_k16"]


def _density_ring_scene(case):
    if case != "tiles_3d":
        return _scene(case)
    params, _ = ft.scenes.dam_break(n=1200, dim=3, device="cpu")
    params = params.replace(bounds_max=(130 * params.cell,)
                            + params.bounds_max[1:])
    bx = 126 * params.cell
    state = ft.scenes.spawn_box(params, [bx - 0.3, 0.0, 0.0],
                                [bx + 0.3, 0.4, 1.0], jitter=0.3, seed=5,
                                device="cpu")
    assert pm.geometry(params).n_bx == 2
    return params, state


@pytest.mark.parametrize("case", DENSITY_RING_CASES)
def test_density_ring_matches_plain(cuda, case):
    """The density sweep's z-marching column against its plain version
    (relative 1e-5; the same zero slots), one launch: across two x tiles,
    in 2D, at K = 16, and where ring planes overflow.  There the planes'
    candidates are read from memory, in the walk's own order, and counted
    in the density sweep's own counter (the force kernels' does not move),
    and the sums still equal the plain version's, which stages no ring."""
    params, state = _density_ring_scene(case)
    geom = pm.geometry(params)
    table = pm.build_planes(*(t.to(cuda) for t in
                              (state.pos, state.vel, state.ids)),
                            params, geom)
    assert bool(table.ok.all())
    pos_planes = table.planes[:pm.N_POS_FIELDS]
    occ_q, occ_s = pm.occupancy_bounds(table.planes, params, geom)
    force_ring = sph.ring_overflows(cuda)
    ring = sph.ring_overflows(cuda, sph.DENSITY_RING_OVERFLOWS)
    before = dict(_build.launches)
    rho = sph.density_planes(pos_planes, occ_q, occ_s, params, geom)
    torch.cuda.synchronize()
    launched = {k: _build.launches[k] - before[k] for k in before}
    overflows = sph.ring_overflows(cuda, sph.DENSITY_RING_OVERFLOWS) - ring
    want = sph.density_plain(pos_planes, params, geom)
    assert _rel(rho, want) <= 1e-5
    assert torch.equal(rho == 0, want == 0)
    assert launched == {k: int(k == "density") for k in before}
    assert (overflows > 0) == case.startswith("ring_overflow")
    assert sph.ring_overflows(cuda) == force_ring


@pytest.mark.parametrize("channels", [3, 4, 5])
@pytest.mark.parametrize("case", ["random", "dropped"])
def test_gather_matches_plain(cuda, case, channels):
    """The per-particle gather against its plain version, exact: numpy
    slots over the whole slot range (the first and the last slot, slots
    past the end, 1,031 particles: not a multiple of 32), and the slots of
    a binning with dropped particles (cell capacity 2); 3 and 4 channels
    (the step's) and 5 (the generic instantiation); one launch a call."""
    if case == "random":
        params, _ = _scene("2d")
        geom = pm.geometry(params)
        m = geom.k * geom.cells
        rng = np.random.default_rng(9)
        slot = np.sort(np.concatenate([
            rng.choice(m, 1024, replace=False), [0, m - 1],
            m + rng.integers(0, 1000, 5)])).astype(np.int32)
        slot = torch.from_numpy(slot).to(cuda)
    else:
        params, state = _scene("2d")
        params = params.replace(cell_capacity=2)
        geom = pm.geometry(params)
        table = pm.build_planes(*(t.to(cuda) for t in
                                  (state.pos, state.vel, state.ids)),
                                params, geom)
        assert not bool(table.ok.all())
        slot = table.slot
    shape = (channels, geom.k, geom.pz, geom.n_bx, geom.py, pm.LANES)
    stack = torch.from_numpy(np.random.default_rng(3).normal(size=shape)
                             .astype(np.float32)).to(cuda)
    before = dict(_build.launches)
    got = route.gather(stack, slot)
    torch.cuda.synchronize()
    launched = {k: _build.launches[k] - before[k] for k in before}
    assert got.shape == (slot.shape[0], channels) and got.is_contiguous()
    assert torch.equal(got, route.gather_plain(stack, slot))
    assert launched == {k: int(k == "gather") for k in before}


INC_CASES = ["2d", "3d_collide", "multi_tile", "3d_k16"]


def _inc_scene(case, seed=5):
    """A scene whose particles move about a third of a cell per step
    (numpy-seeded velocities), so movers, wall hits and, in 3D, obstacle
    hits occur in one step; 3d_collide also seeds particles inside the box
    pillar and the sphere."""
    if case in ("multi_tile", FORCE_EDGE) or case in RING_CASES:
        params, state = _scene(case)
    elif case == "2d":
        params, state = ft.scenes.dam_break(n=600, dim=2, jitter=0.3,
                                            seed=11, device="cpu")
    else:
        params, state = ft.scenes.double_dam_break(n=1200, dim=3,
                                                   device="cpu")
        if case == "3d_k16":
            params = params.replace(cell_capacity=16)
    rng = np.random.default_rng(seed)
    pos = state.pos.numpy().copy()
    n, dim = pos.shape
    if case == "3d_collide":
        (_, bc, bh), (_, sc, sr) = params.obstacles
        pick = rng.choice(n, 48, replace=False)
        pos[pick[:24]] = np.asarray(bc) + rng.uniform(-0.8, 0.8, (24, 3)) \
            * np.asarray(bh)
        d = rng.normal(size=(24, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pos[pick[24:]] = np.asarray(sc) + d * sr \
            * rng.uniform(0.2, 0.9, (24, 1))
    vel = rng.normal(size=(n, dim)) * (0.3 * params.cell / params.dt)
    return params, ft.make_state(pos, vel, device="cpu")


def _near_face(p, params):
    near = torch.zeros_like(p[0], dtype=torch.bool)
    for d in range(params.dim):
        u = (p[d].double() - params.bounds_min[d]) / params.cells_axis[d]
        near |= (u - torch.round(u)).abs() < 1e-5
    return near


def _inc_inputs(params, state, device):
    geom = pm.geometry(params)
    s = inc.to_planes(*(t.to(device) for t in
                        (state.pos, state.vel, state.ids)), params, geom)
    p6 = pm.halo_x(s.fields6)
    occ_q, occ_s = pm.occupancy_bounds(p6, params, geom)
    rho = pm.halo_x(sph.density_planes(p6[:3], occ_q, occ_s, params, geom))
    return geom, s, p6, rho, occ_q, occ_s


def _sector_held(query):
    """Per slot: whether its 32-byte sector (8 lanes of its rank row)
    holds a query."""
    return query.reshape(-1, 8).any(1, keepdim=True).expand(-1, 8) \
        .reshape(query.shape)


def _check_force_step(new6, flagp, new6_p, flag_p, params, p6, geom):
    """The fill's contract (csrc/force.cu): at a slot that holds no query,
    x is the sentinel and the flag 0, and in a sector that holds a query
    every plane equals the plain version's."""
    valid = (p6[0] < pm.SENTINEL * 0.5) & \
        pm.interior_mask(geom, p6.device)[None]
    assert _rel(new6[:3, valid], new6_p[:3, valid]) <= 1e-6
    assert _rel(new6[3:, valid], new6_p[3:, valid]) <= 1e-4
    assert bool((new6[0][~valid] == pm.SENTINEL).all())
    assert bool((flagp[~valid] == 0.0).all())
    rest = _sector_held(valid) & ~valid
    assert torch.equal(new6[:, rest], new6_p[:, rest])
    near = _near_face(new6[:3], params) | _near_face(new6_p[:3], params)
    differ = (flagp != flag_p) & valid
    assert not (differ & ~near).any()
    return int(differ.sum())


def _plant_kept_after_flagged(new6, flagp, geom):
    """Flag every valid rank of a cell holding two or more, but rank 1: the
    cell's only kept rank then comes after a flagged one (its flagged
    particles, which did not leave the cell, arrive back into it).
    Returns the cell."""
    valid = (new6[0] < pm.SENTINEL * 0.5) \
        & pm.interior_mask(geom, new6.device)[None]
    flat_v = valid.reshape(geom.k, -1)
    c = int(torch.nonzero(flat_v.sum(0) >= 2)[0, 0])
    f = flagp.reshape(geom.k, -1)
    f[:, c] = flat_v[:, c].to(f.dtype)
    f[1, c] = 0.0
    return c


def _has_empty_warp(new6, arr, geom):
    """Whether some row of 128 cells (one warp of consolidate), one of them
    interior, holds no particle and receives no arrival."""
    held = (new6[0, 0] < pm.SENTINEL * 0.5).reshape(-1, pm.LANES).any(1)
    arrive = (arr.starts[1:] > arr.starts[:-1]).reshape(-1, pm.LANES).any(1)
    inter = pm.interior_mask(geom, new6.device).reshape(-1, pm.LANES).any(1)
    return bool((inter & ~held & ~arrive).any())


def _check_consolidate(new6, idp, flagp, movers8, m, rho, params, geom):
    """consolidate (the first 7 mover channels) and consolidate_rho (all 8,
    rho the carried density) against their plain versions, exact; the 7
    shared outputs of the two kernels equal.  Returns both results."""
    arr8 = inc.arrival_planes(movers8, m, params, geom)
    arr7 = arr8._replace(movers=movers8[:7].contiguous())
    got = inc.consolidate(new6, idp, flagp, arr7, geom)
    want = inc.consolidate_plain(new6, idp, flagp, arr7, geom)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    got8 = inc.consolidate(new6, idp, flagp, arr8, geom, rhop=rho)
    want8 = inc.consolidate_plain(new6, idp, flagp, arr8, geom, rho)
    assert len(got8) == 4
    for a, b in zip(got8, want8):
        assert torch.equal(a, b)
    for a, b in zip(got, (got8[0], got8[1], got8[3])):
        assert torch.equal(a, b)
    return got, got8, arr8


def _check_fill_max(new6, idp, flagp, arr8, rho, geom, got, got8):
    """Asked for the fullest cell (``fill_max``, the step counter
    ``cell_fill_max``), consolidate and consolidate_rho give their plain
    versions' count and the outputs they give unasked (``got``,
    ``got8``).  Returns the count."""
    arr7 = arr8._replace(movers=arr8.movers[:7].contiguous())
    counts = set()
    for arr, rhop, outs in ((arr7, None, got), (arr8, rho, got8)):
        for fn in (inc.consolidate, inc.consolidate_plain):
            fill = torch.zeros((), dtype=torch.int32, device=new6.device)
            for a, b in zip(fn(new6, idp, flagp, arr, geom, rhop, fill),
                            outs):
                assert torch.equal(a, b)
            counts.add(int(fill))
    assert len(counts) == 1, counts
    return counts.pop()


# the cases with an interior row that holds no particle and receives none
# (the 3D scenes' 12-cell rows all hold some)
EMPTY_WARP_CASES = ("2d", "multi_tile", FORCE_EDGE)


@pytest.mark.parametrize("case", INC_CASES + [FORCE_EDGE] + RING_CASES)
def test_inc_kernels_match_plain(cuda, case):
    """force_step, compact, consolidate and consolidate_rho against their
    plain versions on the same inputs, and one launch of each wrapper a
    call (compact: one memset and one single-pass kernel).  The flags are
    then changed so that one cell's only kept rank comes after a flagged
    one; the movers carry the density as an 8th channel (the carried rho
    of consolidate_rho); in EMPTY_WARP_CASES a whole warp's cells are
    empty."""
    params, state = _inc_scene(case)
    geom, s, p6, rho, occ_q, occ_s = _inc_inputs(params, state, cuda)
    if case == "multi_tile":
        assert geom.n_bx > 1
    before = dict(_build.launches)
    ring = sph.ring_overflows(cuda)
    new6, flagp = sph.accel_step(p6, rho, occ_q, occ_s, params, geom)
    new6_p, flag_p = sph.accel_step_plain(p6, rho, params, geom)
    _check_force_step(new6, flagp, new6_p, flag_p, params, p6, geom)
    _ring_check(case, cuda, ring)
    assert int((flagp > 0.5).sum()) >= 0.01 * state.n

    m_cap = inc.mover_capacity(state.n)
    movers, m, total = inc.compact([*new6, s.idp], flagp, m_cap)
    want = inc.compact_plain([*new6, s.idp], flagp, m_cap)
    assert torch.equal(movers, want[0])
    assert int(m) == int(want[1]) and int(total) == int(want[2]) > 0
    small = inc.compact([*new6, s.idp], flagp, 5)
    small_p = inc.compact_plain([*new6, s.idp], flagp, 5)
    assert torch.equal(small[0], small_p[0]) and int(small[1]) == 5

    cell = _plant_kept_after_flagged(new6, flagp, geom)
    movers8, m8, _ = inc.compact([*new6, s.idp, rho], flagp, m_cap)
    assert torch.equal(movers8, inc.compact_plain([*new6, s.idp, rho],
                                                  flagp, m_cap)[0])
    got, _, arr8 = _check_consolidate(new6, s.idp, flagp, movers8, m8, rho,
                                      params, geom)
    assert float(got[1].reshape(geom.k, -1)[0, cell]) \
        == float(s.idp.reshape(geom.k, -1)[1, cell])
    if case in EMPTY_WARP_CASES:
        assert _has_empty_warp(new6, arr8, geom)
    torch.cuda.synchronize()
    # occ_rowmax and density once each in _inc_inputs, place in to_planes
    want = dict.fromkeys(before, 0)
    want.update(force_step=1, compact=3, consolidate=1, consolidate_rho=1)
    assert {k: _build.launches[k] - before[k] for k in before} == want


@pytest.mark.parametrize("case,capacity", [("2d", 2), ("multi_tile", 2),
                                           ("3d_k16", 16)])
def test_consolidate_forced_drops_match_plain(cuda, case, capacity):
    """Twelve movers sent into one cell: drops from arrivals beyond the
    arrival cap (``inc.arrival_cap``: ARRIVAL_K, K past it) and, at cell
    capacity 2, from ranks beyond K, equal to the plain version's, in both
    forms (the movers carry the density as the carried rho), and the
    fullest cell asked for as well; 2D, across x tiles, and at K = 16 in
    3D; one cell's only kept rank after a flagged one."""
    params, state = _inc_scene(case)
    params = params.replace(cell_capacity=capacity)
    geom, s, p6, rho, occ_q, occ_s = _inc_inputs(params, state, cuda)
    new6, flagp = sph.accel_step(p6, rho, occ_q, occ_s, params, geom)
    _plant_kept_after_flagged(new6, flagp, geom)
    movers8, m, _ = inc.compact([*new6, s.idp, rho], flagp,
                                inc.mover_capacity(state.n))
    assert int(m) > 12
    movers8[:params.dim, :12] = torch.tensor(
        [0.5 * params.cell] * params.dim, device=cuda)[:, None]
    got, got8, arr8 = _check_consolidate(new6, s.idp, flagp, movers8, m,
                                         rho, params, geom)
    assert int(got[2]) == int(got8[3]) >= 12 - min(capacity,
                                                   inc.arrival_cap(geom))
    # the crowded cell is the fullest: full at K = 2, holding all 12
    # arrivals or full at K = 16
    fill = _check_fill_max(new6, s.idp, flagp, arr8, rho, geom, got, got8)
    assert min(capacity, 12) <= fill <= capacity


# occupancy bounds: the solver scenes, and numpy-seeded sparse planes with
# a cell at K in the ghost rows y0-1 / y0+8 and in the z-ghost planes
OCC_CASES = ["2d", "3d", "multi_tile", "3d_k16", FORCE_EDGE, "sparse_2d",
             "sparse_3d", "sparse_3d_k16"]


def _occ_planes(case, device):
    if not case.startswith("sparse"):
        params, state = _scene(case)
        geom = pm.geometry(params)
        planes = pm.build_planes(*(t.to(device) for t in
                                   (state.pos, state.vel, state.ids)),
                                 params, geom).planes
        return params, geom, planes
    params, _ = _scene("2d" if case == "sparse_2d" else "3d")
    if case.endswith("k16"):
        params = params.replace(cell_capacity=16)
    geom = pm.geometry(params)
    k, rb = geom.k, pm.ROWS_PER_BLOCK
    rng = np.random.default_rng(6)
    shape = (geom.pz, geom.n_bx, geom.py, pm.LANES)
    counts = np.where(rng.random(shape) < 0.02,
                      rng.integers(1, k // 2 + 1, shape), 0)
    z_in = 1 if geom.dim == 3 else 0
    counts[z_in, 0, rb - 1, 5] = k
    counts[z_in, -1, (geom.n_by + 1) * rb, 60] = k
    if geom.dim == 3:
        counts[0, 0, rb + 3, 7] = k
        counts[-1, 0, 2 * rb + 2, 9] = k
    x = np.where(np.arange(k).reshape(k, 1, 1, 1, 1) < counts[None],
                 np.float32(0.5), np.float32(pm.SENTINEL))
    return params, geom, torch.from_numpy(x[None]).to(device)


@pytest.mark.parametrize("case", OCC_CASES)
def test_occupancy_bounds_match_plain(cuda, case):
    """occ_rowmax and occupancy_bounds on the card equal their plain
    versions, and occupancy_bounds makes one occ_rowmax launch a call."""
    params, geom, planes = _occ_planes(case, cuda)
    before = dict(_build.launches)
    q, s_ = pm.occupancy_bounds(planes, params, geom)
    torch.cuda.synchronize()
    assert {k: _build.launches[k] - before[k] for k in before} == \
        {k: int(k == "occ_rowmax") for k in before}
    want_q, want_s = pm.occupancy_bounds_plain(planes, params, geom)
    assert q.is_contiguous() and s_.is_contiguous()
    assert torch.equal(q, want_q) and torch.equal(s_, want_s)
    assert torch.equal(pm.occ_rowmax(planes[pm.FIELD_X], geom),
                       pm.occ_rowmax_plain(planes[pm.FIELD_X]))
    if case.startswith("sparse"):
        assert int(s_.max()) == geom.k and int(q.max()) < geom.k


def test_rank_loops_stop_at_first_sentinel_rank(cuda):
    """A particle planted one rank past a cell's first sentinel rank is read
    neither by occ_rowmax nor by consolidate's kept loop, on the card as in
    the plain versions."""
    params, state = _inc_scene("3d_collide")
    geom = pm.geometry(params)
    s = inc.to_planes(*(t.to(cuda) for t in
                        (state.pos, state.vel, state.ids)), params, geom)
    occ = (s.fields6[0] < pm.SENTINEL * 0.5).sum(0).reshape(-1)
    cell = int(torch.nonzero((occ > 0) & (occ < geom.k - 1))[0, 0])
    r = int(occ[cell]) + 1
    f6, idp = s.fields6.clone(), s.idp.clone()
    f6.reshape(6, geom.k, -1)[:, r, cell] = \
        s.fields6.reshape(6, geom.k, -1)[:, 0, cell]
    idp.reshape(geom.k, -1)[r, cell] = 12345.0
    assert torch.equal(pm.occ_rowmax(f6[0], geom),
                       pm.occ_rowmax(s.fields6[0], geom))
    assert torch.equal(pm.occ_rowmax(f6[0], geom),
                       pm.occ_rowmax_plain(f6[0]))
    m_cap = inc.mover_capacity(state.n)
    arr = inc.arrival_planes(torch.zeros((7, m_cap), device=cuda),
                             torch.zeros((), dtype=torch.int32, device=cuda),
                             params, geom)
    flagp = torch.zeros_like(idp)
    got = inc.consolidate(f6, idp, flagp, arr, geom)
    want = inc.consolidate_plain(f6, idp, flagp, arr, geom)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not (got[1] == 12345.0).any() and int(got[2]) == 0


@pytest.mark.parametrize("case", INC_CASES)
def test_inc_run_on_card_matches_cpu(cuda, case):
    """Three pallas_inc steps on the card against the port's CPU path,
    re-aligned by ids (summation order compounds: pos 1e-5, vel 1e-3)."""
    params, state = _scene(case) if case == "multi_tile" else \
        _scene("2d" if case == "2d" else "3d")
    if case == "3d_k16":
        params = params.replace(cell_capacity=16)
    gpu = ft.run(state, params, 3, method="pallas_inc", device=cuda)
    cpu = ft.run(state, params, 3, method="pallas_inc", device="cpu")
    assert int(gpu.overflow) == int(cpu.overflow)
    og = np.argsort(gpu.ids.cpu().numpy())
    oc = np.argsort(cpu.ids.numpy())
    assert _rel(gpu.pos.cpu()[og], cpu.pos[oc]) <= 1e-5
    assert _rel(gpu.vel.cpu()[og], cpu.vel[oc]) <= 1e-3
    assert _rel(gpu.rho.cpu()[og], cpu.rho[oc]) <= 1e-4


def test_step_planes_never_waits_for_the_card(cuda):
    """No host synchronisation inside a step: every count stays on the
    device (sync debug mode turns any synchronising call into an error)."""
    params, state = _inc_scene("3d_collide")
    geom = pm.geometry(params)
    s = inc.to_planes(*(t.to(cuda) for t in
                        (state.pos, state.vel, state.ids)), params, geom)
    m_cap = inc.mover_capacity(state.n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # the mode is live: a tensor built from host values on the card
        # is a synchronising copy
        with pytest.raises(RuntimeError):
            torch.tensor([1.0, 2.0], device=cuda)
        for _ in range(2):
            s = inc.step_planes(s, params, geom, m_cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(s.fields6).all()


CONT_CASES = {"rate": dict(cont_form="rate"),
              "relax": dict(cont_form="relax"),
              "sum": dict(cont_form="sum"),
              "alpha": dict(cont_form="rate", cont_alpha=0.1),
              "delta": dict(cont_form="rate", cont_delta=0.1),
              "beta0": dict(cont_form="rate", cont_beta=0.0)}


def _carried_rho(rho, p6, geom, seed=3):
    """A carried density: the summation density times numpy noise."""
    valid = (p6[0] < pm.SENTINEL * 0.5) & \
        pm.interior_mask(geom, p6.device)[None]
    noise = np.random.default_rng(seed).normal(size=tuple(rho.shape))
    out = rho * (1.0 + 0.05 * torch.from_numpy(noise).to(rho))
    return pm.halo_x(torch.where(valid, out, 0.0).contiguous())


@pytest.mark.parametrize("form", list(CONT_CASES))
@pytest.mark.parametrize("case", INC_CASES + [FORCE_EDGE] + RING_CASES)
def test_force_step_cont_matches_plain(cuda, case, form):
    """force_step_cont against its plain version in every form and switch,
    in 2D and 3D (with particles inside both obstacles), over several x
    tiles, at K = 16 and around 27 full cells; one launch, and no other
    kernel."""
    params, state = _inc_scene(case)
    params = params.replace(**CONT_CASES[form])
    geom, s, p6, rho, occ_q, occ_s = _inc_inputs(params, state, cuda)
    rho = _carried_rho(rho, p6, geom)
    before = dict(_build.launches)
    ring = sph.ring_overflows(cuda)
    new6, rho_new, flagp = sph.accel_step_cont(p6, rho, occ_q, occ_s,
                                               params, geom)
    torch.cuda.synchronize()
    launched = {k: _build.launches[k] - before[k] for k in before}
    _ring_check(case, cuda, ring)
    new6_p, rho_p, flag_p = sph.accel_step_cont_plain(p6, rho, params, geom)
    _check_force_step(new6, flagp, new6_p, flag_p, params, p6, geom)
    valid = (p6[0] < pm.SENTINEL * 0.5) & \
        pm.interior_mask(geom, p6.device)[None]
    assert _rel(rho_new[valid], rho_p[valid]) <= 1e-5
    rest = _sector_held(valid) & ~valid
    assert torch.equal(rho_new[rest], rho_p[rest])
    assert int((flagp > 0.5).sum()) >= 0.01 * state.n
    assert launched == {k: int(k == "force_step_cont") for k in before}


@pytest.mark.parametrize("tier", ["summation", "continuity"])
@pytest.mark.parametrize("case", INC_CASES + [FORCE_EDGE])
def test_force_step_fill_skips_only_unread_sectors(cuda, case, tier):
    """The fused steps' fill leaves y, z, the velocities (and rho) unwritten
    in the sectors that hold no query, and counts them: the count equals
    PyTorch's count of such sectors in the input planes, of every sector
    visited.  The CUDA compact, consolidate and consolidate_rho on the
    kernel's own outputs give the same results with those planes NaN at
    every slot that holds no query (a superset of what is left)."""
    params, state = _inc_scene(case)
    geom, s, p6, rho, occ_q, occ_s = _inc_inputs(params, state, cuda)
    valid = (p6[0] < pm.SENTINEL * 0.5) & \
        pm.interior_mask(geom, p6.device)[None]
    before = sph.fill_sectors(cuda)
    if tier == "continuity":
        rho = _carried_rho(rho, p6, geom)
        new6, rho_new, flagp = sph.accel_step_cont(p6, rho, occ_q, occ_s,
                                                   params, geom)
    else:
        (new6, flagp), rho_new = sph.accel_step(p6, rho, occ_q, occ_s,
                                                params, geom), None
    skipped, seen = (a - b for a, b in zip(sph.fill_sectors(cuda), before))
    assert seen == valid.numel() // 8
    assert skipped == int((~_sector_held(valid)).sum()) // 8 > 0
    bad6 = new6.clone()
    bad6[1:, ~valid] = float("nan")
    bad_rho = None
    if rho_new is not None:
        bad_rho = rho_new.clone()
        bad_rho[~valid] = float("nan")
    m_cap = inc.mover_capacity(state.n)

    def path(n6, r):
        extra = [] if r is None else [r]
        movers, m, total = inc.compact([*n6, s.idp, *extra], flagp, m_cap)
        arr = inc.arrival_planes(movers, m, params, geom)
        cons = inc.consolidate(n6, s.idp, flagp, arr, geom, r)
        return (movers, m, total, *cons)

    for a, b in zip(path(new6, rho_new), path(bad6, bad_rho)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", INC_CASES)
def test_rho_mover_path_matches_plain(cuda, case):
    """The 8-channel compact and consolidate_rho against their plain
    versions, exact; the 7 shared planes equal the summation tier's
    consolidate on the same movers."""
    params, state = _inc_scene(case)
    geom, s, p6, rho, occ_q, occ_s = _inc_inputs(params, state, cuda)
    rho = _carried_rho(rho, p6, geom)
    new6, rho_new, flagp = sph.accel_step_cont(p6, rho, occ_q, occ_s,
                                               params, geom)
    m_cap = inc.mover_capacity(state.n)
    chans = [*new6, s.idp, rho_new]
    before = dict(_build.launches)
    movers, m, total = inc.compact(chans, flagp, m_cap)
    want = inc.compact_plain(chans, flagp, m_cap)
    assert movers.shape[0] == 8 and torch.equal(movers, want[0])
    assert int(m) == int(want[1]) and int(total) == int(want[2]) > 0
    arr = inc.arrival_planes(movers, m, params, geom)
    got = inc.consolidate(new6, s.idp, flagp, arr, geom, rhop=rho_new)
    want = inc.consolidate_plain(new6, s.idp, flagp, arr, geom, rho_new)
    assert len(got) == 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    seven = inc.consolidate(new6, s.idp, flagp,
                            arr._replace(movers=movers[:7].contiguous()),
                            geom)
    for a, b in zip(seven, (got[0], got[1], got[3])):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    want = dict.fromkeys(before, 0)
    want.update(compact=1, consolidate_rho=1, consolidate=1)
    assert {k: _build.launches[k] - before[k] for k in before} == want


COMPACT_CASES = ["none", "all", "ends", "one_channel", "eight_channels",
                 "ragged"]


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_edges_match_plain(cuda, case):
    """The single-pass compact against its plain version, exact, on flag
    planes of 3 chunks (4,096 slots each): no flag, every slot flagged
    (total far above cap, so m == cap), only the first and the last slot,
    1 and 8 channels, and a plane of 3 chunks + 1,237 slots (a partial last
    chunk, not a whole number of float4).  Three calls in a row, as a step
    makes them, each with the scratch left by the last: the epoch tags
    keep every call's look-back to its own chunks."""
    rng = np.random.default_rng(2)
    m = 3 * inc.COMPACT_CHUNK + (1237 if case == "ragged" else 0)
    n_ch = {"one_channel": 1, "eight_channels": 8}.get(case, 7)
    chans = [torch.from_numpy(rng.normal(size=m).astype(np.float32))
             .to(cuda) for _ in range(n_ch)]
    flags = np.zeros(m, np.float32)
    if case == "all":
        flags[:] = 1.0
    elif case == "ends":
        flags[[0, m - 1]] = 1.0
    elif case != "none":
        flags[rng.random(m) < 0.1] = 1.0
    flags = torch.from_numpy(flags).to(cuda)
    want_total = int((flags > 0.5).sum())
    for cap in (2048, 2048, 100):
        got = inc.compact(chans, flags, cap)
        want = inc.compact_plain(chans, flags, cap)
        assert torch.equal(got[0], want[0])
        assert int(got[2]) == int(want[2]) == want_total
        assert int(got[1]) == int(want[1]) == min(want_total, cap)
    if case == "all":
        assert want_total == m and int(got[1]) == 100
    if case == "ends":
        assert torch.equal(got[0][:, :2], torch.stack(
            [torch.stack([c[0], c[-1]]) for c in chans]))


@pytest.mark.parametrize("case", INC_CASES)
def test_inc_cont_run_on_card_matches_cpu(cuda, case, monkeypatch):
    """Three pallas_inc_cont steps on the card against the port's CPU path
    (rate with RESUM_EVERY = 2, so step 3 re-sums), re-aligned by ids: pos
    1e-5, vel 1e-3, and the carried rho keyed by id 1e-5."""
    monkeypatch.setattr(inc, "RESUM_EVERY", 2)
    params, state = _scene(case) if case == "multi_tile" else \
        _scene("2d" if case == "2d" else "3d")
    if case == "3d_k16":
        params = params.replace(cell_capacity=16)
    gpu = ft.run(state, params, 3, method="pallas_inc_cont", device=cuda)
    cpu = ft.run(state, params, 3, method="pallas_inc_cont", device="cpu")
    assert int(gpu.overflow) == int(cpu.overflow)
    og = np.argsort(gpu.ids.cpu().numpy())
    oc = np.argsort(cpu.ids.numpy())
    assert _rel(gpu.pos.cpu()[og], cpu.pos[oc]) <= 1e-5
    assert _rel(gpu.vel.cpu()[og], cpu.vel[oc]) <= 1e-3
    geom = pm.geometry(params)
    rhos = []
    for dev in (cuda, "cpu"):
        s = inc.to_planes(*(t.to(dev) for t in
                            (state.pos, state.vel, state.ids)), params, geom,
                          continuity=True)
        for _ in range(3):
            s = inc.step_planes(s, params, geom, inc.mover_capacity(state.n))
        valid = (s.fields6[0] < pm.SENTINEL * 0.5) & \
            pm.interior_mask(geom, s.idp.device)[None]
        ids = s.idp[valid].long().cpu()
        rho = torch.zeros(state.n, dtype=torch.float32)
        rho[ids] = s.rhop[valid].cpu()
        rhos.append(rho)
    assert _rel(rhos[0], rhos[1]) <= 1e-5


def test_cont_step_planes_never_waits_for_the_card(cuda):
    """The continuity step at age 0 (seeding sweep) and age 1 (carried rho)
    under sync debug mode "error"."""
    params, state = _inc_scene("3d_collide")
    geom = pm.geometry(params)
    s = inc.to_planes(*(t.to(cuda) for t in
                        (state.pos, state.vel, state.ids)), params, geom,
                      continuity=True)
    m_cap = inc.mover_capacity(state.n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            s = inc.step_planes(s, params, geom, m_cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert s.age == 2 and torch.isfinite(s.rhop).all()


def _settled_packed(n, steps):
    """tests/test_torch_mxu.py's input: a 3D dam break settled by a few
    all-pairs steps on the CPU, with its summation density and pressure."""
    params, state = ft.scenes.dam_break(n=n, dim=3, jitter=0.3, seed=3,
                                        device="cpu")
    state = ft.run(state, params, steps, method="naive", device="cpu")
    rho = naive.density_naive(state.pos, params)
    pres = physics.eos_pressure(rho, params)
    return params, [state.pos, state.vel, rho, pres]


def _stress_packed(seed=5):
    """The stress scene of the packed sweep's pruning rule (which
    tests/test_torch_mxu.py holds on the CPU too): a 5^3 block of particles
    exactly on cell corners, 150 in one cell, 300 scattered over the box
    (query groups across y-row and z-plane wraps); random velocities,
    summation density and pressure."""
    params, _ = ft.scenes.dam_break(n=4096, dim=3, device="cpu")
    h = params.h
    rng = np.random.default_rng(seed)
    k = np.arange(3, 8, dtype=np.float32)
    faces = np.stack(np.meshgrid(k, k, k, indexing="ij"), -1).reshape(-1, 3)
    faces = faces * np.float32(h)
    lump = (12.0 + rng.uniform(0.05, 0.95, (150, 3))) * h
    cloud = rng.uniform(0.02, 0.98, (300, 3))
    pos = torch.from_numpy(np.concatenate([faces, lump, cloud])
                           .astype(np.float32))
    vel = torch.from_numpy(rng.normal(0.0, 0.5, pos.shape).astype(np.float32))
    rho = naive.density_naive(pos, params)
    return params, [pos, vel, rho, physics.eos_pressure(rho, params)]


def _dense_packed(seed=6):
    """2,600 particles in one cell (numpy-seeded): the tiles' ranges hold
    more rows than the kernel stages at a time."""
    params, _ = ft.scenes.dam_break(n=4096, dim=3, device="cpu")
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(((12.0 + rng.uniform(0.0, 1.0, (2600, 3)))
                            * params.h).astype(np.float32))
    vel = torch.from_numpy(rng.normal(0.0, 0.5, pos.shape).astype(np.float32))
    rho = naive.density_naive(pos, params)
    return params, [pos, vel, rho, physics.eos_pressure(rho, params)]


@pytest.mark.parametrize("scene", ["1100", "777", "stress", "dense"])
def test_sweep_packed_matches_plain(cuda, scene):
    """The packed sweep's kernel against its plain version on the same
    packed rows (relative 1e-5: summation order and rsqrtf; the kernel
    skips pairs that add 0), on settled scenes of 1,080 and 715 particles
    (sentinel tails of 72 and 53 rows), on the pruning rule's stress
    scene (575 particles) and on 2,600 particles in one cell (tiles whose
    ranges the kernel stages in several windows); pad rows exactly 0; the
    descriptor built on the card equals the CPU's; accel_mxu on the card
    against the port's CPU path."""
    if scene == "stress":
        params, host = _stress_packed()
    elif scene == "dense":
        params, host = _dense_packed()
    else:
        params, host = _settled_packed(int(scene),
                                       5 if scene == "1100" else 3)
    n = host[0].shape[0]
    args = [t.to(cuda) for t in host]
    f, cids, order = mxu_sweep.pack(*args, params)
    desc = mxu_sweep.build_desc(cids, f.shape[0], params)
    assert torch.equal(desc.cpu(), mxu_sweep.build_desc(cids.cpu(),
                                                        f.shape[0], params))
    before = dict(_build.launches)
    got = mxu_sweep.sweep_packed(f, cids, desc, params)
    want = mxu_sweep.sweep_packed_plain(f, cids, desc, params)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5
    assert (got[n:] == 0).all()
    want_counts = dict.fromkeys(before, 0)
    want_counts["sweep_packed"] = 1
    assert {k: _build.launches[k] - before[k] for k in before} == want_counts
    acc = mxu_sweep.accel_mxu(*args, params)
    assert _rel(acc, mxu_sweep.accel_mxu(*host, params)) <= 1e-5


def test_sweep_packed_empty_tile_and_refusals(cuda):
    """A query tile whose three ranges are empty gets 0 in both versions
    and leaves the other tiles' results bit for bit; the wrapper refuses
    what the kernel does not take."""
    params, host = _settled_packed(777, 3)
    f, cids, _ = mxu_sweep.pack(*(t.to(cuda) for t in host), params)
    desc = mxu_sweep.build_desc(cids, f.shape[0], params)
    base = mxu_sweep.sweep_packed(f, cids, desc, params)
    cut = desc.clone()
    cut[2, :7] = 0
    got = mxu_sweep.sweep_packed(f, cids, cut, params)
    want = mxu_sweep.sweep_packed_plain(f, cids, cut, params)
    tile = slice(2 * mxu_sweep.TQ, 3 * mxu_sweep.TQ)
    assert (got[tile] == 0).all() and (want[tile] == 0).all()
    rest = torch.ones(f.shape[0], dtype=torch.bool, device=cuda)
    rest[tile] = False
    assert torch.equal(got[rest], base[rest])
    assert _rel(got, want) <= 1e-5
    with pytest.raises(ValueError, match="float32"):
        mxu_sweep.sweep_packed(f.double(), cids, desc, params)
    with pytest.raises(ValueError, match="multiple"):
        mxu_sweep.sweep_packed(f[:-1], cids, desc, params)
    with pytest.raises(ValueError, match="shape"):
        mxu_sweep.sweep_packed(f, cids, desc[:-1], params)
    with pytest.raises(ValueError, match="int32"):
        mxu_sweep.sweep_packed(f, cids.long(), desc, params)
    with pytest.raises(ValueError, match="particles"):
        mxu_sweep.sweep_packed(f, cids[:-mxu_sweep.TQ], desc, params)


SHARD_CASES = ["2d", "3d_collide", "multi_tile"]


@pytest.mark.parametrize("method", ["pallas", "pallas_inc",
                                    "pallas_inc_cont"])
@pytest.mark.parametrize("case", SHARD_CASES)
def test_sharded_on_card_matches_cpu(cuda, case, method):
    """Three steps sharded over 2 slabs of the card (one device twice)
    against the same mesh on the CPU, in scenes whose velocities carry
    particles across cell and slab faces: positions by id relative 1e-5
    and velocities 1e-3 (the run_inc bars), the same counters, ids
    conserved.  The slab force steps run with x_origin != bounds_min[0]
    on slab 1."""
    from gpufluidsimulator_torch.parallel import mesh, sharded
    params, state = _inc_scene(case)
    got = []
    for dev in (cuda, torch.device("cpu")):
        sim = sharded.ShardedSim(params, state, method=method,
                                 mesh=mesh.make_mesh(devices=[dev] * 2))
        sim.step(3)
        g = sim.gather()
        got.append((g.pos.cpu(), g.vel.cpu(),
                    [int(o) for o in sim.sstate.overflow],
                    [int(o) for o in sim.sstate.mig_overflow]))
    (pg, vg, og, mg), (pc, vc, oc, mc) = got
    assert _rel(pg, pc) <= 1e-5
    assert _rel(vg, vc) <= 1e-3
    assert (og, mg) == (oc, mc)


def test_sharded_step_never_waits_for_the_card(cuda):
    """One lock-step pallas_inc step of 3 slabs on the card, and of the
    continuity tier at age 0 and 1, under sync debug mode "error"."""
    from gpufluidsimulator_torch.parallel import mesh as meshmod
    from gpufluidsimulator_torch.parallel import sharded
    params, state = _inc_scene("2d")
    m = meshmod.make_mesh(devices=[cuda] * 3)
    sstate, _ = sharded.distribute(params, state, m)
    params_loc, nxl = sharded.local_params(params, 3)
    geom = pm.geometry(params_loc)
    n_cap = sstate.pos[0].shape[0]
    ex = sharded.make_exchange(m, nxl)
    x0 = {d: sharded.slab_origin(params, nxl, d) for d in range(3)}
    for cont in (False, True):
        s = {d: inc.to_planes(sstate.pos[d], sstate.vel[d], sstate.ids[d],
                              params_loc, geom, x_origin=x0[d],
                              active=sstate.ids[d] >= 0, continuity=cont)
             for d in range(3)}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2 if cont else 1):
                s = meshmod.lockstep({d: inc.step_phases(
                    s[d], params_loc, geom, inc.mover_capacity(n_cap),
                    x_origin=x0[d], exchange=ex, wall_params=params,
                    mig_cap=max(128, n_cap // 64))
                    for d in range(3)})
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert sum(int(v.mig_overflow) for v in s.values()) == 0
