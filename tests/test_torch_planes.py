"""PyTorch port vs JAX package: binning into rank planes, placement,
occupancy bounds and halo lanes, on identical inputs (CPU, plain versions).

Both packages sort unstably, so ranks inside a cell may differ: planes are
compared per cell, keyed by particle id, never slot by slot.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.ops import planes as jpm
from gpufluidsimulator_tpu.ops import route as jroute

from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.ops import planes as tpm
from gpufluidsimulator_torch.ops import route as troute


def _multi_tile_scene():
    """The multi-x-tile setup of tests/test_pallas_vs_naive.py: a domain
    four units wide (n_bx > 1) with fluid straddling x-cell 126."""
    params, _ = jfs.scenes.dam_break(n=900, dim=2, jitter=0.2, seed=5)
    params = params.replace(bounds_min=(0.0, 0.0), bounds_max=(4.0, 1.0))
    assert jpm.geometry(params).n_bx > 1
    bx = 126 * params.cell
    state = jfs.scenes.spawn_box(params, [bx - 0.2, 0.0], [bx + 0.2, 0.25],
                                 jitter=0.2, seed=5)
    return params, state


def _scene(case):
    if case == "multi_tile":
        return _multi_tile_scene()
    dim, n = {"2d": (2, 600), "3d": (3, 1200)}[case]
    return jfs.scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=11)


def _port(jp, js):
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    ts = convert.state_from_numpy(*(np.asarray(a) for a in js),
                                  device="cpu")
    return tp, ts


@pytest.mark.parametrize("case", ["2d", "3d", "multi_tile"])
def test_cell_linear_parts_exact(case):
    jp, js = _scene(case)
    tp, ts = _port(jp, js)
    geom = jpm.geometry(jp)
    # include positions outside the box: both clip into the edge cells
    rng = np.random.default_rng(0)
    extra = rng.uniform(-0.1, 1.1, (64, jp.dim)).astype(np.float32) \
        * np.asarray(jp.bounds_max, np.float32)
    pos = np.concatenate([np.asarray(js.pos), extra])
    want = np.asarray(jpm.cell_linear_parts(jnp.asarray(pos), jp, geom))
    got = tpm.cell_linear_parts(torch.from_numpy(pos), tp,
                                tpm.geometry(tp))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def _per_id(table, n, cells, planes):
    """id -> (cell, field values at its slot), -1 / nan when dropped."""
    ids = np.asarray(table.ids_s)
    slot = np.asarray(table.slot).astype(np.int64)
    ok = np.asarray(table.ok)
    cell = np.full(n, -1, np.int64)
    cell[ids[ok]] = slot[ok] % cells
    flat = planes.reshape(planes.shape[0], -1)
    vals = np.full((n, planes.shape[0]), np.nan, np.float32)
    vals[ids[ok]] = flat[:, slot[ok]].T
    return cell, vals


@pytest.mark.parametrize("case", ["2d", "3d", "multi_tile"])
def test_build_planes_matches(case):
    jp, js = _scene(case)
    tp, ts = _port(jp, js)
    geom = jpm.geometry(jp)
    jt = jpm.build_planes(js.pos, js.vel, js.ids, jp, geom)
    tt = tpm.build_planes(ts.pos, ts.vel, ts.ids, tp, tpm.geometry(tp))
    jplanes = np.asarray(jt.planes)
    tplanes = tt.planes.numpy()
    assert tplanes.shape == jplanes.shape
    assert int(tt.overflow) == int(jt.overflow) == 0
    assert tt.slot.dtype == torch.int32
    # per-cell id multisets and per-id field values
    jc, jv = _per_id(jt, js.n, geom.cells, jplanes)
    tc, tv = _per_id(tt, js.n, geom.cells, tplanes)
    assert np.array_equal(jc, tc)
    assert np.array_equal(jv, tv)
    # the same slots are occupied (ranks are dense from 0, counts per cell
    # agree, halo lanes included) and empty slots hold the same fill
    jvalid = jplanes[0] < jpm.SENTINEL * 0.5
    tvalid = tplanes[0] < tpm.SENTINEL * 0.5
    assert np.array_equal(jvalid, tvalid)
    assert np.array_equal(jplanes[:, ~jvalid], tplanes[:, ~tvalid])
    # slot-sorted particle arrays agree as sets of rows
    o_j = np.argsort(np.asarray(jt.ids_s))
    o_t = np.argsort(tt.ids_s.numpy())
    assert np.array_equal(np.asarray(jt.pos_s)[o_j], tt.pos_s.numpy()[o_t])
    assert np.array_equal(np.asarray(jt.vel_s)[o_j], tt.vel_s.numpy()[o_t])


@pytest.mark.parametrize("case", ["2d", "3d", "multi_tile"])
def test_place_exact_on_identical_inputs(case):
    jp, js = _scene(case)
    geom = jpm.geometry(jp)
    jt = jpm.build_planes(js.pos, js.vel, js.ids, jp, geom)
    dim, n = jp.dim, js.n
    cols = [jt.pos_s[:, j] for j in range(dim)] + \
        [jt.vel_s[:, j] for j in range(dim)]
    rows = jroute.pad_rows(n)
    pad = rows * jpm.LANES - n
    fields2d = [jnp.pad(c, (0, pad)).reshape(rows, jpm.LANES) for c in cols]
    slot2d = jnp.pad(jt.slot, (0, pad), constant_values=geom.k * geom.cells
                     + jroute.LOCAL).reshape(rows, jpm.LANES)
    bases = jnp.arange(jroute.n_tiles(geom) + 1, dtype=jnp.int32) \
        * jroute.TILE
    starts = jnp.searchsorted(jt.slot, bases).astype(jnp.int32)
    want = np.asarray(jroute.place(fields2d, slot2d, starts, geom,
                                   n_pos=dim, use_kernel=False))[:2 * dim]
    fields = torch.from_numpy(np.stack([np.asarray(c) for c in cols]))
    got = troute.place(fields, torch.from_numpy(np.array(jt.slot)),
                       torch.from_numpy(np.array(jt.ok)),
                       tpm.geometry(convert.params_from_dict(
                           dataclasses.asdict(jp))), n_pos=dim)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["2d", "3d", "multi_tile"])
def test_occupancy_exact(case):
    jp, js = _scene(case)
    tp, _ = _port(jp, js)
    geom = jpm.geometry(jp)
    jt = jpm.build_planes(js.pos, js.vel, js.ids, jp, geom)
    planes = torch.from_numpy(np.array(jt.planes))
    want_row = np.asarray(jpm.occ_rowmax(jt.planes[jpm.FIELD_X], geom))
    got_row = tpm.occ_rowmax(planes[tpm.FIELD_X], tpm.geometry(tp))
    assert got_row.dtype == torch.int32
    assert np.array_equal(got_row.numpy(), want_row)
    jq, js_ = jpm.occupancy_bounds(jt.planes, jp, geom)
    tq, ts_ = tpm.occupancy_bounds(planes, tp, tpm.geometry(tp))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts_.numpy(), np.asarray(js_))


@pytest.mark.parametrize("case", ["2d", "3d", "3d_k16", "multi_tile"])
def test_occupancy_bounds_plain_edges_match_jax(case):
    """occupancy_bounds' plain branch against JAX occupancy_bounds on
    hand-built x planes (ranks dense, numpy-seeded sparse counts), with a
    cell at K in row y0-1 of the first interior 8-row block and one in row
    y0+8 of the last (ghost rows: in the slab, in no block's occ_q) and, in
    3D, one in each z-ghost plane (seen only through occ_s's z-1 / z+1
    entries): the slab and z-shift logic that the kernel reproduces."""
    jp, _ = _scene("3d" if case.startswith("3d") else case)
    if case == "3d_k16":
        jp = jp.replace(cell_capacity=16)
    geom = jpm.geometry(jp)
    k = geom.k
    assert geom.n_by >= 2
    rng = np.random.default_rng(6)
    shape = (geom.pz, geom.n_bx, geom.py, jpm.LANES)
    counts = np.where(rng.random(shape) < 0.02,
                      rng.integers(1, k // 2 + 1, shape), 0)
    rb = jpm.ROWS_PER_BLOCK
    z_in = 1 if geom.dim == 3 else 0
    counts[z_in, 0, rb - 1, 5] = k              # y0-1 of the first block
    counts[z_in, -1, (geom.n_by + 1) * rb, 60] = k   # y0+8 of the last
    if geom.dim == 3:
        counts[0, 0, rb + 3, 7] = k             # z ghost planes
        counts[-1, 0, 2 * rb + 2, 9] = k
    x = np.where(np.arange(k).reshape(k, 1, 1, 1, 1) < counts[None],
                 np.float32(0.5), np.float32(jpm.SENTINEL))[None]
    jq, js_ = jpm.occupancy_bounds(jnp.asarray(x), jp, geom)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    planes = torch.from_numpy(x)
    tq, ts_ = tpm.occupancy_bounds(planes, tp, tpm.geometry(tp))
    pq, ps = tpm.occupancy_bounds_plain(planes, tp, tpm.geometry(tp))
    for got in ((tq, ts_), (pq, ps)):
        assert np.array_equal(got[0].numpy(), np.asarray(jq))
        assert np.array_equal(got[1].numpy(), np.asarray(js_))
    # the planted cells reach the slab but not occ_q
    assert int(ts_.max()) == k and int(tq.max()) < k


def test_halo_x_exact_multi_tile():
    jp, _ = _multi_tile_scene()
    geom = jpm.geometry(jp)
    assert geom.n_bx > 1
    rng = np.random.default_rng(2)
    arr = rng.standard_normal((2, geom.k, geom.pz, geom.n_bx, geom.py,
                               jpm.LANES)).astype(np.float32)
    want = np.asarray(jpm.halo_x(jnp.asarray(arr)))
    got = tpm.halo_x(torch.from_numpy(arr.copy()))
    assert np.array_equal(got.numpy(), want)
    one = torch.from_numpy(arr[:, :, :, :1].copy())
    assert tpm.halo_x(one) is one            # n_bx == 1: no-op


def test_interior_mask_covers_every_binned_cell():
    jp, js = _multi_tile_scene()
    tp, ts = _port(jp, js)
    geom = tpm.geometry(tp)
    cid = tpm.cell_linear_parts(ts.pos, tp, geom).long()
    mask = tpm.interior_mask(geom).reshape(-1)
    assert bool(mask[cid].all())
    # the interior is exactly nx * ny (* nz) cells
    assert int(mask.sum()) == int(np.prod(tp.grid_res))
