"""PyTorch port vs JAX package: the packed-pair force sweep
(``ops/mxu_sweep.py``) on the CPU with identical inputs.

The kernel's pruning rule (``group_segments``: each query group walks
only its own stencil rows inside its tile's ranges) is held on the settled
scenes and on a scene made to stress it: the segments cover every pair
inside the support, lie inside the ranges, and give the full ranges' sum;
and on pairs two cells apart but closer than h (cells inside halfwidth 1's
tolerance, binned across a face), which alone it leaves out.

Packing and the descriptor are exact: the packed rows, sorted cell ids,
sort order and candidate ranges equal the reference's, and so do the slot
table and its padding accounting.  The port's acceleration (its plain
version here) is held within 2e-5 relative to the largest magnitude of the
reference's, in both of its reduction variants ("vpu" and "mxu", Pallas
interpret mode as ``tests/test_mxu_sweep.py`` runs them), and of the port's
all-pairs acceleration less gravity: the bound that
``tests/test_mxu_sweep.py`` holds the reference to.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.models import solver as jsolver
from gpufluidsimulator_tpu.ops import mxu_sweep as jmxu
from gpufluidsimulator_tpu.ops import naive as jnaive
from gpufluidsimulator_tpu.ops import physics as jphysics

import gpufluidsimulator_torch as ft
from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.ops import grid as tgrid
from gpufluidsimulator_torch.ops import mxu_sweep as tmxu
from gpufluidsimulator_torch.ops import naive as tnaive
from gpufluidsimulator_torch.ops import physics as tphysics
from test_torch_cuda import _stress_packed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share the host: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _settled(n, steps=5, seed=3):
    """tests/test_mxu_sweep.py's input: a 3D dam break settled by a few
    all-pairs steps, with its summation density and pressure.  Returns the
    reference's params and arrays, and the port's."""
    jp, js = jfs.scenes.dam_break(n=n, dim=3, jitter=0.3, seed=seed)
    js = jsolver.run(js, jp, steps, method="naive")
    rho = jnaive.density_naive(js.pos, jp)
    pres = jphysics.eos_pressure(rho, jp)
    arrs = [np.array(a) for a in (js.pos, js.vel, rho, pres)]
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    return jp, arrs, tp, [torch.from_numpy(a) for a in arrs]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


@pytest.mark.parametrize("request_n", [1100, 777])
def test_pack_and_desc_exact(request_n):
    jp, arrs, tp, targs = _settled(request_n, steps=3)
    n = arrs[0].shape[0]
    assert n % tmxu.TQ
    f_j, _, cids_j, order_j = jmxu.pack(*arrs, jp)
    f_t, cids_t, order_t = tmxu.pack(*targs, tp)
    assert np.array_equal(f_t.numpy(), np.asarray(f_j))
    assert np.array_equal(cids_t.numpy(), np.asarray(cids_j))
    assert np.array_equal(order_t.numpy(), np.asarray(order_j))
    npad = f_t.shape[0]
    assert npad % tmxu.TQ == 0 and npad - n < tmxu.TQ
    desc_j, max_slots = jmxu.build_desc(np.asarray(cids_j), npad, jp)
    desc_t = tmxu.build_desc(cids_t, npad, tp)
    assert desc_t.dtype == torch.int32
    assert np.array_equal(desc_t.numpy(), desc_j)
    assert int(desc_t[:, 6].max()) == max_slots
    # the sentinel tail: pad rows far away with zero fields, and no range
    # reaches them
    assert (f_t[n:, :3] == tmxu.SENTINEL).all() and (f_t[n:, 3:] == 0).all()
    assert int(desc_t[:, :6].max()) <= n


def test_slot_table_and_stats_equal():
    jp, arrs, tp, targs = _settled(900, steps=2)
    _, _, cids_j, _ = jmxu.pack(*arrs, jp)
    cids = np.asarray(cids_j)
    npad = -(-len(cids) // jmxu.TQ) * jmxu.TQ
    desc, _ = jmxu.build_desc(cids, npad, jp)
    for a, b in zip(tmxu.slot_table(desc), jmxu.slot_table(desc)):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert tmxu.table_stats(cids, npad, tp) == jmxu.table_stats(cids, npad,
                                                                jp)


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_accel_mxu_matches_jax(variant):
    jp, arrs, tp, targs = _settled(1100)
    want = np.asarray(jmxu.accel_mxu(*arrs, jp, variant=variant))
    got = tmxu.accel_mxu(*targs, tp).numpy()
    assert _rel(got, want) < 2e-5
    naive = tnaive.accel_naive(*targs, tp) - torch.tensor(tp.gravity)
    assert _rel(got, naive.numpy()) < 2e-5


def test_tail_and_chunked_plain(monkeypatch):
    """715 particles, not a multiple of 128: the last tile's pad queries
    get 0 and its real queries match the all-pairs acceleration; chunks of
    7 slots give the result of one chunk."""
    jp, arrs, tp, targs = _settled(777, steps=3)
    n = arrs[0].shape[0]
    f, cids, _ = tmxu.pack(*targs, tp)
    desc = tmxu.build_desc(cids, f.shape[0], tp)
    whole = tmxu.sweep_packed(f, cids, desc, tp)
    assert whole.shape == (f.shape[0], 3) and f.shape[0] > n
    assert (whole[n:] == 0).all() and (whole[:n] != 0).any(dim=1).all()
    monkeypatch.setattr(tmxu, "PLAIN_TEMP_BYTES",
                        7 * tmxu._PLAIN_TEMPS * tmxu.TC * tmxu.TQ * 4)
    chunked = tmxu.sweep_packed(f, cids, desc, tp)
    assert _rel(chunked.numpy(), whole.numpy()) <= 1e-6
    got = tmxu.accel_mxu(*targs, tp)
    naive = tnaive.accel_naive(*targs, tp) - torch.tensor(tp.gravity)
    assert _rel(got.numpy(), naive.numpy()) < 2e-5


def test_refuses_stencils_the_descriptor_cannot_cover():
    """build_desc's three ranges assume halfwidth 1 in 3D: 2D and a 3D
    cell_aniso grid with x cells of 0.5 h (x halfwidth 2) raise."""
    _, arrs, tp, targs = _settled(300, steps=1)
    f, cids, _ = tmxu.pack(*targs, tp)
    p2, _ = jfs.scenes.dam_break(n=300, dim=2)
    tp2 = convert.params_from_dict(dataclasses.asdict(p2))
    with pytest.raises(ValueError, match="3D"):
        tmxu.build_desc(cids, f.shape[0], tp2)
    aniso = tp.replace(cell_aniso=(0.5 * tp.h, tp.h, tp.h))
    with pytest.raises(ValueError, match="halfwidth"):
        tmxu.build_desc(cids, f.shape[0], aniso)
    with pytest.raises(ValueError, match="halfwidth"):
        tmxu.accel_mxu(*targs, aniso)


@functools.lru_cache(maxsize=None)
def _packed_scene(name):
    """(params, F, cids, desc, n) of a scene, packed.  The stress scene is
    tests/test_torch_cuda.py's (it imports nothing of JAX)."""
    if name == "stress":
        tp, targs = _stress_packed()
    else:
        _, _, tp, targs = _settled(*{"settled_1080": (1100, 5),
                                     "settled_715": (777, 3)}[name])
    f, cids, _ = tmxu.pack(*targs, tp)
    return tp, f, cids, tmxu.build_desc(cids, f.shape[0], tp), len(cids)


def _segment_mask(f, cids, desc, params):
    """(Npad, n) bool: the candidates of each query's group segments;
    asserts the segments disjoint and inside the tile's desc ranges."""
    npad, n = f.shape[0], cids.shape[0]
    grp, lo, hi = tmxu.group_segments(cids, desc, params)
    assert len(grp) and (lo < hi).all()
    d = desc.to(torch.int64)[grp * tmxu.GROUP // tmxu.TQ]
    inside = torch.zeros_like(lo, dtype=torch.bool)
    for r in range(3):
        inside |= (d[:, 2 * r] <= lo) & (hi <= d[:, 2 * r + 1])
    assert inside.all()
    mask = torch.zeros((npad, n), dtype=torch.bool)
    for g, a, b in zip(grp.tolist(), lo.tolist(), hi.tolist()):
        rows = mask[g * tmxu.GROUP:(g + 1) * tmxu.GROUP]
        assert not rows[0, a:b].any(), "segments overlap"
        rows[:, a:b] = True
    return mask


def _desc_mask(desc, npad, n):
    """(Npad, n) bool: the candidates of each query's tile's desc ranges."""
    d = desc.to(torch.int64).repeat_interleave(tmxu.TQ, 0)[:npad]
    j = torch.arange(n)
    out = torch.zeros((npad, n), dtype=torch.bool)
    for r in range(3):
        out |= (d[:, 2 * r, None] <= j) & (j < d[:, 2 * r + 1, None])
    return out


def _sweep_masked(f, n, mask, params):
    """sweep_packed_plain's pair terms over the (Npad, n) candidate mask."""
    k1, k2 = tmxu._constants(params)
    q, c = f[:, None, :], f[None, :n, :]
    dd = [q[..., a] - c[..., a] for a in range(3)]
    r2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
    rinv = torch.rsqrt(torch.clamp_min(r2, 1e-24))
    d = torch.clamp_min(params.h - r2 * rinv, 0.0)
    live = mask & (r2 > 1e-16)
    coefp = torch.where(live, k1 * (c[..., 6] + q[..., 6]) * (d * d) * rinv,
                        0.0)
    coefv = torch.where(live, k2 * (c[..., 7] * q[..., 7]) * d, 0.0)
    return torch.stack([torch.sum(coefp * dd[a]
                                  + coefv * (c[..., 3 + a] - q[..., 3 + a]),
                                  dim=1) for a in range(3)], dim=-1)


@pytest.mark.parametrize("scene", ["settled_1080", "settled_715", "stress"])
def test_group_segments_rule(scene):
    """The kernel's candidates on each scene: the row segments
    (group_segments) disjoint and inside the tile's desc ranges; they, and
    the rows of them near the group's bounding box (group_candidates), cover
    every pair with r^2 in (1e-16, h^2), and the plain sweep over either
    equals sweep_packed_plain over the full ranges within 1e-6 of the
    largest |a|.  The stress scene has groups that span a y-row wrap and a
    z-plane wrap, and a cell of more than 128 particles."""
    params, f, cids, desc, n = _packed_scene(scene)
    npad = f.shape[0]
    mask = _segment_mask(f, cids, desc, params)
    # every pair inside the support lies in its query's group segments
    p = f[:n, :3]
    dd = p[:, None, :] - p[None, :, :]
    r2 = (dd * dd).sum(-1)
    support = (r2 > 1e-16) & (r2 < params.h * params.h)
    assert int(support.sum()) > n
    assert not (support & ~mask[:n]).any()
    want = tmxu.sweep_packed_plain(f, cids, desc, params)
    got = _sweep_masked(f, n, mask, params)
    assert _rel(got.numpy(), want.numpy()) <= 1e-6
    cg, cj = tmxu.group_candidates(f, cids, desc, params)
    near = torch.zeros_like(mask)
    for g in range(-(-npad // tmxu.GROUP)):
        near[g * tmxu.GROUP:(g + 1) * tmxu.GROUP, cj[cg == g]] = True
    assert not (near & ~mask).any() and near.sum() < mask.sum()
    assert not (support & ~near[:n]).any()
    got = _sweep_masked(f, n, near, params)
    assert _rel(got.numpy(), want.numpy()) <= 1e-6
    if scene == "stress":
        assert int((cids == torch.mode(cids).values).sum()) > tmxu.TQ
        rows = cids.to(torch.int64) // tgrid.strides(params)[1]
        planes = cids.to(torch.int64) // tgrid.strides(params)[2]
        per = torch.arange(n) // tmxu.GROUP
        spans_row = spans_plane = False
        for g in range(per.max() + 1):
            sel = per == g
            spans_plane |= len(torch.unique(planes[sel])) > 1
            spans_row |= len(torch.unique(rows[sel])) > len(
                torch.unique(planes[sel]))
        assert spans_row and spans_plane


def _face_scene(axis, seed=7):
    """Pairs two cells apart on ``axis`` and closer than h.  The cells are
    h (1 - 9e-7) wide, which ``grid.halfwidths`` still takes as halfwidth
    1; at each face k, the query is the lowest float32 that
    ``grid.cell_id`` bins into cell k and its partner the highest it bins
    into cell k - 2, their other coordinates at distinct cell centres.
    Seven more particles (numpy-seeded) share each one's cell, on its far
    side, so that each query group of 8 is one cell."""
    params, _ = ft.scenes.dam_break(n=4096, dim=3, device="cpu")
    params = params.replace(cell_size=params.h * (1.0 - 9e-7))
    cs, st = params.cell, tgrid.strides(params)
    pr = tgrid.padded_res(params)
    rng = np.random.default_rng(seed)
    fill = tmxu.GROUP - 1
    pos = []
    for i, k in enumerate(range(2, 12)):
        centre = np.array([(2 + i + 4 * a) % 16 + 0.5 for a in range(3)])
        for face, cell, pick, far in ((k, k, np.min, (0.5, 0.95)),
                                      (k - 1, k - 2, np.max, (0.05, 0.5))):
            x = np.float32(face * cs)
            x = x + np.arange(-24, 25, dtype=np.float32) * np.spacing(x)
            p = np.tile((centre * cs).astype(np.float32), (len(x), 1))
            p[:, axis] = x
            c = tgrid.cell_id(torch.from_numpy(p), params).long()
            x = x[((c // st[axis]) % pr[axis] - 1).numpy() == cell]
            others = centre + rng.uniform(-0.4, 0.4, (fill, 3))
            others[:, axis] = cell + rng.uniform(*far, fill)
            pos += [np.concatenate([p[:1], others * cs]).astype(np.float32)]
            pos[-1][0, axis] = pick(x)
    pos = torch.from_numpy(np.concatenate(pos))
    vel = torch.from_numpy(rng.normal(0.0, 0.5, pos.shape).astype(np.float32))
    rho = tnaive.density_naive(pos, params)
    return params, [pos, vel, rho, tphysics.eos_pressure(rho, params)]


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_group_segments_leave_out_only_pairs_across_a_face(axis):
    """The rows that group_segments leaves out are two or more cells from
    the group's queries on some axis.  With cells a little narrower than h
    (inside halfwidth 1's tolerance) or a position binned across a face by
    float32 rounding, such a pair can be closer than h: on a scene of
    pairs across faces of ``axis``, the plain version (whole ranges) sums
    some that the segments leave out.  Every support pair left out is two
    or more cells apart with d = h - r at most 1e-6 h, and the plain sweep
    over the segments equals sweep_packed_plain within 1e-6 of the largest
    |a|."""
    params, targs = _face_scene(axis)
    f, cids, _ = tmxu.pack(*targs, params)
    desc = tmxu.build_desc(cids, f.shape[0], params)
    npad, n = f.shape[0], cids.shape[0]
    mask = _segment_mask(f, cids, desc, params)
    # d as sweep_packed_plain computes it
    p = f[:n, :3]
    dd = p[:, None, :] - p[None, :, :]
    r2 = (dd * dd).sum(-1)
    d = torch.clamp_min(
        params.h - r2 * torch.rsqrt(torch.clamp_min(r2, 1e-24)), 0.0)
    support = (r2 > 1e-16) & (d > 0)
    left = support & ~mask[:n]
    assert (left & _desc_mask(desc, npad, n)[:n]).any()
    st = tgrid.strides(params)
    c = cids.to(torch.int64)
    cell = torch.stack([c % st[1], c // st[1] % (st[2] // st[1]),
                        c // st[2]], 1)
    apart = (cell[:, None, :] - cell[None, :, :]).abs().amax(-1)
    assert (apart[left] >= 2).all()
    assert (d[left] <= 1e-6 * params.h).all()
    want = tmxu.sweep_packed_plain(f, cids, desc, params)
    got = _sweep_masked(f, n, mask, params)
    assert _rel(got.numpy(), want.numpy()) <= 1e-6
