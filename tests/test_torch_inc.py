"""PyTorch port vs JAX package: the incremental path (``pallas_inc``) on the
CPU.

The same inputs, made with numpy, go through the JAX function and its port
counterpart.  The JAX side runs as ``tests/test_inc.py`` runs it here:
Pallas interpret mode for the sweeps, ``compact_flagged``'s host path and
``consolidate_jnp``.  The port runs with ``device="cpu"``, where each kernel
wrapper takes its plain PyTorch version.  Both packages sort unstably and
order compacted rows differently (slot order vs two-level tile order), so
rows are compared keyed by id and planes per cell keyed by id.

Tolerances (relative to the largest magnitude), and why:
  * fused force step, one step on the same planes: pos 1e-6, vel 1e-4 —
    the pair sums run in another order (the sweeps' own bounds);
  * flags: equal, except on slots whose post-step position lies within
    1e-5 of a cell face in either package (a rounding apart);
  * run_inc over 2-3 steps: pos 1e-5, vel 1e-3 — the summation-order
    differences compound over steps;
  * port pallas_inc vs port pallas over 30 steps: atol pos 5e-4, vel 5e-3,
    the bounds of the reference's own test (tests/test_inc.py:343-358);
  * compaction, the arrival grouping and consolidation move values without
    arithmetic: exact.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.ops import inc as jinc
from gpufluidsimulator_tpu.ops import pallas_sph as jsph
from gpufluidsimulator_tpu.ops import planes as jpm

import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.models import solver as tsolver
from gpufluidsimulator_torch.ops import inc as tinc
from gpufluidsimulator_torch.ops import planes as tpm
from gpufluidsimulator_torch.ops import sph as tsph

NEAR_FACE = 1e-5     # in cells: flags may differ this close to a face


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of small ops; with several test
    processes on one host, torch's intra-op thread pools oversubscribe the
    cores and each op waits on its pool's barrier (30 steps of 2D n=900
    took 126 s instead of 1 s).  One thread per process avoids that."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


def _port(jp, js):
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    ts = convert.state_from_numpy(*(np.asarray(a) for a in js),
                                  device="cpu")
    return tp, ts


def _aligned(state):
    o = np.argsort(np.asarray(state.ids))
    return np.asarray(state.pos)[o], np.asarray(state.vel)[o]


def _cell_id_sets(fields6, idp, geom):
    """{cell: frozenset(ids)} over the valid interior slots."""
    valid = (np.asarray(fields6[0]) < jpm.SENTINEL * 0.5) \
        & np.asarray(jinc.interior_mask(geom))[None]
    k = valid.shape[0]
    flat_v = valid.reshape(k, -1)
    flat_i = np.asarray(idp).reshape(k, -1)
    return {int(c): frozenset(int(flat_i[r, c]) for r in range(k)
                              if flat_v[r, c])
            for c in np.nonzero(flat_v.any(axis=0))[0]}


def _collide_scene():
    """3D double dam break (n=1,200) with numpy-seeded particles inside the
    box pillar and the sphere, and a velocity field that carries particles
    through the walls and across cell faces in one step."""
    jp, js = jfs.scenes.double_dam_break(n=1200, dim=3)
    rng = np.random.default_rng(5)
    pos = np.array(js.pos)
    n = pos.shape[0]
    (_, bc, bh), (_, sc, sr) = jp.obstacles
    pick = rng.choice(n, 48, replace=False)
    pos[pick[:24]] = np.asarray(bc) + rng.uniform(-0.8, 0.8, (24, 3)) \
        * np.asarray(bh)
    d = rng.normal(size=(24, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos[pick[24:]] = np.asarray(sc) + d * sr * rng.uniform(0.2, 0.9, (24, 1))
    vel = rng.normal(size=(n, 3)) * (0.3 * jp.cell / jp.dt)
    state = js._replace(pos=jnp.asarray(pos, jnp.float32),
                        vel=jnp.asarray(vel, jnp.float32))
    return jp, state


def _near_face(p, params):
    """(..., per axis planes) -> slots within NEAR_FACE cells of a face."""
    near = np.zeros(p[0].shape, bool)
    for d in range(params.dim):
        u = (p[d] - params.bounds_min[d]) / params.cells_axis[d]
        near |= np.abs(u - np.round(u)) < NEAR_FACE
    return near


@pytest.mark.parametrize("case", ["2d", "3d_collide"])
def test_force_step_matches_jax(case):
    """The fused force step against JAX accel_planes(fuse_integrate=True,
    emit_movers=True) on the same JAX-built planes and density."""
    if case == "2d":
        jp, js = jfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11)
    else:
        jp, js = _collide_scene()
    geom = jpm.geometry(jp)
    s = jinc.to_planes(js.pos, js.vel, js.ids, jp, geom)
    p6 = jpm.halo_x(s.fields6)
    occ_q, occ_s = jpm.occupancy_bounds(p6, jp, geom)
    rho = jpm.halo_x(jsph.density_planes(p6[:3], occ_q, occ_s, jp, geom))
    new6_j, flag_j = jsph.accel_planes(p6, rho, occ_q, occ_s, jp, geom,
                                       fuse_integrate=True,
                                       emit_movers=True)
    new6_j, flag_j = np.asarray(new6_j), np.asarray(flag_j) > 0.5

    tp = convert.params_from_dict(dataclasses.asdict(jp))
    tgeom = tpm.geometry(tp)
    pi = convert.planes_from_numpy(p6, np.zeros(0), np.zeros(0), occ_q,
                                   occ_s, device="cpu")
    new6, flagp = tsph.accel_step(pi.planes, torch.from_numpy(np.array(rho)),
                                  pi.occ_q, pi.occ_s, tp, tgeom)
    new6_t, flag_t = new6.numpy(), flagp.numpy() > 0.5

    inter = np.asarray(jinc.interior_mask(geom))[None]
    valid = (np.asarray(p6[0]) < jpm.SENTINEL * 0.5) & inter
    assert valid.sum() == js.n
    assert _rel(new6_t[:3, valid], new6_j[:3, valid]) <= 1e-6
    assert _rel(new6_t[3:, valid], new6_j[3:, valid]) <= 1e-4
    # every other slot: sentinel positions, zero velocities and flags
    assert (new6_t[:3, ~valid] == tpm.SENTINEL).all()
    assert not new6_t[3:, ~valid].any() and not flag_t[~valid].any()

    near = _near_face(new6_t[:3], tp) | _near_face(new6_j[:3], tp)
    differ = (flag_t != flag_j) & valid
    assert not (differ & ~near).any()
    n_moved = int(flag_t.sum())
    assert n_moved >= (1 if case == "2d" else 0.01 * js.n)
    # the flag plane is the standalone detection on the port's own planes
    _, _, flags = tinc.detect_movers(new6, torch.zeros_like(flagp), tp,
                                     tgeom)
    assert torch.equal(flags, flagp > 0.5)
    if case == "3d_collide":
        p = new6_t[:3, valid]
        lo, hi = np.asarray(tp.bounds_min), np.asarray(tp.bounds_max)
        assert ((p == lo[:, None]) | (p == hi[:, None])).any(axis=0).sum() \
            > 10, "walls not hit"
        (_, bc, bh), (_, sc, sr) = tp.obstacles
        q = np.asarray(p6)[:3, valid]
        in_box = (np.abs(q - np.asarray(bc)[:, None])
                  < np.asarray(bh)[:, None]).all(axis=0)
        in_sph = np.linalg.norm(q - np.asarray(sc)[:, None], axis=0) < sr
        assert in_box.sum() >= 10 and in_sph.sum() >= 10


def _planes_2d(n=600, seed=3, **kw):
    jp, js = jfs.scenes.dam_break(n=n, dim=2, jitter=0.3, seed=seed)
    if kw:
        jp = jp.replace(**kw)
    geom = jpm.geometry(jp)
    return jp, js, geom, jinc.to_planes(js.pos, js.vel, js.ids, jp, geom)


def test_to_planes_matches_jax():
    """build_planes(with_ids=True): the id channel in the same cells."""
    jp, js, geom, s = _planes_2d()
    tp, ts = _port(jp, js)
    got = tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, tpm.geometry(tp))
    assert got.fields6.shape == s.fields6.shape
    assert _cell_id_sets(got.fields6.numpy(), got.idp.numpy(), geom) \
        == _cell_id_sets(s.fields6, s.idp, geom)
    assert int(got.overflow) == int(s.overflow) == 0


@pytest.mark.parametrize("cap", [None, 50])
def test_compact_matches_jax(cap):
    """Random flags at 30% of the valid slots: the same rows keyed by id,
    the same count; with cap below the count, cap rows, all flagged."""
    jp, js, geom, s = _planes_2d()
    rng = np.random.default_rng(0)
    valid = np.asarray((s.fields6[0] < jpm.SENTINEL * 0.5)
                       & jinc.interior_mask(geom)[None])
    flags = valid & (rng.random(valid.shape) < 0.3)
    n_flag = int(flags.sum())
    ts = convert.inc_state_from_numpy(s.fields6, s.idp, s.overflow,
                                      device="cpu")
    vals, m, total = tinc.compact([*ts.fields6, ts.idp],
                                  torch.from_numpy(flags.astype(np.float32)),
                                  cap or tinc._round_tile(js.n))
    assert int(total) == n_flag
    vals = vals.numpy()
    if cap is None:
        ref, m_ref = jinc.compact_flagged([s.fields6, s.idp],
                                          jnp.asarray(flags),
                                          jinc._round_tile(js.n),
                                          use_kernel=False)
        assert int(m) == int(m_ref) == n_flag
        ref = np.asarray(ref)

        def rows(v):
            return {int(r[6]): tuple(r) for r in v[:, :n_flag].T}
        assert rows(vals) == rows(ref)
        assert not vals[:, n_flag:].any()
    else:
        assert n_flag > cap and int(m) == cap
        by_id = {int(i): tuple(np.asarray(s.fields6)[:, r, z, x, y, lane])
                 for r, z, x, y, lane in zip(*np.nonzero(flags))
                 for i in [np.asarray(s.idp)[r, z, x, y, lane]]}
        for row in vals.T:
            assert by_id[int(row[6])] == tuple(row[:6])


def test_compact_chunks_and_scratch(monkeypatch):
    """The CUDA compact's host side: ceil(m / 4,096) chunks (a partial last
    one included), a whole number of float4 loads per chunk, and the
    scratch (ticket, epoch, a 64-bit status word per chunk): made zeroed,
    reused by every call that fits it (the kernel resets it itself), made
    anew and zeroed when a call needs more chunks."""
    monkeypatch.setattr(tinc, "_compact_scratch", {})
    chunk = tinc.COMPACT_CHUNK
    assert chunk % 4 == 0
    jp, js, geom, _ = _planes_2d()
    kc = geom.k * geom.cells
    for m, nb in ((0, 0), (1, 1), (chunk, 1), (chunk + 1, 2),
                  (kc, -(-kc // chunk))):
        assert tinc.compact_chunks(m) == nb
    assert kc % 128 == 0
    first = tinc.compact_scratch("cpu", 3)
    assert first.dtype == torch.int32 and first.numel() == 2 + 2 * 3
    assert not first.any()
    first[0] = 5
    assert tinc.compact_scratch("cpu", 2) is first
    grown = tinc.compact_scratch("cpu", 10)
    assert grown is not first and grown.numel() == 2 + 2 * 10
    assert not grown.any()
    assert tinc.compact_scratch(torch.device("cpu"), 10) is grown


def _perturbed(jp, js, geom, s, seed=1):
    """Push the plane positions by up to 0.7 cells (numpy-seeded) so a
    real fraction change cell -> (fields6, flags) as numpy."""
    rng = np.random.default_rng(seed)
    delta = (rng.random(np.asarray(js.pos).shape) - 0.5) * 1.4 * jp.cell
    new_pos = np.clip(np.asarray(js.pos) + delta, jp.bounds_min,
                      jp.bounds_max).astype(np.float32)
    ids = np.asarray(s.idp).astype(np.int64)
    valid = np.asarray((s.fields6[0] < jpm.SENTINEL * 0.5)
                       & jinc.interior_mask(geom)[None])
    f6 = np.array(s.fields6)
    for d in range(jp.dim):
        f6[d][valid] = new_pos[ids[valid], d]
    _, _, flags = jinc.detect_movers(jnp.asarray(f6), s.idp, jp, geom)
    return f6, np.asarray(flags)


@pytest.mark.parametrize("k", [8, 2])
def test_consolidate_matches_jax(k):
    """The same planes, flags and movers into the port's arrival_planes +
    consolidate and into JAX arrival_planes + consolidate_jnp: the same ids
    in every cell and the same drop count; cell_capacity=2 forces drops
    (counts compared only).  The port's ranks come out dense."""
    jp, js, geom, s = _planes_2d(n=900, cell_capacity=k)
    f6, flags = _perturbed(jp, js, geom, s)
    flagp = flags.astype(np.float32)
    m_cap = jinc.mover_capacity(js.n)
    movers, m = jinc.compact_flagged([jnp.asarray(f6), s.idp],
                                     jnp.asarray(flags), m_cap,
                                     use_kernel=False)
    assert int(m) == int(flags.sum()) > 20
    arr, live_t, lost_dup = jinc.arrival_planes(movers, m, jp, geom)
    dense = np.asarray(arr)[:, :-1].reshape(7, jinc.ARRIVAL_K, geom.pz,
                                           geom.n_bx, geom.py, jpm.LANES)
    ref6, refid, lost_rank = jinc.consolidate_jnp(
        jnp.asarray(f6), s.idp, jnp.asarray(flagp), jnp.asarray(dense), geom)
    want_drop = int(lost_dup) + int(lost_rank)

    tp = convert.params_from_dict(dataclasses.asdict(jp))
    tgeom = tpm.geometry(tp)
    tarr = tinc.arrival_planes(torch.from_numpy(np.array(movers)),
                               torch.tensor(int(m), dtype=torch.int32), tp,
                               tgeom)
    got6, gotid, dropped = tinc.consolidate(
        torch.from_numpy(f6), torch.from_numpy(np.array(s.idp)),
        torch.from_numpy(flagp), tarr, tgeom)
    assert int(dropped) == want_drop
    valid = got6[0].numpy() < tpm.SENTINEL * 0.5
    counts = valid.sum(axis=0)
    assert (valid == (np.arange(k)[:, None, None, None, None]
                      < counts[None])).all(), "ranks are not dense"
    assert (gotid.numpy()[~valid] == -1).all()
    if k == 2:
        assert want_drop > 0
        return
    assert want_drop == 0
    assert _cell_id_sets(got6.numpy(), gotid.numpy(), geom) \
        == _cell_id_sets(ref6, refid, geom)
    # the values travel with their ids
    got_rows = {int(i): tuple(got6.numpy()[:, r, z, x, y, lane])
                for r, z, x, y, lane in zip(*np.nonzero(valid))
                for i in [gotid.numpy()[r, z, x, y, lane]]}
    ref_v = np.asarray(ref6)[0] < jpm.SENTINEL * 0.5
    for r, z, x, y, lane in zip(*np.nonzero(ref_v)):
        i = int(np.asarray(refid)[r, z, x, y, lane])
        assert got_rows[i] == tuple(np.asarray(ref6)[:, r, z, x, y, lane])


def test_consolidate_hand_built_matches_jax():
    """Hand-built 2D planes and movers through the port's arrival_planes +
    consolidate and JAX arrival_planes + consolidate_jnp.  Cell A holds 3
    particles and its rank 1 departs (to cell D); cell B holds K - 2 and
    receives 4 arrivals, so it fills to K and 2 are dropped; cell C
    receives ARRIVAL_K + 3 (3 dropped).  The same drop count; ranks dense;
    every slot's values are its id's values; where the outcome is fixed
    (A, D, B's kept ranks) the same ids at the same ranks; where the
    unstable sorts choose (B's arrivals, C), the same number taken from the
    same arrivals."""
    jp, _ = jfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11)
    geom = jpm.geometry(jp)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    k, a_k = geom.k, jinc.ARRIVAL_K
    lo, size = np.asarray(jp.bounds_min), np.asarray(jp.cells_axis)
    rng = np.random.default_rng(8)
    cell_a, cell_b, cell_c, cell_d = (3, 4), (10, 5), (20, 6), (30, 7)
    assert geom.nx > 30 and geom.ny > 7 and k == a_k == 8

    def lin(xy):
        x, y = xy
        return ((x // 126) * geom.py + y + 8) * jpm.LANES + x % 126 + 1

    def rows(xy, ids):
        """(7, len(ids)) particles inside cell xy: x, y, z=0, vx, vy, 0, id"""
        out = np.zeros((7, len(ids)), np.float32)
        out[:2] = (lo + (np.asarray(xy) + rng.uniform(0.1, 0.9,
                                                      (len(ids), 2)))
                   * size).T
        out[3:5] = rng.normal(size=(2, len(ids)))
        out[6] = ids
        return out

    held = {cell_a: rows(cell_a, [0, 1, 2]),
            cell_b: rows(cell_b, list(range(3, 3 + k - 2)))}
    f6 = np.zeros((6, k, geom.pz, geom.n_bx, geom.py, jpm.LANES),
                  np.float32)
    f6[:2] = jpm.SENTINEL
    idp = np.zeros(f6.shape[1:], np.float32)
    flagp = np.zeros(f6.shape[1:], np.float32)
    flat6, flat_id = f6.reshape(6, k, -1), idp.reshape(k, -1)
    for xy, r in held.items():
        flat6[:, :r.shape[1], lin(xy)] = r[:6]
        flat_id[:r.shape[1], lin(xy)] = r[6]
    flagp.reshape(k, -1)[1, lin(cell_a)] = 1.0
    departed = held[cell_a][:, 1:2].copy()
    departed[:2, 0] = (lo + (np.asarray(cell_d) + 0.5) * size)
    arrivals = [departed, rows(cell_b, range(100, 104)),
                rows(cell_c, range(200, 200 + a_k + 3))]
    m = sum(a.shape[1] for a in arrivals)
    movers = np.zeros((7, jinc.mover_capacity(600)), np.float32)
    movers[:, :m] = rng.permutation(np.concatenate(arrivals, axis=1).T).T
    by_id = {int(i): r[:, j] for r in held.values()
             for j, i in enumerate(r[6])}
    by_id.update({int(i): movers[:, j] for j, i in enumerate(movers[6, :m])})

    arr, _, lost_dup = jinc.arrival_planes(jnp.asarray(movers),
                                           jnp.int32(m), jp, geom)
    dense = np.asarray(arr)[:, :-1].reshape(7, a_k, geom.pz, geom.n_bx,
                                           geom.py, jpm.LANES)
    ref6, refid, lost_rank = jinc.consolidate_jnp(
        jnp.asarray(f6), jnp.asarray(idp), jnp.asarray(flagp),
        jnp.asarray(dense), geom)
    tarr = tinc.arrival_planes(torch.from_numpy(movers),
                               torch.tensor(m, dtype=torch.int32), tp,
                               tpm.geometry(tp))
    got6, gotid, dropped = tinc.consolidate(
        torch.from_numpy(f6), torch.from_numpy(idp),
        torch.from_numpy(flagp), tarr, tpm.geometry(tp))
    assert int(dropped) == int(lost_dup) + int(lost_rank) == 2 + 3

    def per_cell(p6, pid):
        """{cell: [ids by rank]}, checking that every slot holds its id's
        values and that the ranks are dense"""
        p6, pid = np.asarray(p6).reshape(6, k, -1), np.asarray(pid)
        valid = p6[0] < jpm.SENTINEL * 0.5
        assert (valid == (np.arange(k)[:, None] < valid.sum(0))).all()
        out = {}
        for c in np.nonzero(valid.any(0))[0]:
            ids = [int(i) for i in pid.reshape(k, -1)[valid[:, c], c]]
            for r, i in enumerate(ids):
                assert np.array_equal(p6[:, r, c], by_id[i][:6]), (c, i)
            out[int(c)] = ids
        return out

    got, want = per_cell(got6, gotid), per_cell(ref6, refid)
    assert sorted(got) == sorted(want) == sorted(
        lin(c) for c in (cell_a, cell_b, cell_c, cell_d))
    assert got[lin(cell_a)] == want[lin(cell_a)] == [0, 2]
    assert got[lin(cell_d)] == want[lin(cell_d)] == [1]
    kept_b = list(range(3, 3 + k - 2))
    for ids in (got[lin(cell_b)], want[lin(cell_b)]):
        assert ids[:k - 2] == kept_b and len(ids) == k
        assert len(set(ids[k - 2:])) == 2 and set(ids[k - 2:]) <= set(
            range(100, 104))
    for ids in (got[lin(cell_c)], want[lin(cell_c)]):
        assert len(set(ids)) == a_k and set(ids) <= set(
            range(200, 200 + a_k + 3))
    assert (gotid.numpy()[got6[0].numpy() >= jpm.SENTINEL * 0.5]
            == -1).all()


@pytest.mark.parametrize("dim,steps", [(2, 3), (3, 2)])
def test_run_inc_matches_jax(dim, steps):
    """Whole pallas_inc runs: 2D n=600 jittered for 3 steps, the 3D double
    dam break n=1,200 for 2 steps."""
    if dim == 2:
        jp, js = jfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11)
    else:
        jp, js = jfs.scenes.double_dam_break(n=1200, dim=3)
    tp, ts = _port(jp, js)
    sj = jinc.run_inc(js, jp, steps)
    st = tinc.run_inc(ts, tp, steps)
    assert int(st.overflow) == int(sj.overflow) == 0
    assert np.array_equal(np.sort(st.ids.numpy()), np.arange(ts.n))
    pj, vj = _aligned(sj)
    pt, vt = _aligned(st)
    assert _rel(pt, pj) <= 1e-5
    assert _rel(vt, vj) <= 1e-3
    # a particle whose cell changed went through the mover path
    geom = tpm.geometry(tp)
    c0 = tpm.cell_linear_parts(ts.pos, tp, geom)
    c1 = tpm.cell_linear_parts(torch.from_numpy(pt), tp, geom)
    assert int((c0 != c1).sum()) > 0, "no mover staged"


def test_pallas_inc_matches_pallas():
    """The port's incremental path against its full rebuild over 30 steps
    (tests/test_inc.py:343-358 on the port alone)."""
    tp, ts = tfs.scenes.dam_break(n=900, dim=2, jitter=0.3, seed=3,
                                  device="cpu")
    ref = tfs.run(ts, tp, 30, method="pallas", device="cpu")
    got = tfs.run(ts, tp, 30, method="pallas_inc", device="cpu")
    assert int(got.overflow) == 0
    pr, vr = _aligned(ref)
    pg, vg = _aligned(got)
    np.testing.assert_allclose(pg, pr, rtol=0, atol=5e-4)
    np.testing.assert_allclose(vg, vr, rtol=0, atol=5e-3)


def test_facade_and_rollout():
    tp, ts = tfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11,
                                  device="cpu")
    final, traj = tfs.rollout(ts, tp, 9, method="pallas_inc",
                              record_every=4, device="cpu")
    assert tuple(traj.shape) == (2, ts.n, 2)
    ran = tfs.run(ts, tp, 8, method="pallas_inc", device="cpu")

    def as_set(p):
        return p.numpy()[np.lexsort(p.numpy().T)]
    assert np.array_equal(as_set(traj[-1]), as_set(ran.pos))
    assert np.array_equal(np.sort(final.ids.numpy()), np.arange(ts.n))
    sim = tfs.FluidSim(tp, ts, method="pallas_inc", device="cpu")
    assert sim.method == "pallas_inc"
    sim.step(3)
    ref = tfs.run(ts, tp, 3, method="pallas_inc", device="cpu")
    o = np.argsort(ref.ids.numpy())
    assert np.array_equal(sim.get_positions(), ref.pos.numpy()[o])
    assert np.isfinite(sim.get_velocities()).all()


def test_guards(monkeypatch):
    """IncState carries the reference's fields (mig_overflow, 0 on one
    card; the continuity tier's rhop and age, None on the summation tier);
    step_planes is the reference's one-card call and step_phases, the
    sharded step, takes the reference's sharded arguments less n_dev and
    axis, which its exchange carries (the mesh); float32 ids cap
    to_planes; run refuses the facade-only method native with ValueError,
    as the reference does."""
    assert tinc.IncState._fields == jinc.IncState._fields == (
        "fields6", "idp", "overflow", "mig_overflow", "rhop", "age")
    ref = list(inspect.signature(jinc.step_planes).parameters)
    assert ref == ["state", "params", "geom", "m_cap", "x_origin",
                   "exchange", "wall_params", "n_dev", "mig_cap", "axis"]
    assert list(inspect.signature(tinc.step_planes).parameters) == ref[:4]
    assert list(inspect.signature(tinc.step_phases).parameters) == [
        p for p in ref if p not in ("n_dev", "axis")]
    tp, ts = tfs.scenes.dam_break(n=300, dim=2, device="cpu")
    geom = tpm.geometry(tp)
    s = tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom)
    assert s.rhop is None and s.age is None
    assert s.mig_overflow.dtype == torch.int32 and int(s.mig_overflow) == 0
    s1 = tinc.step_planes(s, tp, geom, tinc.mover_capacity(ts.n))
    assert s1.mig_overflow is s.mig_overflow
    with pytest.raises(ValueError, match="native"):
        tfs.run(ts, tp, 2, method="native", device="cpu")
    monkeypatch.setattr(tinc, "MAX_F32_ID", ts.n - 1)
    with pytest.raises(ValueError, match="float32"):
        tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom)
    assert tsolver._run_method("auto", 16, 40000) == "pallas_inc"


def test_compact_kernel2_contract(monkeypatch):
    """The reference's pipelined compaction kernel (``_compact_kernel2``,
    which ``COMPACT_DENSE`` keeps off in production) in Pallas interpret
    mode against the port's ``compact``, the counterpart of both TPU
    compaction kernels: the same rows keyed by id and the same count.
    A 2D plane stack of K=3 single-tile ranks whose tiles fall in each of
    the kernel's classes: hot (a lane holds more than STAGE_B flags),
    cold, and a single flag."""
    monkeypatch.setattr(jinc, "COMPACT_DENSE", True)
    rng = np.random.default_rng(2)
    shape = (3, 1, 1, 64, jpm.LANES)
    flags = np.zeros(shape, bool)
    flags[0] = rng.random(shape[1:]) < 0.3
    flags[1] = rng.random(shape[1:]) < 0.03
    flags[2, 0, 0, 17, 40] = True
    assert flags[0].sum(axis=-2).max() > jinc.STAGE_B
    assert flags[1].sum(axis=-2).max() <= jinc.STAGE_B
    f6 = rng.normal(size=(6,) + shape).astype(np.float32)
    idp = rng.permutation(flags.size).reshape(shape).astype(np.float32)
    ref, m_ref = jinc.compact_flagged(
        [jnp.asarray(f6), jnp.asarray(idp)], jnp.asarray(flags), jinc.TILE,
        use_kernel=True)
    vals, m, total = tinc.compact(
        [*torch.from_numpy(f6), torch.from_numpy(idp)],
        torch.from_numpy(flags.astype(np.float32)), tinc.TILE)
    n_flag = int(flags.sum())
    assert int(m_ref) == int(m) == int(total) == n_flag

    def rows(v):
        return {int(r[6]): tuple(r[:6]) for r in np.asarray(v)[:, :n_flag].T}
    assert rows(vals) == rows(ref)
    assert len(rows(vals)) == n_flag


def test_arrival_grouping_matches_jax():
    """The contract of the reference's arrival planes (its second sort and
    ``place`` in the skip_empty form), which the port's consolidate reads
    straight from the cell-sorted movers: per cell the same arrivals, at
    most ARRIVAL_K of them, and the same count dropped past ARRIVAL_K.  One
    cell receives 12 movers and one exactly ARRIVAL_K; where more than
    ARRIVAL_K arrive, which ones are taken depends on the unstable sorts,
    so only the count and membership are compared there."""
    jp, js = jfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11)
    geom = jpm.geometry(jp)
    m_cap = jinc.mover_capacity(js.n)
    a_k = jinc.ARRIVAL_K
    assert a_k == tinc.ARRIVAL_K
    rng = np.random.default_rng(4)
    m = 300
    lo, hi = np.asarray(jp.bounds_min), np.asarray(jp.bounds_max)
    pos = lo + rng.random((m, 2)) * (hi - lo)
    pos[:12] = lo + 2.5 * jp.cell
    pos[12:12 + a_k] = lo + 7.5 * jp.cell
    mv = np.zeros((7, m_cap), np.float32)
    mv[:2, :m] = pos.T
    mv[3:5, :m] = rng.normal(size=(2, m))
    mv[6, :m] = np.arange(m)
    arr, _, lost_dup = jinc.arrival_planes(jnp.asarray(mv), jnp.int32(m), jp,
                                           geom)
    dense = np.asarray(arr)[:, :-1].reshape(7, a_k, -1)
    valid = dense[0] < jpm.SENTINEL * 0.5
    assert (valid == (np.arange(a_k)[:, None] < valid.sum(0))).all()
    want = {int(c): [int(i) for i in dense[6, valid[:, c], c]]
            for c in np.nonzero(valid.any(0))[0]}

    tp = convert.params_from_dict(dataclasses.asdict(jp))
    tarr = tinc.arrival_planes(torch.from_numpy(mv),
                               torch.tensor(m, dtype=torch.int32), tp,
                               tpm.geometry(tp))
    starts = tarr.starts.numpy()
    rows = tarr.movers.numpy()[:, tarr.order.numpy()]
    na = np.diff(starts)
    assert na.sum() == m
    assert int(lost_dup) == int(np.maximum(na - a_k, 0).sum()) == 12 - a_k
    got = {int(c): [int(i) for i in rows[6, starts[c]:starts[c + 1]][:a_k]]
           for c in np.nonzero(na)[0]}
    assert got.keys() == want.keys()
    for c, ids in got.items():
        every = set(rows[6, starts[c]:starts[c + 1]].astype(int))
        assert len(ids) == len(want[c]) == min(len(every), a_k)
        if len(every) <= a_k:
            assert set(ids) == set(want[c])
        else:
            assert set(ids) <= every and set(want[c]) <= every
    # each sorted row is its mover's row
    assert np.array_equal(rows[:, :m], mv[:, rows[6, :m].astype(int)])


def test_consolidate_stops_at_first_sentinel_rank():
    """Ranks are dense, so the kept loop ends at a cell's first sentinel
    rank: a particle planted one rank past it is not read, and with no
    movers the valid slots come back unchanged (empty slots SENTINEL, 0
    and -1)."""
    tp, ts = tfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11,
                                  device="cpu")
    geom = tpm.geometry(tp)
    s = tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom)
    valid = s.fields6[0] < tpm.SENTINEL * 0.5
    occ = valid.sum(0).reshape(-1)
    cell = int(torch.nonzero((occ > 0) & (occ < geom.k - 1))[0, 0])
    r = int(occ[cell]) + 1
    f6 = s.fields6.clone()
    idp = s.idp.clone()
    f6.reshape(6, geom.k, -1)[:, r, cell] = \
        s.fields6.reshape(6, geom.k, -1)[:, 0, cell]
    idp.reshape(geom.k, -1)[r, cell] = 12345.0
    m_cap = tinc.mover_capacity(ts.n)
    arr = tinc.arrival_planes(torch.zeros((7, m_cap)),
                              torch.tensor(0, dtype=torch.int32), tp, geom)
    out6, oid, dropped = tinc.consolidate(f6, idp, torch.zeros_like(idp),
                                          arr, geom)
    assert int(dropped) == 0
    fill = torch.tensor([tpm.SENTINEL] * 3 + [0.0] * 3)
    assert torch.equal(out6, torch.where(valid[None], s.fields6,
                                         fill.reshape(6, 1, 1, 1, 1, 1)))
    assert torch.equal(oid, torch.where(valid, s.idp, -1.0))
    assert int(tpm.occ_rowmax_plain(f6[0]).max()) \
        == int(tpm.occ_rowmax_plain(s.fields6[0]).max())


def _contract_scene(case):
    """A 2D, a two-x-tile 2D and a 3D scene whose particles move about a
    third of a cell a step (numpy-seeded), so one step has movers."""
    if case == "multi_tile":
        tp, _ = tfs.scenes.dam_break(n=900, dim=2, jitter=0.2, seed=5,
                                     device="cpu")
        tp = tp.replace(bounds_min=(0.0, 0.0), bounds_max=(4.0, 1.0))
        bx = 126 * tp.cell
        ts = tfs.scenes.spawn_box(tp, [bx - 0.2, 0.0], [bx + 0.2, 0.25],
                                  jitter=0.2, seed=5, device="cpu")
    elif case == "2d":
        tp, ts = tfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11,
                                      device="cpu")
    else:
        tp, ts = tfs.scenes.double_dam_break(n=1200, dim=3, device="cpu")
    rng = np.random.default_rng(5)
    vel = rng.normal(size=tuple(ts.vel.shape)) * (0.3 * tp.cell / tp.dt)
    return tp, tfs.make_state(ts.pos.numpy(), vel, device="cpu")


@pytest.mark.parametrize("tier", ["summation", "continuity"])
@pytest.mark.parametrize("case", ["2d", "multi_tile", "3d"])
def test_mover_path_reads_no_undefined_fill(case, tier):
    """The fused force steps leave y, z, the velocities (and rho) undefined
    in the sectors that hold no query (csrc/force.cu): the plain step's
    outputs with those planes NaN at every slot that holds no query, a
    superset, give compact and consolidate the same results as the
    unpoisoned ones, with and without the carried rho."""
    tp, ts = _contract_scene(case)
    geom = tpm.geometry(tp)
    if case == "multi_tile":
        assert geom.n_bx > 1
    s = tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom)
    p6 = tpm.halo_x(s.fields6)
    rho = tpm.halo_x(tsph.density_plain(p6[:3], tp, geom))
    if tier == "continuity":
        new6, rho_new, flagp = tsph.accel_step_cont_plain(p6, rho, tp, geom)
    else:
        (new6, flagp), rho_new = tsph.accel_step_plain(p6, rho, tp, geom), None
    query = (p6[0] < tpm.SENTINEL * 0.5) \
        & tpm.interior_mask(geom, p6.device)[None]
    assert int((flagp > 0.5).sum()) > 0 and bool((~query).any())
    bad6 = new6.clone()
    bad6[1:, ~query] = float("nan")
    bad_rho = None
    if rho_new is not None:
        bad_rho = rho_new.clone()
        bad_rho[~query] = float("nan")
    m_cap = tinc.mover_capacity(ts.n)

    def path(n6, r):
        extra = [] if r is None else [r]
        movers, m, total = tinc.compact([*n6, s.idp, *extra], flagp, m_cap)
        arr = tinc.arrival_planes(movers, m, tp, geom)
        cons = tinc.consolidate(n6, s.idp, flagp, arr, geom, r)
        return (movers, m, total, *cons)

    for a, b in zip(path(new6, rho_new), path(bad6, bad_rho)):
        assert torch.equal(a, b)
