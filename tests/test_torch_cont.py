"""PyTorch port vs JAX package: the continuity-density tier
(``pallas_inc_cont``) on the CPU.

The same inputs, made with numpy, go through the JAX function and its port
counterpart.  The JAX side runs as ``tests/test_inc.py`` runs it here:
Pallas interpret mode for the sweeps, ``compact_flagged``'s host path and
``consolidate_jnp``.  The port runs with ``device="cpu"``, where each kernel
wrapper takes its plain PyTorch version.  Rows and planes are compared
keyed by id (both packages sort unstably and order compacted rows
differently).

Tolerances (relative to the largest magnitude unless said), and why:
  * continuity force step, one step on the same planes: pos 1e-6, vel 1e-4
    (the pair sums run in another order); rho_new atol 5e-6 rest_density,
    the reference's own bound (tests/test_inc.py:582-583); flags equal
    except within 1e-5 cell of a face in either package;
  * rho against the O(N^2) float64 sums: the reference's bounds
    (tests/test_inc.py:462, 497, 582);
  * step_planes and the solver entry over 2-3 steps: pos 1e-5, vel 1e-3,
    carried rho 1e-5 (summation order compounds over steps);
  * compaction, the arrival grouping and consolidation move values without
    arithmetic: exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.models import solver as jsolver
from gpufluidsimulator_tpu.ops import inc as jinc
from gpufluidsimulator_tpu.ops import kernels as jkernels
from gpufluidsimulator_tpu.ops import pallas_sph as jsph
from gpufluidsimulator_tpu.ops import planes as jpm

import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.ops import inc as tinc
from gpufluidsimulator_torch.ops import planes as tpm
from gpufluidsimulator_torch.ops import sph as tsph

NEAR_FACE = 1e-5     # in cells: flags may differ this close to a face


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the plain versions run many small
    ops, and several test processes share the host's cores."""
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


def _scene(n=700, **kw):
    jp, js = jfs.scenes.dam_break(n=n, dim=2, jitter=0.3, seed=3)
    return (jp.replace(**kw) if kw else jp), js


def _valid(fields6, geom):
    return (np.asarray(fields6[0]) < jpm.SENTINEL * 0.5) \
        & np.asarray(jinc.interior_mask(geom))[None]


def _by_id(fields6, idp, rhop, geom, n):
    """(pos (n, 3), vel (n, 3), rho (n,)) of the valid interior slots,
    indexed by particle id; every id must be present once."""
    valid = _valid(fields6, geom)
    ids = np.asarray(idp)[valid].astype(np.int64)
    assert np.array_equal(np.sort(ids), np.arange(n))
    f6 = np.asarray(fields6)[:, valid]
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    rho = np.zeros(n, np.float32)
    pos[ids], vel[ids] = f6[:3].T, f6[3:].T
    rho[ids] = np.asarray(rhop)[valid]
    return pos, vel, rho


def _near_face(p, params):
    near = np.zeros(p[0].shape, bool)
    for d in range(params.dim):
        u = (p[d] - params.bounds_min[d]) / params.cells_axis[d]
        near |= np.abs(u - np.round(u)) < NEAR_FACE
    return near


# ---------------------------------------------------------------------------
# kernel 4c: the continuity force step
# ---------------------------------------------------------------------------

FORMS = {"rate": dict(cont_form="rate"),
         "relax": dict(cont_form="relax"),
         "sum": dict(cont_form="sum"),
         "alpha": dict(cont_form="rate", cont_alpha=0.1),
         "delta": dict(cont_form="rate", cont_delta=0.1),
         "beta0": dict(cont_form="rate", cont_beta=0.0)}


def _far_points(pos, params):
    """Two lattice points farther than 2 h from every row of ``pos`` and
    from each other."""
    lo, hi = np.asarray(params.bounds_min), np.asarray(params.bounds_max)
    axes = [np.linspace(0.05, 0.95, 10)] * params.dim
    cand = lo + np.stack(np.meshgrid(*axes), -1).reshape(-1, params.dim) \
        * (hi - lo)
    dist = np.linalg.norm(cand[:, None] - pos[None], axis=-1).min(1)
    free = cand[dist > 2 * params.h]
    far = [free[0]] + [c for c in free
                       if np.linalg.norm(c - free[0]) > 2 * params.h][:1]
    assert len(far) == 2
    return np.array(far, np.float32)


def _cont_inputs(jp, js, seed=2):
    """JAX-built planes with numpy-seeded velocities (a tenth of a cell per
    step) and a carried density: the summation density times numpy noise.
    Two particles moved away from the fluid (ids 0 and 1, only their self
    pair) carry 0.5, below the EOS floor (1e-3 rho0), where the raw and the
    clamped rho differ: their self pair adds h^6 in sum and relax and does
    not cancel in delta, and the epilogue reads the raw rho.  (Below-floor
    slots inside the fluid would give their neighbours a viscosity factor
    1,000 times the others', and the float32 sums cancel past the
    bounds.)"""
    rng = np.random.default_rng(seed)
    vel = rng.normal(size=np.asarray(js.vel).shape) * (0.1 * jp.cell / jp.dt)
    pos = np.array(js.pos)
    pos[:2] = _far_points(pos[2:], jp)
    js = js._replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel, jnp.float32))
    geom = jpm.geometry(jp)
    s = jinc.to_planes(js.pos, js.vel, js.ids, jp, geom, continuity=True)
    p6 = jpm.halo_x(s.fields6)
    occ_q, occ_s = jpm.occupancy_bounds(p6, jp, geom)
    rho = np.array(jsph.density_planes(p6[:3], occ_q, occ_s, jp, geom))
    valid = _valid(p6, geom)
    rho = np.where(valid, rho * (1.0 + 0.05 * rng.normal(size=rho.shape)),
                   0.0)
    far_slots = valid & (np.asarray(s.idp) < 2)
    assert far_slots.sum() == 2
    rho[far_slots] = 0.5
    return geom, p6, occ_q, occ_s, rho.astype(np.float32), valid, far_slots


@pytest.mark.parametrize("form", list(FORMS) + ["3d"])
def test_force_step_cont_matches_jax(form):
    """accel_step_cont against JAX accel_planes(fuse_integrate=True,
    emit_movers=True, continuity=True) on the same planes and carried rho,
    for every form and switch (2D n=400), and the default form on the 3D
    double dam break (n=1,200, two obstacles)."""
    if form == "3d":
        jp, js = jfs.scenes.double_dam_break(n=1200, dim=3)
    else:
        jp, js = _scene(n=400, **FORMS[form])
    geom, p6, occ_q, occ_s, rho, valid, far = _cont_inputs(jp, js)
    new6_j, rho_j, flag_j = (np.asarray(a) for a in jsph.accel_planes(
        p6, jnp.asarray(rho), occ_q, occ_s, jp, geom, fuse_integrate=True,
        emit_movers=True, continuity=True))
    flag_j = flag_j > 0.5

    tp = convert.params_from_dict(dataclasses.asdict(jp))
    tgeom = tpm.geometry(tp)
    assert tsph._cont_constants(tp).form == ("delta" if form == "delta"
                                             else jp.cont_form)
    if form == "3d":
        assert len(tp.obstacles) == 2
    pi = convert.planes_from_numpy(p6, np.zeros(0), np.zeros(0), occ_q,
                                   occ_s, device="cpu")
    new6, rho_new, flagp = tsph.accel_step_cont(
        pi.planes, torch.from_numpy(rho), pi.occ_q, pi.occ_s, tp, tgeom)
    new6_t, rho_t, flag_t = new6.numpy(), rho_new.numpy(), flagp.numpy() > 0.5

    assert valid.sum() == js.n
    assert _rel(new6_t[:3, valid], new6_j[:3, valid]) <= 1e-6
    assert _rel(new6_t[3:, valid], new6_j[3:, valid]) <= 1e-4
    np.testing.assert_allclose(rho_t[valid], rho_j[valid], rtol=0,
                               atol=5e-6 * jp.rest_density)
    # every other slot: sentinel positions, zero velocities, rho and flags
    assert (new6_t[:3, ~valid] == tpm.SENTINEL).all()
    assert not new6_t[3:, ~valid].any() and not rho_t[~valid].any()
    assert not flag_t[~valid].any()
    near = _near_face(new6_t[:3], tp) | _near_face(new6_j[:3], tp)
    assert not ((flag_t != flag_j) & valid & ~near).any()
    assert flag_t.sum() > 10
    # the isolated below-floor particles: their self pair and raw rho
    c = tsph._cont_constants(tp)
    lam = tp.cont_relax
    h4, h6 = tp.h ** 4, tp.h ** 6
    want = {"sum": c.rho_sum_scale * h6,
            "relax": (1.0 - lam) * 0.5 + lam * c.rho_sum_scale * h6,
            "delta": 0.5 + c.drho_scale * h4 * (0.5 - 1.0) * c.kappa}
    np.testing.assert_allclose(rho_t[far], want.get(form, 0.5), rtol=1e-5)
    if form == "delta":
        assert (np.abs(rho_t[far] - 0.5) > 1e-4).all()
    # the force part is the summation tier's exactly when the switches that
    # touch it are off (no correction, no alpha term)
    new6_s, flag_s = tsph.accel_step(pi.planes, torch.from_numpy(rho),
                                     pi.occ_q, pi.occ_s, tp, tgeom)
    assert torch.equal(new6_s, new6) == (form == "beta0")


def _n2(params, pos, vel):
    """O(N^2) float64 sums over (pos, vel) rows: (rate sum m (vi-vj).gradW
    of the poly6 gradient, summation density)."""
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    dd = pos[:, None, :] - pos[None, :, :]
    r2 = (dd ** 2).sum(-1)
    d2 = np.maximum(params.h ** 2 - r2, 0.0)
    dot = ((vel[:, None, :] - vel[None, :, :]) * dd).sum(-1)
    c = jkernels.poly6_coef(params.h, params.dim) * params.particle_mass
    return -6.0 * c * (d2 ** 2 * dot).sum(axis=1), c * (d2 ** 3).sum(axis=1)


@pytest.mark.parametrize("form", ["rate", "sum", "relax"])
def test_rho_matches_n2_reference(form):
    """The port's emitted rho against the O(N^2) float64 sums at the step's
    input positions (tests/test_inc.py:428-583 on the port): rate
    rho_q + dt drho, sum R(x), relax (1-l)(rho_q + dt drho) + l R(x), with a
    synthetic carried rho (900 + id % 37)."""
    tp, ts = tfs.scenes.dam_break(n=400, dim=2, jitter=0.3, seed=3,
                                  device="cpu")
    tp = tp.replace(cont_form=form)
    st = tfs.run(ts, tp, 5, method="pallas_inc", device="cpu")
    geom = tpm.geometry(tp)
    s = tinc.to_planes(st.pos, st.vel, st.ids, tp, geom, continuity=True)
    rhop = torch.where(s.idp >= 0, 900.0 + s.idp % 37, 0.0)
    p6 = tpm.halo_x(s.fields6)
    occ_q, occ_s = tpm.occupancy_bounds(p6, tp, geom)
    _, rho_new, _ = tsph.accel_step_cont(p6, tpm.halo_x(rhop), occ_q, occ_s,
                                         tp, geom)
    valid = _valid(s.fields6.numpy(), geom)
    ids = s.idp.numpy()[valid].astype(int)
    rho_k = rho_new.numpy()[valid]
    rho_q = rhop.numpy()[valid]
    drho, rsum = _n2(tp, st.pos.numpy(), st.vel.numpy())
    row = {int(i): r for r, i in enumerate(st.ids.numpy())}
    rows = np.array([row[i] for i in ids])
    if form == "rate":
        got, ref = (rho_k - rho_q) / tp.dt, drho[rows]
        atol = 2e-6 * max(np.abs(ref).max(), 1.0)
    elif form == "sum":
        got, ref = rho_k, rsum[rows]
        atol = 2e-6 * tp.rest_density
    else:
        lam = tp.cont_relax
        got = rho_k
        ref = (1.0 - lam) * (rho_q + tp.dt * drho[rows]) + lam * rsum[rows]
        atol = 5e-6 * tp.rest_density
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# rho through the mover path (kernels 7 and 9 with 8 channels)
# ---------------------------------------------------------------------------

def test_rho_travels_with_movers():
    """Perturbed positions move a real fraction of the particles across a
    cell face: the 8-channel compaction, the arrival grouping and the rho
    consolidate against the reference's extract_movers(rhop=...),
    arrival_planes and consolidate(rhop=...) (its jnp form): the same rows,
    the same ids per cell, rho travelling with its id.  Exact."""
    jp, js = _scene(n=900)
    geom = jpm.geometry(jp)
    s = jinc.to_planes(js.pos, js.vel, js.ids, jp, geom, continuity=True)
    rng = np.random.default_rng(1)
    delta = (rng.random(np.asarray(js.pos).shape) - 0.5) * 1.4 * jp.cell
    new_pos = np.clip(np.asarray(js.pos) + delta, jp.bounds_min,
                      jp.bounds_max).astype(np.float32)
    valid = _valid(s.fields6, geom)
    ids = np.asarray(s.idp).astype(np.int64)
    f6 = np.array(s.fields6)
    for d in range(jp.dim):
        f6[d][valid] = new_pos[ids[valid], d]
    rhop = np.where(valid, 1000.0 + np.asarray(s.idp)
                    + rng.random(valid.shape), 0.0).astype(np.float32)
    _, _, flags = jinc.detect_movers(jnp.asarray(f6), s.idp, jp, geom)
    flagp = np.asarray(flags).astype(np.float32)
    m_cap = jinc.mover_capacity(js.n)
    movers_j, m_j, tot_j = jinc.extract_movers(
        jnp.asarray(f6), s.idp, jnp.asarray(flagp), geom, m_cap,
        rhop=jnp.asarray(rhop))
    arr_j, live_t, lost_dup = jinc.arrival_planes(movers_j, m_j, jp, geom)
    ref6, refid, refrho, lost_rank = jinc.consolidate(
        jnp.asarray(f6), s.idp, jnp.asarray(flagp), arr_j, live_t, geom,
        rhop=jnp.asarray(rhop))
    assert movers_j.shape[0] == 8 and arr_j.shape[0] == 8
    assert int(lost_dup) == int(lost_rank) == 0

    tp = convert.params_from_dict(dataclasses.asdict(jp))
    tgeom = tpm.geometry(tp)
    t6, tid, trho = (torch.from_numpy(a) for a in
                     (f6, np.array(s.idp), rhop))
    tflag = torch.from_numpy(flagp)
    movers, m, total = tinc.compact([*t6, tid, trho], tflag, m_cap)
    n_mv = int(m)
    assert n_mv == int(m_j) == int(total) == int(tot_j) > 20

    def rows(v, k):
        return {int(r[6]): tuple(r) for r in np.asarray(v)[:, :k].T}
    assert rows(movers.numpy(), n_mv) == rows(movers_j, n_mv)
    arr = tinc.arrival_planes(movers, m, tp, tgeom)
    assert arr.movers.shape[0] == 8
    got6, gotid, gotrho, dropped = tinc.consolidate(t6, tid, tflag, arr,
                                                    tgeom, rhop=trho)
    assert int(dropped) == 0
    want = _by_id(ref6, refid, refrho, geom, js.n)
    got = _by_id(got6.numpy(), gotid.numpy(), gotrho.numpy(), geom, js.n)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    # empty ranks: rho 0, as consolidate_jnp fills them
    gv = _valid(got6.numpy(), geom)
    assert not gotrho.numpy()[~gv].any()
    # the 7-channel form is unchanged by the 8th channel
    plain7 = tinc.consolidate(t6, tid, tflag, arr._replace(
        movers=arr.movers[:7]), tgeom)
    assert all(torch.equal(a, b) for a, b in
               zip(plain7, (got6, gotid, dropped)))


# ---------------------------------------------------------------------------
# the continuity step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["rate", "sum"])
def test_step_planes_matches_jax(form, monkeypatch):
    """step_planes in both packages: one JAX step seeds the carried density
    (age 0), its state converts across (rhop, age 1), and both packages take
    two more steps; the rate form with RESUM_EVERY = 2 in both, so the last
    step (age 2) re-sums.  Positions, velocities and the carried rho keyed
    by id."""
    monkeypatch.setattr(jinc, "RESUM_EVERY", 2)
    monkeypatch.setattr(tinc, "RESUM_EVERY", 2)
    jp, js = _scene(n=600, cont_form=form)
    geom = jpm.geometry(jp)
    m_cap = jinc.mover_capacity(js.n)
    sj = jinc.to_planes(js.pos, js.vel, js.ids, jp, geom, continuity=True)
    sj = jinc.step_planes(sj, jp, geom, m_cap)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    tgeom = tpm.geometry(tp)
    st = convert.inc_state_from_numpy(
        *(np.asarray(a) for a in (sj.fields6, sj.idp, sj.overflow)),
        device="cpu", rhop=np.asarray(sj.rhop), age=sj.age)
    assert st.age == 1 and isinstance(st.age, int) and st.rhop.any()
    for _ in range(2):
        sj = jinc.step_planes(sj, jp, geom, m_cap)
        st = tinc.step_planes(st, tp, tgeom, m_cap)
    assert st.age == int(sj.age) == 3
    assert int(st.overflow) == int(sj.overflow) == 0
    pj, vj, rj = _by_id(sj.fields6, sj.idp, sj.rhop, geom, js.n)
    pt, vt, rt = _by_id(st.fields6.numpy(), st.idp.numpy(), st.rhop.numpy(),
                        geom, js.n)
    assert _rel(pt, pj) <= 1e-5
    assert _rel(vt, vj) <= 1e-3
    assert _rel(rt, rj) <= 1e-5


def test_solver_entry_matches_jax():
    """solver.run with method="pallas_inc_cont" in both packages, 3 steps of
    the jittered 2D dam break; then rollout and FluidSim on the port against
    its own run."""
    steps = 3
    jp, js = jfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11)
    tp, ts = _port(jp, js)
    sj = jsolver.run(js, jp, steps, method="pallas_inc_cont")
    st = tfs.run(ts, tp, steps, method="pallas_inc_cont", device="cpu")
    assert int(st.overflow) == int(sj.overflow) == 0
    oj, ot = np.argsort(np.asarray(sj.ids)), np.argsort(st.ids.numpy())
    assert np.array_equal(st.ids.numpy()[ot], np.arange(ts.n))
    assert _rel(st.pos.numpy()[ot], np.asarray(sj.pos)[oj]) <= 1e-5
    assert _rel(st.vel.numpy()[ot], np.asarray(sj.vel)[oj]) <= 1e-3
    # diagnostics re-sum rho at the end, as the reference does
    assert _rel(st.rho.numpy()[ot], np.asarray(sj.rho)[oj]) <= 1e-4
    final, traj = tfs.rollout(ts, tp, steps, method="pallas_inc_cont",
                              record_every=1, device="cpu")
    assert tuple(traj.shape) == (steps, ts.n, 2)

    def as_set(p):
        return p.numpy()[np.lexsort(p.numpy().T)]
    assert np.array_equal(as_set(traj[-1]), as_set(st.pos))
    assert np.array_equal(as_set(final.pos), as_set(st.pos))
    sim = tfs.FluidSim(tp, ts, method="pallas_inc_cont", device="cpu")
    assert sim.method == "pallas_inc_cont"
    sim.step(steps)
    assert np.array_equal(sim.get_positions(), st.pos.numpy()[ot])


def test_single_step_facade_resets_age():
    """The single-step facade converts afresh on every call, so each call
    re-seeds the carried density by a sweep at age 0, as the reference's
    facade does (solver.py:69-82): its second step is the step from a
    freshly summed density, not from the density carried out of step 1,
    which a two-step run uses."""
    tp, ts = tfs.scenes.dam_break(n=600, dim=2, jitter=0.3, seed=11,
                                  device="cpu")
    a1 = tfs.step(ts, tp, method="pallas_inc_cont", device="cpu")
    a2 = tfs.step(a1, tp, method="pallas_inc_cont", device="cpu")
    run2 = tfs.run(ts, tp, 2, method="pallas_inc_cont", device="cpu")
    o2, orun = np.argsort(a2.ids.numpy()), np.argsort(run2.ids.numpy())
    assert not np.array_equal(a2.pos.numpy()[o2], run2.pos.numpy()[orun])
    # a2 = one step from a1 with rho seeded by the density sweep
    geom = tpm.geometry(tp)
    s = tinc.to_planes(a1.pos, a1.vel, a1.ids, tp, geom, continuity=True)
    assert s.age == 0
    p6 = tpm.halo_x(s.fields6.clone())
    occ_q, occ_s = tpm.occupancy_bounds(p6, tp, geom)
    seeded = s._replace(rhop=tsph.density_planes(p6[:3], occ_q, occ_s, tp,
                                                 geom), age=1)
    m_cap = tinc.mover_capacity(ts.n)
    r1 = tinc.step_planes(seeded, tp, geom, m_cap)
    pos, _, _ = _by_id(r1.fields6.numpy(), r1.idp.numpy(), r1.rhop.numpy(),
                       geom, ts.n)
    assert np.array_equal(pos[:, :2], a2.pos.numpy()[o2])


# ---------------------------------------------------------------------------
# the port's own properties (tests/test_inc.py:413-702 on the port)
# ---------------------------------------------------------------------------

def _port_planes(form="rate", n=700):
    tp, ts = tfs.scenes.dam_break(n=n, dim=2, jitter=0.3, seed=3,
                                  device="cpu")
    tp = tp.replace(cont_form=form)
    geom = tpm.geometry(tp)
    s = tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom, continuity=True)
    return tp, ts, geom, s, tinc.mover_capacity(ts.n)


def _rho_by_id(s, geom):
    valid = _valid(s.fields6.numpy(), geom)
    ids = s.idp.numpy()[valid].astype(np.int64)
    out = np.zeros(int(ids.max()) + 1, np.float32)
    out[ids] = s.rhop.numpy()[valid]
    return out


def test_first_step_equals_summation_tier():
    """Step 1 seeds rho with the summation sweep, so it is pallas_inc's step
    exactly; to_planes starts the carried plane at zeros, age 0."""
    tp, ts, geom, s, _ = _port_planes()
    assert s.age == 0 and not s.rhop.any()
    assert tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom).rhop is None
    ref = tfs.run(ts, tp, 1, method="pallas_inc", device="cpu")
    got = tfs.run(ts, tp, 1, method="pallas_inc_cont", device="cpu")
    gi, ri = np.argsort(got.ids.numpy()), np.argsort(ref.ids.numpy())
    assert np.array_equal(got.pos.numpy()[gi], ref.pos.numpy()[ri])
    assert np.array_equal(got.vel.numpy()[gi], ref.vel.numpy()[ri])


def test_sum_form_ignores_carried_drift():
    """sum: the emitted rho is a function of the step's input positions
    only; drift injected into the carried plane moves the particles (EOS
    input) but not the emitted rho, per id."""
    tp, _, geom, s, m_cap = _port_planes("sum")
    for _ in range(2):
        s = tinc.step_planes(s, tp, geom, m_cap)
    clean = tinc.step_planes(s, tp, geom, m_cap)
    drifted = tinc.step_planes(s._replace(rhop=s.rhop + 37.0), tp, geom,
                               m_cap)
    assert not torch.equal(drifted.fields6, clean.fields6)
    assert np.array_equal(_rho_by_id(clean, geom), _rho_by_id(drifted, geom))


def test_relax_form_decays_carried_drift():
    """relax: drift injected into the carried rho decays by (1 - lambda) in
    one step (slack for the force feedback of the drifted EOS)."""
    tp, _, geom, s, m_cap = _port_planes("relax")
    lam = tp.cont_relax
    for _ in range(2):
        s = tinc.step_planes(s, tp, geom, m_cap)
    clean = tinc.step_planes(s, tp, geom, m_cap)
    drifted = tinc.step_planes(s._replace(rhop=s.rhop + 40.0), tp, geom,
                               m_cap)
    diff = np.abs(_rho_by_id(drifted, geom) - _rho_by_id(clean, geom))
    assert diff.max() <= (1.0 - lam) * 40.0 * 1.05 + 1.0, diff.max()
    assert diff.max() >= (1.0 - lam) * 40.0 * 0.9


def test_rate_form_resums_on_schedule(monkeypatch):
    """rate with RESUM_EVERY = 4: the step at age 4 re-sums, so drift
    injected before it does not propagate; the step at age 5 does not, so
    drift does."""
    monkeypatch.setattr(tinc, "RESUM_EVERY", 4)
    tp, _, geom, s, m_cap = _port_planes("rate")
    for _ in range(4):
        s = s._replace(rhop=s.rhop + 1.0)
        s = tinc.step_planes(s, tp, geom, m_cap)
    assert s.age == 4
    drifted = tinc.step_planes(s._replace(rhop=s.rhop + 123.0), tp, geom,
                               m_cap)
    clean = tinc.step_planes(s, tp, geom, m_cap)
    assert torch.equal(drifted.rhop, clean.rhop)
    assert torch.equal(drifted.fields6, clean.fields6)
    later = tinc.step_planes(clean._replace(rhop=clean.rhop + 123.0), tp,
                             geom, m_cap)
    assert not torch.equal(later.rhop, tinc.step_planes(clean, tp, geom,
                                                        m_cap).rhop)


def test_thirty_steps_stay_sane():
    """30 continuity steps (the default rate form): no NaN, overflow 0, ids
    a permutation, carried rho finite and positive on valid slots, and the
    trajectory within 8 h of pallas_inc (the two are O(dt)-different
    formulations)."""
    tp, ts, geom, s, m_cap = _port_planes()
    ref = tfs.run(ts, tp, 30, method="pallas_inc", device="cpu")
    got = tfs.run(ts, tp, 30, method="pallas_inc_cont", device="cpu")
    assert int(got.overflow) == 0
    assert torch.isfinite(got.pos).all() and torch.isfinite(got.vel).all()
    gi, ri = np.argsort(got.ids.numpy()), np.argsort(ref.ids.numpy())
    assert np.array_equal(got.ids.numpy()[gi], np.arange(ts.n))
    dp = np.abs(got.pos.numpy()[gi] - ref.pos.numpy()[ri]).max()
    assert dp < 8 * tp.h, f"divergence {dp} vs h={tp.h}"
    for _ in range(30):
        s = tinc.step_planes(s, tp, geom, m_cap)
    valid = _valid(s.fields6.numpy(), geom)
    rho = s.rhop.numpy()[valid]
    assert np.isfinite(rho).all() and (rho > 0).all()
