"""PyTorch port vs JAX package: spatial sharding (``parallel/``) on the CPU.

The reference runs each device's program under ``jax.shard_map`` on
conftest's 8 virtual CPU devices; the port puts its slabs on the CPU
(``make_mesh(devices=["cpu"] * n)``) and steps them in lock step.  The
same numpy-seeded inputs go through both.

Tolerances, and why:
  * slab packing, the ghost-lane exchange, migration and the mover
    exchange move values without arithmetic: exact, per slab keyed by id
    (both packages group with sorts whose order within a group differs);
  * sharded trajectories against the unsharded path and the reference's:
    positions 1e-5 after 5 to 25 steps, the bar of the reference's own
    tests (tests/test_sharded.py, tests/test_sharded_smoke.py); pair sums
    run in another order once the rank order in a cell differs;
  * a one-slab mesh against the unsharded step: 1e-6, the reference's bar.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.ops import inc as jinc
from gpufluidsimulator_tpu.ops import planes as jpm
from gpufluidsimulator_tpu.parallel import sharded as jsh
from gpufluidsimulator_tpu.utils import checkpoint as jckpt

import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.ops import inc as tinc
from gpufluidsimulator_torch.ops import planes as tpm
from gpufluidsimulator_torch.ops import sph as tsph
from gpufluidsimulator_torch.parallel import mesh as tmesh
from gpufluidsimulator_torch.parallel import sharded as tsh
from gpufluidsimulator_torch.utils import checkpoint as tckpt

N_DEV = 4            # slabs of the shard_map comparisons


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share the host: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mesh(n):
    return tmesh.make_mesh(devices=["cpu"] * n)


def _jmesh(n):
    return JMesh(np.asarray(jax.devices()[:n]), ("x",))


def _port(jp, js):
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    ts = convert.state_from_numpy(*(np.asarray(a) for a in js),
                                  device="cpu")
    return tp, ts


def _ref_pos(state, params, steps, method="pallas"):
    ref = tfs.run(state, params, steps, method=method, device="cpu")
    return ref.pos.numpy()[np.argsort(ref.ids.numpy())]


def _counters(sstate):
    return (sum(int(o) for o in sstate.overflow),
            sum(int(o) for o in sstate.mig_overflow))


def _slab_ids(sstate):
    return [set(i.numpy().tolist()) - {-1} for i in sstate.ids]


def _shard_map(fn, n, n_in, n_out):
    return jax.jit(jax.shard_map(fn, mesh=_jmesh(n),
                                 in_specs=(P("x"),) * n_in,
                                 out_specs=(P("x"),) * n_out,
                                 check_vma=False))


def _x_origin_jax(params, nx_local):
    width = jnp.float32(nx_local * params.cell)
    return (jnp.float32(params.bounds_min[0])
            + jax.lax.axis_index("x").astype(jnp.float32) * width), width


# ---------------------------------------------------------------------------
# slab layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_local_params_and_slabs_match_jax(n_dev):
    jp, js = jfs.scenes.dam_break(n=900, dim=2, jitter=0.2, seed=4)
    tp, ts = _port(jp, js)
    jl, jn = jsh.local_params(jp, n_dev)
    tl, tn = tsh.local_params(tp, n_dev)
    assert tn == jn
    assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
    want, jm = jsh._slab_arrays(jp, js, n_dev)
    got, tm = tsh._slab_arrays(tp, ts, n_dev)
    assert tm == jm and set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    sstate, m_cap = tsh.distribute(tp, ts, _mesh(n_dev))
    assert m_cap == jm
    for k in want:
        slabs = getattr(sstate, k)
        assert len(slabs) == n_dev
        for d in range(n_dev):
            assert np.array_equal(slabs[d].numpy(), want[k][d]), k
    for d in range(n_dev):
        assert tsh.slab_origin(tp, tn, d) == float(
            np.float32(tp.bounds_min[0])
            + np.float32(d) * np.float32(tn * tp.cell))


# ---------------------------------------------------------------------------
# the three exchanges, against the reference's under shard_map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx_local", [13, 200])
def test_make_exchange_matches_jax(nx_local):
    """Ghost lanes from the neighbours' edge cells, the fill at the mesh's
    edges; one x tile (13 cells) and two tiles, the last partly filled
    (200 cells)."""
    n_bx = -(-nx_local // jpm.TILE_X)
    rng = np.random.default_rng(nx_local)
    stacks = rng.normal(size=(N_DEV, 6, 2, 3, n_bx, 16, 128)) \
        .astype(np.float32)
    assert tsh.make_exchange(_mesh(1), nx_local) is None
    jex = jsh.make_exchange(N_DEV, nx_local)
    tex = tsh.make_exchange(_mesh(N_DEV), nx_local)
    for n_pos, sl in ((3, slice(None)), (0, slice(0, 1))):
        want = np.asarray(_shard_map(
            lambda s: (jex(s[0], n_pos_fields=n_pos)[None],), N_DEV, 1, 1)(
            jnp.asarray(stacks[:, sl]))[0])
        got = tex({d: torch.from_numpy(stacks[d, sl].copy())
                   for d in range(N_DEV)}, n_pos)
        for d in range(N_DEV):
            assert np.array_equal(got[d].numpy(), want[d]), (n_pos, d)


def _particles(params, n_dev, nx_local, n_cap, n_live, spill, seed):
    """Per-slab capacity arrays: ``n_live`` particles a slab, ``spill`` of
    them a cell or less past each slab face, the rest inside."""
    rng = np.random.default_rng(seed)
    width = nx_local * params.cell
    lo = params.bounds_min[0]
    pos = np.full((n_dev, n_cap, 2), jpm.SENTINEL, np.float32)
    vel = np.zeros((n_dev, n_cap, 2), np.float32)
    ids = np.full((n_dev, n_cap), -1, np.int32)
    for d in range(n_dev):
        x0 = lo + d * width
        x = rng.uniform(x0 + 0.01 * width, x0 + 0.99 * width, n_live)
        x[:spill] = x0 - rng.uniform(0.05, 0.9, spill) * params.cell
        x[spill:2 * spill] = x0 + width + rng.uniform(0.0, 0.9, spill) \
            * params.cell
        slot = rng.permutation(n_cap - 4 * spill)[:n_live]
        pos[d, slot, 0] = x
        pos[d, slot, 1] = rng.uniform(0.1, 0.9, n_live)
        vel[d, slot] = rng.normal(size=(n_live, 2))
        ids[d, slot] = d * n_live + np.arange(n_live)
    return pos, vel, ids


def _by_id(pos, vel, ids):
    live = ids >= 0
    return {int(i): (tuple(p), tuple(v))
            for i, p, v in zip(ids[live], pos[live], vel[live])}


@pytest.mark.parametrize("m_cap", [16, 3])
def test_migrate_matches_jax(m_cap):
    """Leavers on both faces of every slab; ``m_cap`` 3 is too small for
    the 6 leavers a face, which counts in mig_overflow."""
    jp, _ = jfs.scenes.dam_break(n=400, dim=2)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    _, nx_local = jsh.local_params(jp, N_DEV)
    n_cap = 96
    pos, vel, ids = _particles(jp, N_DEV, nx_local, n_cap, 40, 6, m_cap)

    def fn(p, v, i):
        x0, width = _x_origin_jax(jp, nx_local)
        out = jsh.migrate(p[0], v[0], i[0], x0, width, m_cap, N_DEV)
        return tuple(a[None] for a in out[:3]) + (out[3].reshape(1),)

    want = [np.asarray(a) for a in _shard_map(fn, N_DEV, 3, 4)(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(ids))]
    got = tsh.migrate(
        {d: torch.from_numpy(pos[d]) for d in range(N_DEV)},
        {d: torch.from_numpy(vel[d]) for d in range(N_DEV)},
        {d: torch.from_numpy(ids[d]) for d in range(N_DEV)},
        {d: tsh.slab_origin(tp, nx_local, d) for d in range(N_DEV)},
        tsh.slab_width(tp, nx_local), m_cap, _mesh(N_DEV))
    given = {}
    for d in range(N_DEV):
        given.update(_by_id(pos[d], vel[d], ids[d]))
    lost = 0
    for d in range(N_DEV):
        gp, gv, gi, gm = (a.numpy() for a in got[d])
        assert int(gm) == int(want[3][d])
        g = _by_id(gp, gv, gi)
        w = _by_id(want[0][d], want[1][d], want[2][d])
        # every particle keeps its values; the stayers are the same and,
        # where a face's leavers fit m_cap, the arrivals too; past m_cap
        # each package ships its own first m_cap of them
        assert all(given[i] == v for i, v in g.items())
        assert len(g) == len(w)
        mine = set(ids[d][ids[d] >= 0].tolist())
        assert set(g) & mine == set(w) & mine
        if m_cap >= 6:
            assert g == w
        # free slots park at the sentinel with velocity 0
        assert (gp[gi < 0] == jpm.SENTINEL).all()
        assert (gv[gi < 0] == 0).all()
        lost += int(gm)
    assert (lost > 0) == (m_cap < 6)


@pytest.mark.parametrize("nf", [7, 8])
def test_exchange_movers_matches_jax(nf):
    """Movers leaving through both faces, stayers and dead rows; nf 8 is
    the continuity tier's (rho in row 7).  The merged rows that are live
    agree per id, the lost counts exactly (mig_cap 5 < 7 leavers a face
    on slab 1)."""
    jp, _ = jfs.scenes.dam_break(n=400, dim=2)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    _, nx_local = jsh.local_params(jp, N_DEV)
    width = nx_local * jp.cell
    cap, mig_cap = 64, 5
    rng = np.random.default_rng(nf)
    movers = np.zeros((N_DEV, nf, cap), np.float32)
    m = np.asarray([30, 40, 0, 25], np.int32)
    for d in range(N_DEV):
        x0 = jp.bounds_min[0] + d * width
        x = rng.uniform(x0, x0 + width, m[d])
        n_l = min(7 if d == 1 else 3, m[d] // 2)
        x[:n_l] = x0 - rng.uniform(0.01, 0.9, n_l) * jp.cell
        x[n_l:2 * n_l] = x0 + width + rng.uniform(0.0, 0.9, n_l) * jp.cell
        movers[d, 0, :m[d]] = rng.permutation(x)
        movers[d, 1:6, :m[d]] = rng.normal(size=(5, m[d]))
        movers[d, 6, :m[d]] = d * 100 + np.arange(m[d])
        if nf == 8:
            movers[d, 7, :m[d]] = rng.uniform(900, 1100, m[d])

    def fn(mv, mm):
        x0, w = _x_origin_jax(jp, nx_local)
        merged, live, lost = jinc.exchange_movers(mv[0], mm[0], x0, w,
                                                  mig_cap, N_DEV, "x")
        return merged[None], live[None], lost.reshape(1)

    want = [np.asarray(a) for a in _shard_map(fn, N_DEV, 2, 3)(
        jnp.asarray(movers), jnp.asarray(m))]
    got = tsh.exchange_movers(
        {d: torch.from_numpy(movers[d]) for d in range(N_DEV)},
        {d: torch.tensor(int(m[d])) for d in range(N_DEV)},
        {d: tsh.slab_origin(tp, nx_local, d) for d in range(N_DEV)},
        tsh.slab_width(tp, nx_local), mig_cap, _mesh(N_DEV))

    def rows(merged, live):
        return {int(r[6]): tuple(r) for r in merged[:, live].T}

    given = {}
    for d in range(N_DEV):
        given.update(rows(movers[d], np.arange(cap) < m[d]))
    total_lost = 0
    for d in range(N_DEV):
        merged, live, lost = (a.numpy() for a in got[d])
        assert merged.shape == want[0][d].shape
        assert int(lost) == int(want[2][d])
        g, w = rows(merged, live), rows(want[0][d], want[1][d])
        # every row keeps its values and the stayers are the same; slab 1's
        # leavers exceed mig_cap, and past it each package ships its own
        # first mig_cap of them
        assert all(given[i] == r for i, r in g.items())
        assert len(g) == len(w)
        assert {i for i in g if i // 100 == d} == {i for i in w
                                                   if i // 100 == d}
        if d not in (0, 2):
            assert g == w
        total_lost += int(lost)
    assert total_lost == 4


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def test_sharded_inc_smoke_matches_jax():
    """tests/test_sharded_smoke.py on the port: 2 slabs, ~500 particles, 5
    steps of pallas_inc against the reference's unsharded full rebuild;
    nothing lost, both counters 0."""
    jp, js = jfs.scenes.dam_break(n=500, dim=2, jitter=0.2, seed=3)
    tp, ts = _port(jp, js)
    sim = tsh.ShardedSim(tp, ts, mesh=_mesh(2), method="pallas_inc")
    sim.step(5)
    g = sim.gather()                      # raises if particles were lost
    ref = jfs.run(js, jp, 5, method="pallas")
    rp = np.asarray(ref.pos)[np.argsort(np.asarray(ref.ids))]
    assert np.abs(g.pos.numpy() - rp).max() < 1e-5
    assert _counters(sim.sstate) == (0, 0)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_matches_unsharded(n_dev):
    tp, ts = tfs.scenes.dam_break(n=1200, dim=2, jitter=0.2, seed=7,
                                  device="cpu")
    sim = tsh.ShardedSim(tp, ts, mesh=_mesh(n_dev))
    sim.step(25)
    g = sim.gather()
    assert np.abs(g.pos.numpy() - _ref_pos(ts, tp, 25)).max() < 1e-5
    assert _counters(sim.sstate) == (0, 0)


def test_sharded_inc_cont_matches_unsharded():
    """The continuity tier: the carried rho's ghost lanes and re-sums on
    each slab give the unsharded pallas_inc_cont trajectory."""
    tp, ts = tfs.scenes.dam_break(n=1200, dim=2, jitter=0.2, seed=7,
                                  device="cpu")
    sim = tsh.ShardedSim(tp, ts, mesh=_mesh(2), method="pallas_inc_cont")
    sim.step(25)
    g = sim.gather()
    want = _ref_pos(ts, tp, 25, "pallas_inc_cont")
    assert np.abs(g.pos.numpy() - want).max() < 1e-5
    assert _counters(sim.sstate) == (0, 0)


def test_sharded_inc_matches_unsharded_3d():
    tp, ts = tfs.scenes.dam_break(n=350, dim=3, jitter=0.2, seed=5,
                                  device="cpu")
    sim = tsh.ShardedSim(tp, ts, mesh=_mesh(2), method="pallas_inc")
    sim.step(8)
    g = sim.gather()
    assert np.abs(g.pos.numpy() - _ref_pos(ts, tp, 8)).max() < 1e-5
    assert _counters(sim.sstate) == (0, 0)


def _crossers(tp, ts, n_dev, speed):
    """Particles 0 and 1 moved next to the slab 0/1 face, flying above the
    fluid toward it from either side, apart in y."""
    _, nxl = tsh.local_params(tp, n_dev)
    xb = tp.bounds_min[0] + nxl * tp.cell
    v = speed * tp.cell / tp.dt
    pos = ts.pos.clone()
    vel = ts.vel.clone()
    pos[0] = torch.tensor([xb - 0.4 * tp.cell, 0.86])
    vel[0] = torch.tensor([v, 0.0])
    pos[1] = torch.tensor([xb + 0.4 * tp.cell, 0.95])
    vel[1] = torch.tensor([-v, 0.0])
    return tfs.make_state(pos, vel, device="cpu")


@pytest.mark.parametrize("method", ["pallas", "pallas_inc",
                                    "pallas_inc_cont"])
def test_crossers_migrate(method):
    """Two particles crossing the slab 0/1 face, one each way, end on the
    neighbour slab; the run matches the unsharded one (on the continuity
    tier the mover carries its rho across)."""
    tp, ts = tfs.scenes.dam_break(n=700, dim=2, jitter=0.2, seed=3,
                                  device="cpu")
    st = _crossers(tp, ts, 2, 0.25)
    sim = tsh.ShardedSim(tp, st, mesh=_mesh(2), method=method)
    before = _slab_ids(sim.sstate)
    assert 0 in before[0] and 1 in before[1]
    sim.step(10)
    after = _slab_ids(sim.sstate)
    assert 0 in after[1], "the rightward particle did not reach slab 1"
    assert 1 in after[0], "the leftward particle did not reach slab 0"
    g = sim.gather()
    want = _ref_pos(st, tp, 10, "pallas_inc_cont"
                    if method == "pallas_inc_cont" else "pallas")
    assert np.abs(g.pos.numpy() - want).max() < 1e-5
    assert _counters(sim.sstate) == (0, 0)


def test_sharded_inc_mig_overflow_observable():
    """Four rightward crossers in distinct cells against mig_cap 2: two
    ship, two are lost and counted in mig_overflow, not in overflow."""
    tp, _ = tfs.scenes.dam_break(n=800, dim=2, device="cpu")
    tp = tp.replace(gravity=(0.0, 0.0))
    _, nxl = tsh.local_params(tp, 2)
    xb = tp.bounds_min[0] + nxl * tp.cell
    v = 0.6 * tp.cell / tp.dt
    ys = [0.2, 0.35, 0.5, 0.65]
    st = tfs.make_state([[xb - 0.5 * tp.cell, y] for y in ys],
                        [[v, 0.0]] * 4, device="cpu")
    sstate, _ = tsh.distribute(tp, st, _mesh(2), n_cap=256, m_cap=16)
    out = tsh.run_sharded_inc(sstate, tp, _mesh(2), n_steps=3, mig_cap=2)
    assert _counters(out) == (0, 2)


def test_ghost_interaction_across_boundary():
    """Two particles within h of each other across the slab 0/1 face
    repel: the pressure reaches through the ghost lanes."""
    tp, _ = tfs.scenes.dam_break(n=800, dim=2, device="cpu")
    tp = tp.replace(gravity=(0.0, 0.0))
    _, nxl = tsh.local_params(tp, 4)
    xb = tp.bounds_min[0] + nxl * tp.cell
    eps = 0.2 * tp.h
    st = tfs.make_state([[xb - eps, 0.5], [xb + eps, 0.5]], device="cpu")
    for method in ("pallas", "pallas_inc"):
        sim = tsh.ShardedSim(tp, st, mesh=_mesh(4), n_cap=256, m_cap=16,
                             method=method)
        sim.step(5)
        p = sim.gather().pos.numpy()
        assert abs(p[1, 0] - p[0, 0]) > 2 * eps, method


@pytest.mark.parametrize("method", ["pallas", "pallas_inc"])
def test_single_slab_mesh(method):
    tp, ts = tfs.scenes.dam_break(n=600, dim=2, device="cpu")
    sim = tsh.ShardedSim(tp, ts, mesh=_mesh(1), method=method)
    sim.step(10)
    g = sim.gather()
    assert np.abs(g.pos.numpy() - _ref_pos(ts, tp, 10)).max() < 1e-6
    assert np.array_equal(g.ids.numpy(), np.arange(ts.n))


def test_gather_raises_on_a_lost_id():
    tp, ts = tfs.scenes.dam_break(n=300, dim=2, device="cpu")
    sim = tsh.ShardedSim(tp, ts, mesh=_mesh(2))
    ids = sim.sstate.ids[0].clone()
    ids[torch.nonzero(ids >= 0)[0]] = -1
    sim.sstate = sim.sstate._replace(ids=(ids, sim.sstate.ids[1]))
    with pytest.raises(RuntimeError, match="lost particles"):
        sim.gather()


def test_mesh_and_alone_step_guards():
    """A mesh may repeat a device; a slab alone (one card, or a mesh of
    one slab) steps without an exchange, and ``step_planes`` is
    ``step_phases`` driven by lockstep over it; lockstep refuses slabs
    that part ways; the ops never import the mesh package."""
    mesh = _mesh(3)
    assert mesh.size == 3 and mesh.local == (0, 1, 2)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert tmesh.init_distributed() is False
    assert tsh.make_exchange(_mesh(1), 10) is None
    tp, ts = tfs.scenes.dam_break(n=300, dim=2, device="cpu")
    geom = tpm.geometry(tp)
    m_cap = tinc.mover_capacity(ts.n)
    s = tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom)
    alone = tinc.step_planes(s, tp, geom, m_cap)
    s = tinc.to_planes(ts.pos, ts.vel, ts.ids, tp, geom)
    stepped = tmesh.lockstep({0: tinc.step_phases(s, tp, geom, m_cap)})[0]
    for a, b in zip(alone, stepped):
        assert (a is None and b is None) or torch.equal(a, b)

    def one(k):
        for _ in range(k):
            yield (lambda p: p), None
        return k
    with pytest.raises(RuntimeError, match="different exchanges"):
        tmesh.lockstep({0: one(1), 1: one(2)})
    assert tmesh.lockstep({0: one(2), 1: one(2)}) == {0: 2, 1: 2}
    with pytest.raises(RuntimeError, match="exchange"):
        tsph.one_slab(one(1))
    code = ("import sys; import gpufluidsimulator_torch.ops.inc, "
            "gpufluidsimulator_torch.models.solver; "
            "print(any(m.startswith('gpufluidsimulator_torch.parallel') "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=str(pathlib.Path(__file__).parents[1]))
    assert out.stdout.strip() == "False"


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_sharded_checkpoint_resume_bitwise(tmp_path):
    """save_sharded / load_sharded in the middle of a run resumes it
    bitwise (no gather in the snapshot path)."""
    tp, ts = tfs.scenes.dam_break(n=900, dim=2, jitter=0.2, seed=2,
                                  device="cpu")
    mesh = _mesh(4)
    sstate, m_cap = tsh.distribute(tp, ts, mesh)
    full = tsh.run_sharded(sstate, tp, mesh, 20, m_cap)
    half = tsh.run_sharded(sstate, tp, mesh, 10, m_cap)
    path = str(tmp_path / "shard.npz")
    tckpt.save_sharded(path, half, tp, step=10, n_total=ts.n)
    loaded, tp2, step, n_total = tckpt.load_sharded(path, mesh)
    assert (step, n_total) == (10, ts.n) and tp2 == tp
    resumed = tsh.run_sharded(loaded, tp2, mesh, 10, m_cap)
    for a, b in zip(full, resumed):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_sharded_checkpoint_across_packages(tmp_path):
    """A file that either package writes loads in the other, equal."""
    jp, js = jfs.scenes.dam_break(n=500, dim=2, jitter=0.2, seed=6)
    tp, ts = _port(jp, js)
    jstate, _ = jsh.distribute(jp, js, jsh.make_mesh(2))
    tstate, _ = tsh.distribute(tp, ts, _mesh(2))
    jfile, tfile = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_sharded(jfile, jstate, jp, step=7, n_total=js.n)
    tckpt.save_sharded(tfile, tstate, tp, step=7, n_total=ts.n)
    got, tp2, step, n_total = tckpt.load_sharded(jfile, _mesh(2))
    assert (step, n_total) == (7, ts.n)
    assert dataclasses.asdict(tp2) == dataclasses.asdict(jp)
    back, jp2, step, n_total = jckpt.load_sharded(tfile, jsh.make_mesh(2))
    assert (step, n_total) == (7, ts.n) and jp2 == jp
    for f in tsh.ShardedState._fields:
        want = np.asarray(getattr(jstate, f))
        assert np.array_equal(np.stack([t.numpy() for t in getattr(got, f)]),
                              want), f
        assert np.asarray(getattr(back, f)).dtype == want.dtype
        assert np.array_equal(np.asarray(getattr(back, f)), want), f


def test_load_sharded_refuses_another_slab_count(tmp_path):
    tp, ts = tfs.scenes.dam_break(n=300, dim=2, device="cpu")
    sstate, _ = tsh.distribute(tp, ts, _mesh(2))
    path = str(tmp_path / "s.npz")
    tckpt.save_sharded(path, sstate, tp, step=1, n_total=ts.n)
    with pytest.raises(ValueError, match="2 slabs"):
        tckpt.load_sharded(path, _mesh(4))


def _wide_scene(seed=5):
    """A 2D domain 8 wide, so 2 slabs hold 164 x cells each, two x tiles
    (the last partly filled): particles around the tile boundary inside
    slab 0 and around the slab face, moving about a third of a cell a
    step in numpy-seeded directions."""
    tp, _ = tfs.scenes.dam_break(n=900, dim=2, device="cpu")
    tp = tp.replace(bounds_min=(0.0, 0.0), bounds_max=(8.0, 1.0))
    _, nxl = tsh.local_params(tp, 2)
    rng = np.random.default_rng(seed)
    dx = tpm.lattice_dx(tp)
    boxes = []
    for xc in (126 * tp.cell, nxl * tp.cell):
        xs = np.arange(xc - 0.15, xc + 0.15, dx)
        ys = np.arange(0.05, 0.3, dx)
        boxes.append(np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2))
    pos = np.concatenate(boxes) + rng.uniform(-0.1, 0.1, (1, 2)) * dx
    vel = rng.normal(size=pos.shape) * (0.3 * tp.cell / tp.dt)
    return tp, nxl, tfs.make_state(pos, vel, device="cpu")


@pytest.mark.parametrize("method", ["pallas", "pallas_inc"])
def test_sharded_multi_tile_slabs(method):
    """Slabs of two x tiles: the ghost lane sits beside the partly filled
    last tile (lane ``last_lane + 1``), the halo lanes between the tiles
    come from halo_x; against the unsharded run, ids conserved."""
    tp, nxl, st = _wide_scene()
    assert tpm.geometry(tsh.local_params(tp, 2)[0]).n_bx == 2
    assert nxl % tpm.TILE_X != 0
    sim = tsh.ShardedSim(tp, st, mesh=_mesh(2), method=method)
    assert all(len(s) > 0 for s in _slab_ids(sim.sstate))
    sim.step(6)
    g = sim.gather()
    assert np.abs(g.pos.numpy() - _ref_pos(st, tp, 6)).max() < 1e-5
    assert _counters(sim.sstate) == (0, 0)
