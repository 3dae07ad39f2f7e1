"""Spatial domain decomposition: x slabs, ghost-lane exchange, migration.

Counterpart: ``gpufluidsimulator_tpu/parallel/sharded.py``.  Each slab of
the mesh owns an x slab of the global cell grid (``nx_local`` cells) and a
fixed-capacity particle array (``n_cap`` slots; free slots are inactive:
id -1, position parked at the sentinel).  Every step:

  1. migration (``run_sharded``): particles that left the slab are grouped
     by a sort of their group key, packed into two (m_cap) buffers and
     sent to the neighbours, where they land in the free tail slots;
     capacity misses count into ``mig_overflow``;
  2. the slab's own binning, the ghost-lane exchange (``make_exchange``:
     the outermost halo lanes of the rank planes from the neighbours' edge
     cells), the sweeps, and integration against the GLOBAL walls.

``run_sharded_inc`` carries each slab's rank planes across steps
(``ops/inc.py``) and ships only the slab-leaving movers.

The reference runs one program per device, in which ``ppermute`` is a
collective.  Here the slabs of one process step in lock step
(``mesh.lockstep``): each slab's step is a generator that yields at its
exchanges, and each exchange runs over all the process's slabs at once, as
tensor copies between slabs of the process and ``torch.distributed`` P2P
between processes.  Nothing in a step reads a count on the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.params import SimParams
from ..models.state import State
from ..ops import inc, sph
from ..ops import planes as pm
from .mesh import Mesh, lockstep, make_mesh, shard_leading, shift_pair


def local_params(params: SimParams, n_dev: int) -> Tuple[SimParams, int]:
    """Params whose grid covers ONE x slab of nx_local cells (the walls stay
    global: pass the original params as wall_params)."""
    nx_global = params.grid_res[0]
    nx_local = -(-nx_global // n_dev)
    width = nx_local * params.cell
    hi = list(params.bounds_max)
    hi[0] = params.bounds_min[0] + width
    return params.replace(bounds_max=tuple(hi)), nx_local


def slab_width(params: SimParams, nx_local: int) -> float:
    """A slab's width in float32 (as a Python float), as the reference
    computes it in its traced step."""
    return float(np.float32(nx_local * params.cell))


def slab_origin(params: SimParams, nx_local: int, d: int) -> float:
    """Slab d's x origin, lo + d * width in float32, as the reference's
    ``bounds_min[0] + axis_index * width``."""
    return float(np.float32(params.bounds_min[0])
                 + np.float32(d) * np.float32(slab_width(params, nx_local)))


def _shift(payloads, mesh: Mesh):
    """The lock-step form of ``mesh.shift_pair``: payload (to_right,
    to_left) per slab, each a tuple of tensors -> (from_left, from_right)
    per slab, tuples alike (None at the mesh's edges)."""
    parts = len(next(iter(payloads.values()))[0])
    got = [shift_pair(mesh, {d: p[0][i] for d, p in payloads.items()},
                      {d: p[1][i] for d, p in payloads.items()})
           for i in range(parts)]

    def side(d, j):
        vals = tuple(g[j][d] for g in got)
        return None if vals[0] is None else vals

    return {d: (side(d, 0), side(d, 1)) for d in payloads}


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def migrate_phases(pos, vel, ids, x_origin: float, width: float,
                   m_cap: int, mesh: Mesh):
    """One slab's migration as a generator (one exchange: the two packed
    buffers).  Returns (pos, vel, ids, mig_overflow): the stayers first,
    the arrivals in the ``2 m_cap`` tail slots, every other slot free.
    mig_overflow counts send-buffer misses and stayers found in the
    landing tail (observable; a clean run has 0)."""
    n, d = pos.shape
    dev = pos.device
    active = ids >= 0
    x = pos[:, 0]
    x_end = float(np.float32(x_origin) + np.float32(width))
    go_l = active & (x < x_origin)
    go_r = active & (x >= x_end)
    # stayers (0) < leavers left (1) < leavers right (2) < free (3); the
    # order within a group is irrelevant (stayers are rebinned, leavers
    # land in arbitrary free tail slots)
    key = go_l.to(torch.int32) + 2 * go_r.to(torch.int32) \
        + torch.where(active, 0, 3).to(torch.int32)
    key, order = torch.sort(key, stable=True)
    pos, vel, ids = pos[order], vel[order], ids[order]
    n_stay = torch.sum(key == 0)
    n_l = torch.sum(key == 1)
    n_r = torch.sum(key == 2)
    ar = torch.arange(m_cap, device=dev)
    vals = torch.cat([pos, vel], dim=1)                     # (N, 2d)

    def pack(start, count):
        mask = ar < torch.clamp_max(count, m_cap)
        take = torch.clamp(start + ar, 0, n - 1)
        return (torch.where(mask[:, None], vals[take], 0.0),
                torch.where(mask, ids[take], -1))

    buf_l = pack(n_stay, n_l)
    buf_r = pack(n_stay + n_l, n_r)
    mig_ovf = (torch.clamp_min(n_l - m_cap, 0)
               + torch.clamp_min(n_r - m_cap, 0)).to(torch.int32)

    # everything past the stayers is free now (leavers shipped)
    live = torch.arange(n, device=dev) < n_stay
    ids = torch.where(live, ids, -1)
    pos = torch.where(live[:, None], pos, pm.SENTINEL)
    vel = torch.where(live[:, None], vel, 0.0)

    if mesh.size > 1:
        from_left, from_right = yield (functools.partial(_shift, mesh=mesh),
                                       (buf_r, buf_l))
    else:
        from_left = from_right = None
    none = (torch.zeros_like(buf_l[0]), torch.full_like(buf_l[1], -1))
    # the right-going buffer lands from the left neighbour, then the
    # left-going one from the right neighbour
    arrived = [none if b is None else b for b in (from_left, from_right)]
    arr_vals = torch.cat([a[0] for a in arrived])           # (2m, 2d)
    arr_ids = torch.cat([a[1] for a in arrived])
    arr_mask = arr_ids >= 0
    # landing slots must be free: count any stayer still in the tail
    mig_ovf = mig_ovf + torch.sum(
        (torch.arange(n, device=dev) >= n - 2 * m_cap) & live) \
        .to(torch.int32)
    tail = slice(n - 2 * m_cap, n)
    pos[tail] = torch.where(arr_mask[:, None], arr_vals[:, :d], pm.SENTINEL)
    vel[tail] = torch.where(arr_mask[:, None], arr_vals[:, d:], 0.0)
    ids[tail] = torch.where(arr_mask, arr_ids, -1)
    return pos, vel, ids, mig_ovf


def migrate(pos, vel, ids, x_origin, width: float, m_cap: int, mesh: Mesh):
    """Ship the particles that left each slab to its neighbour (the
    reference's ``migrate``, for the slabs of this process at once).

    ``pos``, ``vel``, ``ids`` and ``x_origin`` are dicts keyed by the
    slabs of this process.  Returns, per slab, (pos, vel, ids,
    mig_overflow)."""
    return lockstep({d: migrate_phases(pos[d], vel[d], ids[d], x_origin[d],
                                       width, m_cap, mesh)
                     for d in pos})


# ---------------------------------------------------------------------------
# slab-crossing movers (run_sharded_inc)
# ---------------------------------------------------------------------------

def exchange_movers(movers, m, x_origin, width: float, mig_cap: int,
                    mesh: Mesh):
    """Ship slab-leaving movers to the x-neighbour slabs, as the reference's
    ``exchange_movers`` (inc.py:1067-1119) does over ICI: only a particle
    that changed cell can have crossed a slab face, so two (nf, mig_cap)
    buffers a slab carry the migration (nf = 7, or 8 with the continuity
    tier's rho; the id stays row 6; ``inc.pack_movers`` /
    ``inc.merge_movers`` are the slab's halves around the transfer).

    ``movers``, ``m`` and ``x_origin`` are dicts keyed by the slabs of this
    process: each slab's compacted movers, their live count and its x
    origin (a float32 value as a Python float); ``width`` the slab width
    (float32 value).  Returns, per slab, (merged (nf, M + 2 mig_cap), live
    mask, lost), lost the leavers past ``mig_cap`` (() int32).  No count
    leaves the device."""
    packed = {}
    for d in movers:
        x_end = float(np.float32(x_origin[d]) + np.float32(width))
        packed[d] = inc.pack_movers(movers[d], m[d], x_origin[d], x_end,
                                    mig_cap)
    from_left, from_right = shift_pair(
        mesh, {d: p[2] for d, p in packed.items()},
        {d: p[1] for d, p in packed.items()})
    out = {}
    for d, (rows, _, _, lost) in packed.items():
        merged, live = inc.merge_movers(rows, from_left[d], from_right[d],
                                        mig_cap)
        out[d] = (merged, live, lost)
    return out


def _ship_movers(payloads, width: float, mig_cap: int, mesh: Mesh):
    """``exchange_movers`` over ``inc.step_phases``' payloads (movers, m,
    x_origin) of each slab."""
    return exchange_movers({d: p[0] for d, p in payloads.items()},
                           {d: p[1] for d, p in payloads.items()},
                           {d: p[2] for d, p in payloads.items()},
                           width, mig_cap, mesh)


# ---------------------------------------------------------------------------
# ghost-lane exchange
# ---------------------------------------------------------------------------

class SlabExchange:
    """The exchanges of a mesh of two or more slabs, as the step
    generators (``inc.step_phases``, ``sph.pallas_phases``) yield them.

    Ghost lanes (``fields``), the cross-slab twin of ``planes.halo_x``:
    fill the outermost halo lanes of each slab's plane stack (F, K, pz,
    n_bx, py, 128) from the neighbours' edge cells, in place.  The
    rightmost interior cell sits at lane ``last_lane`` of the last tile
    (the tile may be partly filled), its halo lane one to the right; the
    leftmost is lane 1 of tile 0.  At the mesh's edges the lanes get the
    sentinel in the first ``n_pos_fields`` channels and 0 in the others.

    Movers (``movers``): ``exchange_movers`` between the slabs."""

    def __init__(self, mesh: Mesh, nx_local: int):
        self.mesh = mesh
        self.last_lane = (nx_local - 1) % pm.TILE_X + 1

    def __call__(self, stacks, n_pos_fields: int):
        """``stacks``: a dict keyed by this process's slabs.  Returns it,
        its stacks filled."""
        ll = self.last_lane
        from_left, from_right = shift_pair(
            self.mesh, {d: s[..., -1, :, ll] for d, s in stacks.items()},
            {d: s[..., 0, :, 1] for d, s in stacks.items()})
        for d, s in stacks.items():
            for dst, src in ((s[..., 0, :, 0], from_left[d]),
                             (s[..., -1, :, ll + 1], from_right[d])):
                if src is None:
                    dst[:n_pos_fields] = pm.SENTINEL
                    dst[n_pos_fields:] = 0.0
                else:
                    dst.copy_(src)
        return stacks

    def fields(self, n_pos_fields: int):
        """The ghost-lane exchange of stacks with ``n_pos_fields``
        position channels, as ``mesh.lockstep`` calls it."""
        return functools.partial(self, n_pos_fields=n_pos_fields)

    def movers(self, width: float, mig_cap: int):
        """The mover exchange of slabs ``width`` wide through buffers of
        ``mig_cap`` rows, as ``mesh.lockstep`` calls it."""
        return functools.partial(_ship_movers, width=width, mig_cap=mig_cap,
                                 mesh=self.mesh)


def make_exchange(mesh: Mesh, nx_local: int) -> Optional[SlabExchange]:
    """The exchanges of ``mesh``, whose slabs hold ``nx_local`` cells, or
    None for one slab (``SlabExchange``)."""
    if mesh.size == 1:
        return None
    return SlabExchange(mesh, nx_local)


# ---------------------------------------------------------------------------
# sharded state / step / rollout
# ---------------------------------------------------------------------------

class ShardedState(NamedTuple):
    """Per-slab state: entry d of each field is slab d's tensor on its
    device, or None where another process owns slab d; id -1 = free
    slot."""
    pos: tuple           # (N_cap, d) per slab
    vel: tuple           # (N_cap, d)
    rho: tuple           # (N_cap,)
    pres: tuple          # (N_cap,)
    ids: tuple           # (N_cap,) int32
    overflow: tuple      # () int32 cell-capacity drops
    mig_overflow: tuple  # () int32 migration capacity misses


def _local_step(pos, vel, ids, params: SimParams, params_loc: SimParams,
                nx_local: int, m_cap: int, x_origin: float, exchange,
                mesh: Mesh):
    pos, vel, ids, mig_ovf = yield from migrate_phases(
        pos, vel, ids, x_origin, slab_width(params, nx_local), m_cap, mesh)
    out = yield from sph.pallas_phases(
        pos, vel, ids, params_loc, x_origin=x_origin, active=ids >= 0,
        exchange=exchange, wall_params=params)
    return (*out, mig_ovf)


def _slabs(mesh: Mesh, values: dict) -> tuple:
    return tuple(values.get(d) for d in range(mesh.size))


def run_sharded(sstate: ShardedState, params: SimParams, mesh: Mesh,
                n_steps: int, m_cap: int) -> ShardedState:
    """Advance ``n_steps``: every step migrates, then runs the full-rebuild
    step on each slab, the slabs of this process in lock step."""
    params_loc, nx_local = local_params(params, mesh.size)
    exchange = make_exchange(mesh, nx_local)
    local = mesh.local
    x0 = {d: slab_origin(params, nx_local, d) for d in local}
    cur = {d: (sstate.pos[d], sstate.vel[d], sstate.ids[d]) for d in local}
    rho = {d: sstate.rho[d] for d in local}
    pres = {d: sstate.pres[d] for d in local}
    ovf = {d: sstate.overflow[d] for d in local}
    mig = {d: sstate.mig_overflow[d] for d in local}
    for _ in range(n_steps):
        out = lockstep({d: _local_step(*cur[d], params, params_loc,
                                       nx_local, m_cap, x0[d], exchange,
                                       mesh)
                        for d in local})
        for d, (p, v, r, pr, i, o, mg) in out.items():
            cur[d] = (p, v, i)
            rho[d], pres[d] = r, pr
            # the counters accumulate over the steps (observable)
            ovf[d] = ovf[d] + o
            mig[d] = mig[d] + mg
    return ShardedState(
        pos=_slabs(mesh, {d: c[0] for d, c in cur.items()}),
        vel=_slabs(mesh, {d: c[1] for d, c in cur.items()}),
        rho=_slabs(mesh, rho), pres=_slabs(mesh, pres),
        ids=_slabs(mesh, {d: c[2] for d, c in cur.items()}),
        overflow=_slabs(mesh, ovf), mig_overflow=_slabs(mesh, mig))


def run_sharded_inc(sstate: ShardedState, params: SimParams, mesh: Mesh,
                    n_steps: int, mig_cap: Optional[int] = None,
                    continuity: bool = False) -> ShardedState:
    """Advance ``n_steps`` on the incremental (planes-resident) path.

    Each slab's rank planes are the carried state (one ``inc.to_planes``
    per call, not per step); the ghost lanes and the slab-crossing movers
    go to the neighbours at the step's exchanges (``inc.step_phases``):
    two (7, mig_cap) mover buffers a slab per step, where ``run_sharded``
    repacks the particle array.  Physics-capacity losses (movers, arrival
    ranks, cell ranks) accumulate into ``overflow``, mover-buffer misses
    into ``mig_overflow``: the two failure modes stay apart, as on
    ``run_sharded``.  ``continuity``: the carried-density tier, whose rho
    rides as an 8th plane and mover channel over the same exchanges."""
    params_loc, nx_local = local_params(params, mesh.size)
    params_loc = params_loc.replace(diagnostics=False)
    geom = pm.geometry(params_loc)
    local = mesh.local
    n_cap, d = sstate.pos[local[0]].shape
    mv_cap = inc.mover_capacity(n_cap)
    if mig_cap is None:
        mig_cap = max(128, n_cap // 64)
    exchange = make_exchange(mesh, nx_local)
    x0 = {s: slab_origin(params, nx_local, s) for s in local}
    states = {s: inc.to_planes(sstate.pos[s], sstate.vel[s], sstate.ids[s],
                               params_loc, geom, x_origin=x0[s],
                               active=sstate.ids[s] >= 0,
                               continuity=continuity)
              for s in local}
    for _ in range(n_steps):
        states = lockstep({s: inc.step_phases(
            states[s], params_loc, geom, mv_cap, x_origin=x0[s],
            exchange=exchange, wall_params=params, mig_cap=mig_cap)
            for s in local})
    out = {f: {} for f in ShardedState._fields}
    for s in local:
        sn = states[s]
        vals, cnt = inc.to_flat(sn, params_loc, geom, n_cap)
        dev = vals.device
        live = torch.arange(vals.shape[1], device=dev) < cnt
        out["pos"][s] = torch.stack(
            [torch.where(live, vals[c], pm.SENTINEL) for c in range(d)],
            dim=-1)[:n_cap]
        out["vel"][s] = torch.stack(
            [torch.where(live, vals[3 + c], 0.0) for c in range(d)],
            dim=-1)[:n_cap]
        out["ids"][s] = torch.where(live, vals[6].to(torch.int32),
                                    -1)[:n_cap]
        out["rho"][s] = torch.full((n_cap,), params.rest_density,
                                   dtype=torch.float32, device=dev)
        out["pres"][s] = torch.zeros((n_cap,), dtype=torch.float32,
                                     device=dev)
        out["overflow"][s] = sstate.overflow[s] + sn.overflow
        out["mig_overflow"][s] = sstate.mig_overflow[s] + sn.mig_overflow
    return ShardedState(**{f: _slabs(mesh, v) for f, v in out.items()})


# ---------------------------------------------------------------------------
# host-side distribute / gather
# ---------------------------------------------------------------------------

def _slab_arrays(params: SimParams, state: State, n_dev: int,
                 n_cap: Optional[int] = None, m_cap: Optional[int] = None):
    """Host-side slab packing shared by distribute / distribute_global:
    stacked numpy arrays (n_dev, n_cap, ...) and the migration capacity."""
    _, nx_local = local_params(params, n_dev)
    width = nx_local * params.cell

    pos = state.pos.detach().cpu().numpy()
    vel = state.vel.detach().cpu().numpy()
    ids = state.ids.detach().cpu().numpy()
    dev = np.clip(((pos[:, 0] - params.bounds_min[0]) // width
                   ).astype(np.int64), 0, n_dev - 1)
    counts = np.bincount(dev, minlength=n_dev)
    if m_cap is None:
        m_cap = max(64, int(counts.max()) // 8)
    if n_cap is None:
        n_cap = int(counts.max() * 1.5) + 2 * m_cap
    n_cap = -(-n_cap // 8) * 8

    d = pos.shape[1]
    spos = np.full((n_dev, n_cap, d), pm.SENTINEL, np.float32)
    svel = np.zeros((n_dev, n_cap, d), np.float32)
    sids = np.full((n_dev, n_cap), -1, np.int32)
    for dd in range(n_dev):
        sel = dev == dd
        c = int(sel.sum())
        if c > n_cap - 2 * m_cap:
            raise ValueError(f"slab {dd} over capacity: {c} > "
                             f"{n_cap - 2 * m_cap}")
        spos[dd, :c] = pos[sel]
        svel[dd, :c] = vel[sel]
        sids[dd, :c] = ids[sel]
    z = np.zeros((n_dev, n_cap), np.float32)
    zi = np.zeros((n_dev,), np.int32)
    arrays = dict(pos=spos, vel=svel, rho=z, pres=z.copy(), ids=sids,
                  overflow=zi, mig_overflow=zi.copy())
    return arrays, m_cap


def distribute(params: SimParams, state: State, mesh: Mesh,
               n_cap: Optional[int] = None,
               m_cap: Optional[int] = None) -> Tuple[ShardedState, int]:
    """Split a global State into per-slab fixed-capacity slabs, each on its
    device.  Returns (ShardedState, m_cap)."""
    arrays, m_cap = _slab_arrays(params, state, mesh.size, n_cap, m_cap)
    return ShardedState(**{k: shard_leading(mesh, v)
                           for k, v in arrays.items()}), m_cap


def distribute_global(params: SimParams, state: State, mesh: Mesh,
                      n_cap: Optional[int] = None,
                      m_cap: Optional[int] = None
                      ) -> Tuple[ShardedState, int]:
    """Multi-process distribute: every process computes the same slab
    arrays from the replicated State and keeps only its own slabs
    (``shard_leading``), as the reference's ``make_array_from_callback``
    does.  In the port ``distribute`` does the same, so the two are one."""
    return distribute(params, state, mesh, n_cap, m_cap)


def gather(sstate: ShardedState, n_total: int) -> State:
    """Collect a ShardedState into one global State in id (spawn) order, on
    the device of this process's first slab.  Across processes every
    process must call it (an all-gather).  Raises ``RuntimeError`` if the
    live particles are not ``n_total``."""
    fields = ("pos", "vel", "rho", "pres", "ids", "overflow")
    mine = {d: tuple(getattr(sstate, f)[d].detach().cpu().numpy()
                     for f in fields)
            for d, p in enumerate(sstate.pos) if p is not None}
    device = next(p.device for p in sstate.pos if p is not None)
    slabs = dict(mine)
    if len(mine) < len(sstate.pos):
        every = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(every, mine)
        for part in every:
            slabs.update(part)
    order_d = sorted(slabs)
    pos, vel, rho, pres, ids = (
        np.concatenate([slabs[d][i] for d in order_d]) for i in range(5))
    overflow = int(sum(int(slabs[d][5]) for d in order_d))
    live = ids >= 0
    if int(live.sum()) != n_total:
        raise RuntimeError(f"lost particles: {int(live.sum())} live ids, "
                           f"expected {n_total}")
    order = np.argsort(ids[live])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return State(pos=t(pos[live][order]), vel=t(vel[live][order]),
                 rho=t(rho[live][order]), pres=t(pres[live][order]),
                 ids=t(ids[live][order]),
                 overflow=torch.tensor(overflow, dtype=torch.int32,
                                       device=device))


SHARDED_METHODS = ("pallas", "pallas_inc", "pallas_inc_cont")


class ShardedSim:
    """Facade mirroring FluidSim for the sharded path."""

    def __init__(self, params: SimParams, state: State,
                 mesh: Optional[Mesh] = None,
                 n_cap: Optional[int] = None,
                 m_cap: Optional[int] = None,
                 method: str = "pallas"):
        if method not in SHARDED_METHODS:
            raise ValueError(f"unknown sharded method {method!r}")
        self.params = params
        self.mesh = mesh or make_mesh()
        self.n_total = state.n
        self.method = method
        self.sstate, self.m_cap = distribute(params, state, self.mesh,
                                             n_cap, m_cap)

    def step(self, n: int = 1) -> ShardedState:
        if self.method in ("pallas_inc", "pallas_inc_cont"):
            self.sstate = run_sharded_inc(
                self.sstate, self.params, self.mesh, n,
                continuity=self.method == "pallas_inc_cont")
        else:
            self.sstate = run_sharded(self.sstate, self.params, self.mesh,
                                      n, self.m_cap)
        return self.sstate

    def gather(self) -> State:
        return gather(self.sstate, self.n_total)
