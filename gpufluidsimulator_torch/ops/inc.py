"""Incremental binning: the rank planes as the state carried across steps.

Counterpart: ``gpufluidsimulator_tpu/ops/inc.py`` on one card: the
summation-density tier (``method="pallas_inc"``) and the continuity tier
(``method="pallas_inc_cont"``).  The plane stack (6 pos/vel channels + 1 id
channel, + the carried density on the continuity tier) is the state; flat
particle arrays exist only at the API boundary (``to_planes`` /
``to_flat``).  Each step (``step_planes``):

  halo -> occupancy bounds (``occ_rowmax``) -> density sweep (``density``)
  -> fused force + EOS + integrate + collide + mover flag (``force_step``)
  -> mover extraction (``compact``) -> one sort of the movers by target
  cell + a per-cell start table -> ``consolidate`` (kept + arriving ranks
  packed into K dense ranks, ghost slots re-sanitized).

On the continuity tier the density sweep runs only to seed or re-sync the
carried plane (``RESUM_EVERY``); ``force_step_cont`` reads the carried rho
and writes next step's, which rides the movers as an 8th channel and goes
through ``consolidate_rho``.

The reference's arrival planes (a second mover sort and ``place`` in its
``skip_empty`` form, inc.py:625-723) exist because the TPU cannot scatter;
here ``consolidate`` reads the cell-sorted movers directly.  Nothing in
``step_planes`` waits for the host: every count stays a device tensor, as
in the reference's ``lax.scan``.

Hopper kernels of this module: ``compact`` (``csrc/compact.cu``, the
reference's ``_compact_kernel`` + ``_stitch_kernel``) and ``consolidate``
/ ``consolidate_rho`` (``csrc/consolidate.cu``, ``_consolidate_kernel``
without and with ``has_rho``), each beside its plain PyTorch version,
which the wrappers take for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..models.params import SimParams
from ..utils import profiling
from . import physics
from . import planes as pm
from . import sph
from .planes import LANES, SENTINEL, PlaneGeom, own_cid

ARRIVAL_K = 8          # max same-cell arrivals taken per step (the
# reference's K'', equal to the cell capacity K, inc.py:63): the only drop
# condition is then "post-step cell occupancy > K", the full rebuild's
# overflow semantics
TILE = 64 * LANES      # the reference's routing tile (route.TILE): the unit
# the mover and output capacities are rounded to, so both packages size
# their arrays alike
MAX_F32_ID = 2 ** 24   # ids ride the planes as float32: exact below this
MAX_COMPACT_CHANNELS = 8   # channels the CUDA compact takes
# (csrc/compact.cu CMP_MAX_CH)
COMPACT_CHUNK = 4096   # flag slots per block of the CUDA compact
# (csrc/compact.cu CMP_CHUNK)
RESUM_EVERY = 64       # continuity tier, cont_form="rate": steps between
# summation-density re-syncs of the carried plane (the reference's
# inc.py:70); "sum" and "relax" re-anchor in the sweep and resum only at
# age 0.  Read at call time, so it can be patched.
STEP_COUNTERS = ("movers", "flagged", "drops_cell_capacity")   # a step's
# tallies (utils/profiling)


def mover_capacity(n: int) -> int:
    """Mover-array capacity: N/8, at least one tile, rounded up to a whole
    tile.  Excess movers are dropped and counted in ``overflow``."""
    return -(-max(TILE, n // 8) // TILE) * TILE


def _round_tile(n: int) -> int:
    return -(-n // TILE) * TILE


class IncState(NamedTuple):
    """The carried state of the incremental path."""
    fields6: torch.Tensor       # (6, K, pz, n_bx, py, 128) x,y,z,vx,vy,vz
    idp: torch.Tensor           # (K, pz, n_bx, py, 128) particle id as f32
    overflow: torch.Tensor      # () int32 capacity drops (movers, cells)
    mig_overflow: torch.Tensor  # () int32 movers a sharded slab could not
    #                             ship to its neighbour (mig_cap); 0 on one
    #                             card, apart from ``overflow``
    rhop: Optional[torch.Tensor] = None   # continuity tier: the carried
    #                             density plane (K, ...); None otherwise
    age: Optional[int] = None   # continuity tier: steps since to_planes, a
    #                             host int (the resum choice never waits
    #                             for the card); None otherwise


# ---------------------------------------------------------------------------
# slot geometry and mover detection
# ---------------------------------------------------------------------------

def new_cids(fields6: torch.Tensor, params: SimParams, geom: PlaneGeom,
             x_origin=None) -> torch.Tensor:
    """Per-slot linear cell id from the position channels (the elementwise
    form of planes.cell_linear_parts; ``x_origin`` a slab's)."""
    pos = torch.stack([fields6[d].reshape(-1) for d in range(params.dim)],
                      dim=-1)
    return pm.cell_linear_parts(pos, params, geom, x_origin) \
        .reshape(fields6.shape[1:])


def detect_movers(fields6, idp, params: SimParams, geom: PlaneGeom,
                  x_origin=None):
    """-> (kept6, kept_id, flags): ``flags`` marks the interior slots whose
    particle now belongs to another cell; the kept planes have those slots
    and every non-interior slot blanked."""
    valid = (fields6[0] < SENTINEL * 0.5) \
        & pm.interior_mask(geom, fields6.device)[None]
    flags = valid & (new_cids(fields6, params, geom, x_origin)
                     != own_cid(geom, fields6.device)[None])
    keep = valid & ~flags
    fill = torch.tensor([SENTINEL] * 3 + [0.0] * 3, device=fields6.device)
    kept6 = torch.where(keep[None], fields6,
                        fill.reshape((6,) + (1,) * keep.dim()))
    kept_id = torch.where(keep, idp, -1.0)
    return kept6, kept_id, flags


# ---------------------------------------------------------------------------
# kernel 7 (+ 6): flagged compaction
# ---------------------------------------------------------------------------

def compact_plain(channels, flags: torch.Tensor, cap: int):
    """-> (vals (C, cap), min(count, cap), count): the values of the slots
    with flag > 0.5, in slot order, 0 past the count."""
    idx = torch.nonzero(flags.reshape(-1) > 0.5).squeeze(1)
    total = torch.tensor(idx.numel(), dtype=torch.int32, device=flags.device)
    take = idx[:cap]
    vals = torch.zeros((len(channels), cap), dtype=torch.float32,
                       device=flags.device)
    vals[:, :take.numel()] = torch.stack(
        [c.reshape(-1)[take] for c in channels])
    return vals, torch.clamp_max(total, cap), total


def compact_chunks(m: int) -> int:
    """Blocks (chunks of COMPACT_CHUNK flag slots) of the CUDA compact over
    ``m`` slots; the last chunk may be partial."""
    return -(-m // COMPACT_CHUNK)


_compact_scratch = {}


def compact_scratch(device, nb: int) -> torch.Tensor:
    """The CUDA compact's scratch on ``device``: at least 2 + 2 nb int32,
    the chunk ticket, the epoch and one 64-bit status word per chunk.  Made
    zeroed at first use, and again when a call needs more chunks; otherwise
    kept across calls, which never clear it: the kernel's last block resets
    the ticket and advances the epoch that tags the status words.  Calls
    that share it must be ordered on one stream, as the port's are."""
    device = torch.device(device)
    s = _compact_scratch.get(device)
    if s is None or s.numel() < 2 + 2 * nb:
        s = torch.zeros(2 + 2 * nb, dtype=torch.int32, device=device)
        _compact_scratch[device] = s
    return s


def compact(channels, flags: torch.Tensor, cap: int):
    """Flagged compaction: the CUDA kernel ``compact`` on the card, the
    plain version for CPU tensors.  ``channels``: a sequence of single
    channels shaped like ``flags`` (``flags`` float32, > 0.5 = flagged,
    16-byte aligned), read in place, never copied (``[*stack, idp]``
    passes a stack's views).  Returns (vals (C, cap), m, total): m =
    min(total, cap) and total the flagged count, as () int32 tensors on the
    device.  One memset of ``vals`` and one single-pass kernel."""
    if flags.device.type == "cpu":
        return compact_plain(channels, flags, cap)
    if not 1 <= len(channels) <= MAX_COMPACT_CHANNELS:
        raise ValueError(f"the CUDA compact takes 1 to "
                         f"{MAX_COMPACT_CHANNELS} channels, got "
                         f"{len(channels)}")
    _build.check_tensor(flags, "flags", torch.float32, tuple(flags.shape))
    if flags.data_ptr() % 16:
        raise ValueError("flags must be 16-byte aligned")
    for c in channels:
        _build.check_tensor(c, "channel", torch.float32, tuple(flags.shape))
    m = flags.numel()
    nb = compact_chunks(m)
    # one allocation: the rows, then total and m as two int32
    size = len(channels) * cap
    buf = torch.empty(size + 2, dtype=torch.float32, device=flags.device)
    vals = buf[:size].view(len(channels), cap)
    counts = buf[size:].view(torch.int32)
    scratch = compact_scratch(flags.device, nb)
    ptrs = (ctypes.c_void_p * len(channels))(
        *[c.data_ptr() for c in channels])
    _build.launch("compact", flags,
                  ctypes.cast(ptrs, ctypes.c_void_p),
                  ctypes.c_int(len(channels)),
                  _build.ptr(flags), ctypes.c_longlong(m), _build.ptr(vals),
                  ctypes.c_int(cap), _build.ptr(scratch), ctypes.c_int(nb),
                  _build.ptr(counts))
    return vals, counts[1], counts[0]


# ---------------------------------------------------------------------------
# kernel 9: mover re-insertion and consolidation
# ---------------------------------------------------------------------------

class Arrivals(NamedTuple):
    """Movers grouped by target cell: sorted row j is ``movers[:, order[j]]``
    and cell c's arrivals are sorted rows ``starts[c]:starts[c + 1]``."""
    movers: torch.Tensor      # (7, m_cap) f32; (8, m_cap) with rho
    order: torch.Tensor       # (m_cap,) int64
    starts: torch.Tensor      # (cells + 1,) int32


def arrival_planes(movers, m, params: SimParams, geom: PlaneGeom,
                   x_origin=None, live=None) -> Arrivals:
    """Group the first ``m`` mover rows by target cell: one sort of their
    cell ids (dead rows keyed ``cells``, past every cell) and a per-cell
    start table.  The reference's second sort and arrival planes have no
    counterpart: ``consolidate`` reads the movers through ``order``.  All
    ``m_cap`` rows are sorted, where the reference picks a smaller prefix
    when ``m`` fits one (inc.py:702-723): picking it here would read ``m``
    on the host, a wait for the card every step.  A sharded slab passes
    its ``x_origin`` and the ``live`` mask of its merged movers
    (``merge_movers``), whose live rows are no prefix."""
    cap = movers.shape[1]
    pos = movers[:params.dim].T
    cid = pm.cell_linear_parts(pos, params, geom, x_origin)
    if live is None:
        live = torch.arange(cap, device=movers.device) < m
    cid = torch.where(live, cid, geom.cells)
    cid_s, order = torch.sort(cid)
    starts = torch.searchsorted(
        cid_s, torch.arange(geom.cells + 1, dtype=torch.int32,
                            device=movers.device), out_int32=True)
    return Arrivals(movers=movers, order=order, starts=starts)


def consolidate_plain(new6, idp, flagp, arr: Arrivals, geom: PlaneGeom,
                      rhop=None):
    """-> (fields6, idp, dropped): per cell, the kept ranks (valid, interior,
    not flagged; ranks past the first sentinel one are not read) in rank
    order, then up to ARRIVAL_K arrivals, packed into K dense ranks; empty
    ranks get SENTINEL, 0 and -1.  With ``rhop`` (the continuity tier; the
    movers then carry rho in row 7) -> (fields6, idp, rho, dropped), empty
    ranks' rho 0."""
    k, cells = geom.k, geom.cells
    dev = new6.device
    inter = pm.interior_mask(geom, dev).reshape(1, cells)
    ext = [new6.reshape(6, k, cells), idp.reshape(1, k, cells)]
    if rhop is not None:
        ext.append(rhop.reshape(1, k, cells))
    ext = torch.cat(ext)
    nf = ext.shape[0]
    upto = torch.cummin((ext[0] < SENTINEL * 0.5).to(torch.int32), dim=0) \
        .values.bool()                          # ranks before a sentinel
    valid_k = upto & inter & (flagp.reshape(k, cells) < 0.5)
    # arrival ranks: row j of the sorted movers is rank j - starts[cell]
    cap = arr.movers.shape[1]
    cid_s = torch.searchsorted(
        arr.starts, torch.arange(cap, dtype=torch.int32, device=dev),
        right=True) - 1
    live = cid_s < cells
    cid_c = torch.clamp_max(cid_s, cells - 1)
    dup = torch.arange(cap, device=dev) - arr.starts[cid_c]
    ok = live & (dup < ARRIVAL_K)
    arr_ext = torch.zeros((nf, ARRIVAL_K, cells), device=dev)
    valid_a = torch.zeros((ARRIVAL_K, cells), dtype=torch.bool, device=dev)
    rows = arr.movers[:, arr.order[ok]]
    arr_ext[:, dup[ok], cid_c[ok]] = rows
    valid_a[dup[ok], cid_c[ok]] = True
    ext = torch.cat([ext, arr_ext], dim=1)                # (nf, K+A, cells)
    valid = torch.cat([valid_k, valid_a])
    rank = torch.cumsum(valid, dim=0) - valid.to(torch.int64)
    keep = valid & (rank < k)
    dropped = (torch.sum(live & ~ok) + torch.sum(valid & ~keep)) \
        .to(torch.int32)
    fill = torch.tensor([SENTINEL] * 3 + [0.0] * 3 + [-1.0, 0.0][:nf - 6],
                        device=dev)
    out = fill[:, None, None].repeat(1, k, cells)
    src, cell = torch.nonzero(keep, as_tuple=True)
    out[:, rank[src, cell], cell] = ext[:, src, cell]
    shape = (k, geom.pz, geom.n_bx, geom.py, LANES)
    planes = [out[:6].reshape((6,) + shape), out[6].reshape(shape)]
    if rhop is not None:
        planes.append(out[7].reshape(shape))
    return (*planes, dropped)


def consolidate(new6, idp, flagp, arr: Arrivals, geom: PlaneGeom,
                rhop=None):
    """Per-cell consolidation: the CUDA kernel ``consolidate`` on the card,
    the plain version for CPU tensors.  Returns (fields6, idp, dropped),
    dropped = sum over cells of max(arrivals - ARRIVAL_K, 0)
    + max(kept + min(arrivals, ARRIVAL_K) - K, 0), a () int32 tensor.
    With ``rhop`` (movers of 8 rows): the kernel ``consolidate_rho``, and
    (fields6, idp, rho, dropped)."""
    if new6.device.type == "cpu":
        return consolidate_plain(new6, idp, flagp, arr, geom, rhop)
    shape = (geom.k, geom.pz, geom.n_bx, geom.py, LANES)
    _build.check_tensor(new6, "new6", torch.float32, (6,) + shape)
    _build.check_tensor(idp, "idp", torch.float32, shape)
    _build.check_tensor(flagp, "flagp", torch.float32, shape)
    cap = arr.movers.shape[1]
    if 8 * geom.k * geom.cells >= 2 ** 31 or 8 * cap >= 2 ** 31:
        raise ValueError(f"the CUDA consolidate indexes with 32 bits: 8 * K "
                         f"* cells = {8 * geom.k * geom.cells} and 8 * m_cap "
                         f"= {8 * cap} must stay below 2^31")
    _build.check_tensor(arr.movers, "movers", torch.float32,
                        (7 if rhop is None else 8, cap))
    _build.check_tensor(arr.order, "order", torch.int64, (cap,))
    _build.check_tensor(arr.starts, "starts", torch.int32,
                        (geom.cells + 1,))
    for t in (new6, idp, flagp, arr.starts, rhop):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the CUDA consolidate reads float4 rows: the "
                             "planes and starts must be 16-byte aligned")
    out6 = torch.empty_like(new6)
    oid = torch.empty_like(idp)
    dropped = torch.zeros((), dtype=torch.int32, device=new6.device)
    tail = [_build.ptr(dropped), *sph._geom_args(geom),
            ctypes.c_int(ARRIVAL_K)]
    if rhop is None:
        _build.launch("consolidate", new6,
                      _build.ptr(new6), _build.ptr(idp), _build.ptr(flagp),
                      _build.ptr(arr.movers), ctypes.c_longlong(cap),
                      _build.ptr(arr.order), _build.ptr(arr.starts),
                      _build.ptr(out6), _build.ptr(oid), *tail)
        return out6, oid, dropped
    _build.check_tensor(rhop, "rhop", torch.float32, shape)
    orho = torch.empty_like(rhop)
    _build.launch("consolidate_rho", new6,
                  _build.ptr(new6), _build.ptr(idp), _build.ptr(rhop),
                  _build.ptr(flagp), _build.ptr(arr.movers),
                  ctypes.c_longlong(cap), _build.ptr(arr.order),
                  _build.ptr(arr.starts), _build.ptr(out6), _build.ptr(oid),
                  _build.ptr(orho), *tail)
    return out6, oid, orho, dropped


# ---------------------------------------------------------------------------
# API-boundary conversions
# ---------------------------------------------------------------------------

def to_planes(pos, vel, ids, params: SimParams, geom: PlaneGeom,
              x_origin=None, active=None,
              continuity: bool = False) -> IncState:
    """Full rebuild (``build_planes`` with the id channel) into the carried
    state; a sharded slab's with its ``x_origin`` and ``active`` rows.
    ``continuity``: attach the continuity tier's carried density,
    zeros at age 0 (the first step's seeding sweep fills it before the EOS
    reads it)."""
    if pos.shape[0] > MAX_F32_ID:
        raise ValueError(f"the planes carry ids as float32, exact for at "
                         f"most {MAX_F32_ID} particles; got {pos.shape[0]}")
    table = pm.build_planes(pos, vel, ids, params, geom, with_ids=True,
                            x_origin=x_origin, active=active)
    profiling.tally(("drops_cell_capacity",), table.overflow)
    idp = table.planes[6]
    return IncState(fields6=table.planes[:6], idp=idp,
                    overflow=table.overflow,
                    mig_overflow=torch.zeros_like(table.overflow),
                    rhop=torch.zeros_like(idp) if continuity else None,
                    age=0 if continuity else None)


def _valid_slots(state: IncState, geom: PlaneGeom) -> torch.Tensor:
    return ((state.fields6[0] < SENTINEL * 0.5)
            & pm.interior_mask(geom, state.fields6.device)[None]) \
        .to(torch.float32)


def to_flat(state: IncState, params: SimParams, geom: PlaneGeom, n: int):
    """Planes -> flat rows (x,y,z,vx,vy,vz,id[,rho]) in slot order and their
    count; callers align by id.  rho comes from one density sweep when
    ``params.diagnostics`` is set, on the continuity tier too: the
    reference does not read the carried plane there (inc.py:1013-1019)."""
    channels = [*state.fields6, state.idp]
    if params.diagnostics:
        halo6 = pm.halo_x(state.fields6)
        occ_q, occ_s = pm.occupancy_bounds(halo6, params, geom)
        channels.append(sph.density_planes(halo6[:3], occ_q, occ_s, params,
                                           geom))
    return compact(channels, _valid_slots(state, geom), _round_tile(n))[:2]


def to_flat_lite(state: IncState, geom: PlaneGeom, n: int):
    """Positions + id only (4 channels): the frame recording of rollouts."""
    return compact([*state.fields6[:3], state.idp],
                   _valid_slots(state, geom), _round_tile(n))[:2]


# ---------------------------------------------------------------------------
# the incremental step
# ---------------------------------------------------------------------------

def resums(state: IncState, params: SimParams) -> bool:
    """Whether the continuity step at ``state.age`` seeds or re-syncs the
    carried rho with a density sweep (a host decision: ``age`` is a host
    int)."""
    if params.cont_form in ("sum", "relax"):
        return state.age == 0
    return state.age % RESUM_EVERY == 0


def step_planes(state: IncState, params: SimParams, geom: PlaneGeom,
                m_cap: int) -> IncState:
    """One SPH step in plane space, on one card (``step_phases`` without
    an exchange).

    Continuity tier (``state.rhop`` set): the EOS reads the carried rho
    plane, and the density sweep runs only when it must seed or re-sync
    it: at age 0 for ``cont_form`` "sum" and "relax", every RESUM_EVERY-th
    age for "rate" (the reference's lax.cond, inc.py:1161-1173, here a
    host branch on the host int ``age``).  ``force_step_cont`` emits next
    step's rho, which rides the movers as channel 7.

    The halo lanes of ``state.fields6`` (and of the carried rho) are
    refilled in place (they hold no particles of their own)."""
    with profiling.span("inc.step"):
        return sph.one_slab(step_phases(state, params, geom, m_cap))


def step_phases(state: IncState, params: SimParams, geom: PlaneGeom,
                m_cap: int, x_origin=None, exchange=None,
                wall_params: SimParams = None, mig_cap: int = 0):
    """``step_planes`` as a generator, the sharded step of one slab
    (``parallel/sharded.py``), as the reference's (inc.py:1122-1221):
    ``x_origin`` is the slab's binning origin, ``wall_params`` holds the
    global walls, and ``exchange`` (``parallel.sharded.SlabExchange``,
    None for a mesh of one slab) is how the slabs talk.  The step yields
    ``(exchange, payload)`` and takes back the exchange's result
    (``parallel.mesh.lockstep``), at
      1. the position / velocity ghost lanes, before the occupancy bounds;
      2. the rho ghost lanes, after ``halo_x``, before the force step;
      3. the slab-leaving movers, after ``compact`` (``mig_cap`` rows each
         way; their loss counted in ``mig_overflow``).
    Without ``exchange`` it yields nothing: one card's step.  Its phases
    are spans (``utils/profiling``), none open across a ``yield``; the
    step's own span is its caller's."""
    continuity = state.rhop is not None
    if exchange is None:
        with profiling.span("inc.bounds"):
            planes6 = pm.halo_x(state.fields6)
            occ_q, occ_s = pm.occupancy_bounds(planes6, params, geom)
    else:
        planes6 = yield exchange.fields(3), pm.halo_x(state.fields6)
        with profiling.span("inc.bounds"):
            occ_q, occ_s = pm.occupancy_bounds(planes6, params, geom)
    with profiling.span("inc.density"):
        if not continuity or resums(state, params):
            rho_p = sph.density_planes(planes6[:3], occ_q, occ_s, params,
                                       geom)
        else:
            rho_p = state.rhop
        rho_h = pm.halo_x(rho_p)
    if exchange is not None:
        rho_h = (yield exchange.fields(0), rho_h[None])[0]
    with profiling.span("inc.force"):
        if continuity:
            new6, rho_new, flagp = sph.accel_step_cont(
                planes6, rho_h, occ_q, occ_s, params, geom, x_origin,
                wall_params)
            channels = [*new6, state.idp, rho_new]
        else:
            new6, flagp = sph.accel_step(planes6, rho_h, occ_q, occ_s,
                                         params, geom, x_origin, wall_params)
            rho_new = None
            channels = [*new6, state.idp]
    # the flagged movers straight out of the unblanked post-step planes
    # (flagp is 0 on every slot that is not interior)
    with profiling.span("inc.compact"):
        movers, m, staged_total = compact(channels, flagp, m_cap)
    live = None
    mig_overflow = state.mig_overflow
    if exchange is not None:
        width = float(np.float32(geom.nx * params.cell))
        movers, live, lost = yield (exchange.movers(width, mig_cap),
                                    (movers, m, x_origin))
        mig_overflow = mig_overflow + lost
    with profiling.span("inc.consolidate"):
        arr = arrival_planes(movers, m, params, geom, x_origin, live)
        *cons, dropped = consolidate(new6, state.idp, flagp, arr, geom,
                                     rho_new)
        overflow = state.overflow + (staged_total - m) + dropped
        profiling.tally(STEP_COUNTERS, m, staged_total, dropped)
    return IncState(fields6=cons[0], idp=cons[1], overflow=overflow,
                    mig_overflow=mig_overflow,
                    rhop=cons[2] if continuity else None,
                    age=state.age + 1 if continuity else None)


# ---------------------------------------------------------------------------
# slab-crossing movers (sharded mode)
# ---------------------------------------------------------------------------

def pack_movers(movers, m, x_origin: float, x_end: float, mig_cap: int):
    """One slab's half of the mover exchange
    (``parallel.sharded.exchange_movers``) before the transfer: group the
    live mover rows into stay / left (x < x_origin) / right (x >= x_end) /
    dead, as the reference's one unstable sort does (here a stable sort of
    the group key and a gather), and pack the first ``mig_cap`` leavers of
    each side into an (nf, mig_cap) buffer that ships ``id + 1`` in row 6,
    so that the zeros a mesh edge receives decode as dead rows.  Returns
    (rows with every non-stayer's id -1, buf_left, buf_right, lost), lost
    the leavers past ``mig_cap`` (a () int32 tensor)."""
    nf, cap = movers.shape
    dev = movers.device
    jdx = torch.arange(cap, device=dev)
    live = jdx < m
    x = movers[0]
    go_l = live & (x < x_origin)
    go_r = live & (x >= x_end)
    key = go_l.to(torch.int32) + 2 * go_r.to(torch.int32) \
        + torch.where(live, 0, 3).to(torch.int32)
    key_s, order = torch.sort(key, stable=True)
    rows = movers[:, order]
    n_stay = torch.sum(key_s == 0)
    n_l = torch.sum(key_s == 1)
    n_r = torch.sum(key_s == 2)
    ar = torch.arange(mig_cap, device=dev)

    def pack(start, count):
        mask = ar < torch.clamp_max(count, mig_cap)
        take = torch.clamp(start + ar, 0, cap - 1)
        buf = torch.where(mask[None, :], rows[:, take], 0.0)
        buf[6] = torch.where(mask, buf[6] + 1.0, 0.0)
        return buf

    buf_l = pack(n_stay, n_l)
    buf_r = pack(n_stay + n_l, n_r)
    lost = (torch.clamp_min(n_l - mig_cap, 0)
            + torch.clamp_min(n_r - mig_cap, 0)).to(torch.int32)
    rows[6] = torch.where(jdx < n_stay, rows[6], -1.0)
    return rows, buf_l, buf_r, lost


def merge_movers(rows, from_left, from_right, mig_cap: int):
    """One slab's half of the mover exchange after the transfer: the
    stayers' rows, then the buffers that came from the left and the right
    neighbour (None at a mesh edge: zeros, which decode as dead rows), ids
    decoded.  Returns (merged (nf, M + 2 mig_cap), live mask)."""
    def edge(buf):
        return rows.new_zeros((rows.shape[0], mig_cap)) if buf is None \
            else buf

    arrived = torch.cat([edge(from_left), edge(from_right)], dim=1)
    arrived[6] -= 1.0
    merged = torch.cat([rows, arrived], dim=1)
    return merged, merged[6] >= 0.0


# ---------------------------------------------------------------------------
# flat-state entry points (solver registry / run)
# ---------------------------------------------------------------------------

def _convert_in(state, params: SimParams, geom: PlaneGeom,
                continuity: bool) -> IncState:
    s = to_planes(state.pos, state.vel, state.ids, params, geom,
                  continuity=continuity)
    return s._replace(overflow=s.overflow + state.overflow)


def _flat_state(vals, cnt, overflow, params: SimParams, n: int):
    """Flat rows -> models.State; rows past the count (slots lost to
    overflow) park at bounds_min with vel 0 and id -1."""
    from ..models.state import State
    live = torch.arange(vals.shape[1], device=vals.device) < cnt
    lo = params.bounds_min
    dim = params.dim
    pos = torch.stack([torch.where(live, vals[d], lo[d])
                       for d in range(dim)], dim=-1)[:n]
    vel = torch.stack([torch.where(live, vals[3 + d], 0.0)
                       for d in range(dim)], dim=-1)[:n]
    ids = torch.where(live, vals[6].to(torch.int32), -1)[:n]
    if params.diagnostics:
        rho = torch.where(live, vals[7], params.rest_density)[:n]
        pres = physics_eos(rho, params)
    else:
        rho = torch.full((n,), params.rest_density, device=vals.device)
        pres = torch.zeros((n,), device=vals.device)
    return State(pos=pos, vel=vel, rho=rho, pres=pres, ids=ids,
                 overflow=overflow)


def physics_eos(rho, params: SimParams):
    return physics.eos_pressure(
        torch.clamp_min(rho, 1e-3 * params.rest_density), params)


def run_inc(state, params: SimParams, n_steps: int,
            continuity: bool = False):
    """models.State -> models.State after ``n_steps`` on the incremental
    path: one conversion to planes, a Python loop of ``step_planes`` that
    never waits for the card, one conversion back.  ``continuity``: the
    continuity tier (carried density, see ``step_planes``)."""
    n = state.n
    geom = pm.geometry(params)
    m_cap = mover_capacity(n)
    with profiling.span("inc.to_planes"):
        s = _convert_in(state, params, geom, continuity)
    for _ in range(n_steps):
        s = step_planes(s, params, geom, m_cap)
    with profiling.span("inc.to_flat"):
        vals, cnt = to_flat(s, params, geom, n)
        return _flat_state(vals, cnt, s.overflow, params, n)


def rollout_inc(state, params: SimParams, n_steps: int,
                record_every: int = 1, continuity: bool = False):
    """models.State -> (final State, traj): the planes stay resident for the
    whole rollout and every ``record_every`` steps a position frame is
    compacted out (``to_flat_lite``).  traj is (n_steps // record_every, N,
    dim) in slot order, so rows of different frames may be different
    particles (dropped rows park at bounds_min).  ``continuity`` as in
    ``run_inc``."""
    n = state.n
    geom = pm.geometry(params)
    m_cap = mover_capacity(n)
    with profiling.span("inc.to_planes"):
        s = _convert_in(state, params, geom, continuity)
    lo = params.bounds_min
    frames = []
    for _ in range(n_steps // record_every):
        for _ in range(record_every):
            s = step_planes(s, params, geom, m_cap)
        with profiling.span("inc.to_flat"):
            vals, cnt = to_flat_lite(s, geom, n)
            live = torch.arange(vals.shape[1], device=vals.device) < cnt
            frames.append(torch.stack(
                [torch.where(live, vals[d], lo[d])
                 for d in range(params.dim)], dim=-1)[:n])
    for _ in range(n_steps % record_every):
        s = step_planes(s, params, geom, m_cap)
    with profiling.span("inc.to_flat"):
        vals, cnt = to_flat(s, params, geom, n)
        final = _flat_state(vals, cnt, s.overflow, params, n)
    traj = (torch.stack(frames) if frames else
            final.pos.new_zeros((0, n, params.dim)))
    return final, traj
