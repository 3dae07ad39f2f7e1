"""Packed-pair force sweep over particles packed dense in cell-id order.

Counterpart: ``gpufluidsimulator_tpu/ops/mxu_sweep.py``, the reference's
prototype of a neighbour representation with no fixed-capacity padding
(its name is kept so that a reader finds the counterpart; the port has no
matrix-unit variant).  No solver method runs it; ``accel_mxu`` is its
entry point.

  * ``pack``: a stable sort by ``grid.cell_id`` and the 8 channels
    ``[x, y, z, vx, vy, vz, p/rho^2, 1/rho]`` per particle, padded with
    sentinel rows to a multiple of 128.
  * ``build_desc``: each tile of 128 consecutive packed queries gets three
    clipped-disjoint candidate ranges ``[lo, hi)``, one per dz band: with
    halfwidth-1 cells the stencil candidates of all the tile's cells in a
    band lie in one contiguous packed range
    ``[cid_lo + dz*sz - sy - 1, cid_hi + dz*sz + sy + 1]``.
  * ``sweep_packed`` (kernel 10, ``csrc/packed_sweep.cu``): pressure and
    viscosity acceleration of every query over its tile's ranges.  The
    kernel walks only each query group's own stencil rows inside them
    (``group_segments``) and evaluates the rows within h of the group's
    bounding box (``group_candidates``); the pairs it leaves out are
    outside the support, as ``group_segments`` states.

The reference's TPU block arguments are dropped: ``spb`` (slots per
program), ``skip_dead`` (its grid's dead-slot skip), ``precision`` and
``variant`` (the matrix-unit or vector-unit reduction), the lane-layout
transpose ``FT`` and the index-map arithmetic ``_slot_scalars``.  The port's
descriptor is built on the tensor's own device (the reference builds it in
numpy on the host) and carries no ``max_slots``: nothing reads back to the
host.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..models.params import SimParams
from . import grid, kernels

TQ = 128          # queries per tile
TC = 128          # candidates per slot of the plain version's pair tiles
# the kernel's pruning policy (csrc/packed_sweep.cu FK_PS_QPW and
# FK_PS_BOX_MARGIN; the wrapper checks that the built kernel has these):
# queries per group (a warp: 8 x 4 lanes), and the margin on h^2 past which
# a candidate's squared distance from its group's bounding box puts it
# outside the support of every query of the group, with room for r's
# rounding
GROUP = 8
BOX_MARGIN = 1.0001
SENTINEL = 1.0e6  # pad-row position (outside every kernel support)
# the plain version's pair-tile temporaries per chunk of slots
PLAIN_TEMP_BYTES = 1 << 30
# float32 (TC, TQ) temporaries the plain version holds per slot
_PLAIN_TEMPS = 24


def _check_stencil(params: SimParams) -> None:
    """The three-range descriptor covers a halfwidth-1 stencil in 3D only;
    a wider stencil (``cell_aniso``) would lose neighbour pairs."""
    if params.dim != 3 or grid.halfwidths(params) != (1, 1, 1):
        raise ValueError(
            "the packed-pair sweep needs a 3D grid of stencil halfwidth 1 "
            f"on every axis; got dim={params.dim}, halfwidths "
            f"{grid.halfwidths(params)}")


def _constants(params: SimParams):
    """(k1, k2): the pressure and viscosity pair factors."""
    h = params.h
    m = params.particle_mass
    k1 = -m * kernels.spiky_grad_coef(h, 3)
    k2 = params.viscosity * m * kernels.visc_lap_coef(h, 3)
    return k1, k2


# --------------------------------------------------------------- packing

def pack(pos, vel, rho, pres, params: SimParams):
    """Sort by padded cell id and pack the 8 per-particle channels dense.

    Returns (F (Npad, 8) float32, cids_sorted (N,) int32, order (N,)
    int64), Npad = ceil(N / 128) * 128; pad rows hold the sentinel position
    and zeros.
    """
    _check_stencil(params)
    n = pos.shape[0]
    cids = grid.cell_id(pos, params)
    order = torch.argsort(cids, stable=True)
    a = pres / (rho * rho)
    ir = 1.0 / rho
    npad = -(-n // TQ) * TQ
    f = torch.empty((npad, 8), dtype=torch.float32, device=pos.device)
    f[:n] = torch.cat([pos, vel, a[:, None], ir[:, None]], dim=1)[order]
    f[n:, :3] = SENTINEL
    f[n:, 3:] = 0.0
    return f, cids[order], order


def build_desc(cids: torch.Tensor, npad: int,
               params: SimParams) -> torch.Tensor:
    """Per-query-tile candidate descriptor, on ``cids``' device: (Q, 8)
    int32 rows ``[lo0, hi0, lo1, hi1, lo2, hi2, nslots, 0]``, three
    clipped-disjoint packed ranges (an empty one is ``[0, 0)``) and the
    count of 128-wide candidate tiles they touch.  ``cids``: the sorted
    cell ids of ``pack``."""
    _check_stencil(params)
    st = grid.strides(params)
    sy, sz = st[1], st[2]
    c = cids.to(torch.int64)
    n = c.shape[0]
    q = npad // TQ
    dev = c.device
    i0 = torch.arange(q, dtype=torch.int64, device=dev) * TQ
    clo = c[i0]
    chi = c[torch.clamp_max(i0 + TQ, n) - 1]
    desc = torch.zeros((q, 8), dtype=torch.int64, device=dev)
    prev_hi = torch.zeros(q, dtype=torch.int64, device=dev)
    for r, dz in enumerate((-1, 0, 1)):
        lo = torch.searchsorted(c, clo + (dz * sz - sy - 1), side="left")
        hi = torch.searchsorted(c, chi + (dz * sz + sy + 1), side="right")
        lo = torch.maximum(lo, prev_hi)
        empty = hi <= lo
        desc[:, 2 * r] = torch.where(empty, 0, lo)
        desc[:, 2 * r + 1] = torch.where(empty, 0, hi)
        prev_hi = torch.where(empty, prev_hi, hi)
        desc[:, 6] += torch.where(empty, 0, (hi - 1) // TC - lo // TC + 1)
    return desc.to(torch.int32)


def _slots(desc: torch.Tensor):
    """desc -> flat per-slot (qtile, tile, lo, hi) int64 tensors on its
    device, qtile-major, then range, then tile: every 128-wide candidate
    tile that a range touches."""
    d = desc.to(torch.int64)
    lo = d[:, 0:6:2].reshape(-1)
    hi = d[:, 1:6:2].reshape(-1)
    cnt = torch.where(hi > lo, (hi - 1) // TC - lo // TC + 1, 0)
    rid = torch.repeat_interleave(
        torch.arange(cnt.numel(), device=d.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(rid.numel(), device=d.device) - first[rid]
    return rid // 3, lo[rid] // TC + k, lo[rid], hi[rid]


def group_segments(cids: torch.Tensor, desc: torch.Tensor,
                   params: SimParams):
    """The packed ranges the kernel walks for each group of ``GROUP``
    consecutive packed queries, as flat int64 tensors ``(grp, lo, hi)`` on
    ``cids``' device, one entry per non-empty range ``[lo, hi)``.

    The rule: for each (y, z) row that the group's real queries occupy,
    with their x cells in ``[x_lo, x_hi]``, and each (dy, dz) in
    {-1, 0, 1}^2, the cells ``x_lo - 1 .. x_hi + 1`` of row
    ``(y + dy, z + dz)``.  Where several of the group's rows reach one
    neighbour row, it is walked once, over the hull of their x cells.  Each
    such cell range is the packed range of its sorted cell ids, cut by the
    group's tile's ``desc`` ranges.  The ranges are disjoint, so no pair
    counts twice.

    A candidate left out is two or more cells from each query of the
    group on some axis, as the 27-cell force and density sweeps leave it
    out.  With cells at least h wide it is outside the support.  But
    ``grid.halfwidths`` takes cells down to h / (1 + 1e-6) as halfwidth 1,
    and float32 rounding in ``grid.cell_id`` can bin a particle a few ulps
    across a face; such a pair can be closer than h by about 1e-6 h, and
    where the tile's ranges hold it (its cells two apart in x, or in y and
    z where a tile spans several rows) the plain version adds its term,
    with d = h - r near 1e-6 h (``tests/test_torch_mxu.py`` builds such
    pairs on each axis).
    """
    _check_stencil(params)
    st = grid.strides(params)
    sy, sz = st[1], st[2]
    c = cids.to(torch.int64)
    dev = c.device
    n = c.shape[0]
    if n == 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return e, e, e
    row = c // sy
    x = c - row * sy
    g = torch.arange(n, device=dev) // GROUP
    # the runs of one row inside one group: their rows and x extents
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = (row[1:] != row[:-1]) | (g[1:] != g[:-1])
    last = torch.ones(n, dtype=torch.bool, device=dev)
    last[:-1] = first[1:]
    offs = torch.tensor([dy * sy + dz * sz for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1)], dtype=torch.int64,
                        device=dev)
    # the neighbour rows of each run (as the cell id of their x = 0), one
    # per (group, neighbour row), over the hull of the x extents
    base = ((row[first] * sy)[:, None] + offs).reshape(-1)
    grp = g[first].repeat_interleave(9)
    ncells = grid.num_padded_cells(params)
    key, inv = torch.unique(grp * ncells + base, return_inverse=True)
    lo = torch.full(key.shape, sy, dtype=torch.int64, device=dev)
    lo = lo.scatter_reduce(0, inv, x[first].repeat_interleave(9) - 1, "amin")
    hi = torch.zeros(key.shape, dtype=torch.int64, device=dev)
    hi = hi.scatter_reduce(0, inv, x[last].repeat_interleave(9) + 1, "amax")
    sg = key // ncells
    cell0 = key - sg * ncells
    a = torch.searchsorted(c, cell0 + lo, side="left")
    b = torch.searchsorted(c, cell0 + hi, side="right")
    # cut by the tile's (disjoint) ranges
    d = desc.to(torch.int64)[sg * GROUP // TQ]
    parts = []
    for r in range(3):
        plo = torch.maximum(a, d[:, 2 * r])
        phi = torch.minimum(b, d[:, 2 * r + 1])
        keep = plo < phi
        parts.append((sg[keep], plo[keep], phi[keep]))
    grp, plo, phi = (torch.cat(t) for t in zip(*parts))
    order = torch.sort(grp, stable=True).indices
    return grp[order], plo[order], phi[order]


def group_candidates(F: torch.Tensor, cids: torch.Tensor,
                     desc: torch.Tensor, params: SimParams):
    """The candidates the kernel evaluates for each query group, as flat
    int64 tensors ``(grp, j)``: the packed rows of its ``group_segments``
    whose squared distance to the bounding box of the group's real queries
    is below ``h^2 * BOX_MARGIN``.  A row left out is at least h from every
    query of the group, so its pairs add 0."""
    grp, lo, hi = group_segments(cids, desc, params)
    n = cids.shape[0]
    dev = F.device
    length = hi - lo
    starts = torch.cumsum(length, 0) - length
    j = torch.arange(int(length.sum()), device=dev) \
        + torch.repeat_interleave(lo - starts, length)
    grp = torch.repeat_interleave(grp, length)
    qg = (torch.arange(n, device=dev) // GROUP)[:, None].expand(n, 3)
    box = torch.zeros((-(-n // GROUP), 3), device=dev)
    blo = box.scatter_reduce(0, qg, F[:n, :3], "amin", include_self=False)
    bhi = box.scatter_reduce(0, qg, F[:n, :3], "amax", include_self=False)
    blo, bhi = blo[grp], bhi[grp]
    c = F[j, :3]
    e = torch.clamp_min(torch.maximum(blo - c, c - bhi), 0.0)
    keep = (e * e).sum(1) < params.h * params.h * BOX_MARGIN
    return grp[keep], j[keep]


# ----------------------------------------------------------------- kernel

@functools.cache
def _check_kernel_policy() -> None:
    """Raise unless the built kernel groups GROUP queries and keeps rows
    below h^2 * BOX_MARGIN of the group's box, as ``group_segments`` and
    ``group_candidates`` (and the pair counts taken from them) assume."""
    lib = _build.library()
    got = (lib.fk_sweep_packed_group(), lib.fk_sweep_packed_box_margin())
    if got != (GROUP, float(np.float32(BOX_MARGIN))):
        raise RuntimeError(f"packed_sweep.cu has group and box margin "
                           f"{got}; mxu_sweep has {(GROUP, BOX_MARGIN)}")

def sweep_packed_plain(F: torch.Tensor, cids: torch.Tensor,
                       desc: torch.Tensor, params: SimParams) -> torch.Tensor:
    """The plain PyTorch version of ``sweep_packed``: every slot (a query
    tile against one 128-wide candidate tile, masked to its range) as a
    dense (TC, TQ) pair tile, slots in chunks whose temporaries stay near
    ``PLAIN_TEMP_BYTES``, summed per query tile with ``index_add_``.  It
    walks the tiles' whole ranges; ``cids`` is taken, and not read, so that
    both versions have one signature."""
    npad = F.shape[0]
    q = npad // TQ
    h = params.h
    k1, k2 = _constants(params)
    qt, tile, lo, hi = _slots(desc)
    fq = F.reshape(q, TQ, 8)
    out = torch.zeros((q, TQ, 3), dtype=torch.float32, device=F.device)
    step = max(1, PLAIN_TEMP_BYTES // (_PLAIN_TEMPS * TC * TQ * 4))
    lane = torch.arange(TC, device=F.device)
    for s0 in range(0, qt.numel(), step):
        sl = slice(s0, s0 + step)
        t, tl = qt[sl], tile[sl]
        jid = tl[:, None] * TC + lane
        rng = (jid >= lo[sl, None]) & (jid < hi[sl, None])   # (S, TC)
        cand = fq[tl][:, :, None, :]                     # (S, TC, 1, 8)
        qry = fq[t][:, None, :, :]                       # (S, 1, TQ, 8)
        dd = [qry[..., c] - cand[..., c] for c in range(3)]
        r2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
        rinv = torch.rsqrt(torch.clamp_min(r2, 1e-24))
        d = torch.clamp_min(h - r2 * rinv, 0.0)
        live = rng[:, :, None] & (r2 > 1e-16)
        coefp = torch.where(
            live, k1 * (cand[..., 6] + qry[..., 6]) * (d * d) * rinv, 0.0)
        coefv = torch.where(
            live, k2 * (cand[..., 7] * qry[..., 7]) * d, 0.0)
        acc = torch.stack(
            [torch.sum(coefp * dd[c]
                       + coefv * (cand[..., 3 + c] - qry[..., 3 + c]), dim=1)
             for c in range(3)], dim=-1)                 # (S, TQ, 3)
        out.index_add_(0, t, acc)
    return out.reshape(npad, 3)


def sweep_packed(F: torch.Tensor, cids: torch.Tensor, desc: torch.Tensor,
                 params: SimParams) -> torch.Tensor:
    """Pressure + viscosity acceleration (no gravity) of every packed row
    over its tile's candidate ranges: (Npad, 3) float32 in packed order.
    The CUDA kernel ``sweep_packed`` on the card, which evaluates only the
    pairs of ``group_segments``; the plain version for CPU tensors.  F,
    cids and desc from ``pack`` and ``build_desc``."""
    if F.device.type == "cpu":
        return sweep_packed_plain(F, cids, desc, params)
    _check_stencil(params)
    npad = F.shape[0]
    if npad % TQ:
        raise ValueError(f"F has {npad} rows, not a multiple of {TQ}")
    if npad >= 2 ** 31:
        raise ValueError(f"F has {npad} rows; the kernel counts rows in "
                         f"int32")
    n = cids.shape[0]
    q = npad // TQ
    _build.check_tensor(F, "F", torch.float32, (npad, 8))
    _build.check_tensor(cids, "cids", torch.int32, (n,))
    if not npad - TQ < n <= npad:
        raise ValueError(f"cids has {n} entries; F's {npad} rows hold "
                         f"{npad - TQ + 1} to {npad} particles")
    _build.check_tensor(desc, "desc", torch.int32, (q, 8))
    if F.data_ptr() % 16:
        raise ValueError("F must be 16-byte aligned (rows load as float4)")
    out = torch.empty((npad, 3), dtype=torch.float32, device=F.device)
    if q == 0:
        return out
    _check_kernel_policy()
    k1, k2 = _constants(params)
    st = grid.strides(params)
    _build.launch("sweep_packed", F,
                  _build.ptr(F), _build.ptr(cids), _build.ptr(desc),
                  _build.ptr(out), ctypes.c_int(n), ctypes.c_int(npad),
                  ctypes.c_int(st[1]), ctypes.c_int(st[2]),
                  ctypes.c_float(params.h), ctypes.c_float(k1),
                  ctypes.c_float(k2))
    return out


# ------------------------------------------------------------ entry point

def accel_mxu(pos, vel, rho, pres, params: SimParams) -> torch.Tensor:
    """Packed-pair acceleration in the ORIGINAL particle order (pressure +
    viscosity, no gravity), the ``naive.accel_naive`` parity surface."""
    f, cids, order = pack(pos, vel, rho, pres, params)
    desc = build_desc(cids, f.shape[0], params)
    out = sweep_packed(f, cids, desc, params)
    acc = torch.empty_like(pos)
    acc[order] = out[:pos.shape[0]]
    return acc


# ------------------------------------------------------- numpy accounting

def slot_table(desc: np.ndarray):
    """desc -> flat per-slot (qtile, tile, lo, hi) int32 numpy arrays: the
    candidate tiles that each query tile's ranges touch."""
    return tuple(a.numpy().astype(np.int32)
                 for a in _slots(torch.tensor(np.asarray(desc))))


def table_stats(cids: np.ndarray, npad: int, params: SimParams) -> dict:
    """Padding accounting: evaluated pair tiles and range-covered pairs,
    from the sorted cell ids (numpy)."""
    desc = build_desc(torch.tensor(np.asarray(cids)), npad, params).numpy()
    qt, tiles, lo, hi = slot_table(desc)
    cov = np.maximum(np.minimum(hi, (tiles + 1) * TC)
                     - np.maximum(lo, tiles * TC), 0)
    q = npad // TQ
    return {
        "n": int(len(cids)),
        "qtiles": q,
        "live_slots": int(len(tiles)),
        "max_slots": int(max(desc[:, 6].max(), 1)),
        "eval_pairs": int(len(tiles)) * TC * TQ,
        "covered_pairs": int(cov.sum()) * TQ,
        "slots_per_qtile": float(len(tiles)) / q,
    }
