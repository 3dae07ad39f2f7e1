"""Rank-planar cell-grid layout: geometry, binning and occupancy bounds.

Counterpart: ``gpufluidsimulator_tpu/ops/planes.py``.  The port keeps the
reference's logical layout so its tensors compare 1:1 with the JAX ones:

  * each field (pos x/y/z, vel x/y/z) is a rank plane
    ``(K, pz, n_bx, py, 128)`` float32; ``plane[k, z, xo, y, l]`` holds the
    rank-k particle of cell (z, y, x = xo*126 + l - 1), or a sentinel
    (positions) / 0 (velocities) when the slot is empty;
  * x is cut into tiles of 126 interior cells plus 2 halo lanes that
    ``halo_x`` fills from the neighbouring tiles;
  * ghost cells: one plane in z, 8 rows in y, lane 0 / the trailing lanes in
    x, so the 3^d stencil of an interior cell never leaves the array.

``occ_rowmax`` and ``occupancy_bounds`` hold the first hand-written kernel
of the port (``csrc/occ_rowmax.cu``: the row maxima, or in one launch the
bounds pooled from them) beside their plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import _build
from ..models.params import SimParams

SENTINEL = 1.0e6
LANES = 128
TILE_X = LANES - 2          # interior cells per x tile
ROWS_PER_BLOCK = 8          # y ghost band / block height
ROUTE_TILE_ROWS = 64        # py is padded to this (the reference's routing
                            # tile height), keeping the layouts identical

# field indices within `planes`
FIELD_X, FIELD_Y, FIELD_Z = 0, 1, 2
FIELD_VX, FIELD_VY, FIELD_VZ = 3, 4, 5
N_POS_FIELDS = 3


class PlaneGeom(NamedTuple):
    """Static geometry of the plane layout (all Python ints)."""
    dim: int
    k: int                   # cell capacity (rank count)
    nx: int                  # interior cells in x
    ny: int
    nz: int                  # 1 for 2D
    n_bx: int                # x tiles
    py: int                  # allocated y cells (ghost band 8 + interior + pad)
    pz: int                  # allocated z planes (1 ghost each side; 1 if 2D)
    n_by: int                # interior y blocks
    cells: int               # total cells = pz * n_bx * py * 128


def geometry(params: SimParams) -> PlaneGeom:
    if params.x_halfwidth != 1:
        raise ValueError(
            "the rank-plane (pallas) tier needs every binning cell >= h "
            "(x-stencil halfwidth 1)")
    res = params.grid_res
    nx = res[0]
    ny = res[1]
    nz = res[2] if params.dim == 3 else 1
    n_bx = -(-nx // TILE_X)
    n_by = -(-(ny + 2) // ROWS_PER_BLOCK)        # interior + 1-cell halo
    py = (1 + n_by + 1) * ROWS_PER_BLOCK         # one ghost block each side
    py = -(-py // ROUTE_TILE_ROWS) * ROUTE_TILE_ROWS
    pz = nz + 2 if params.dim == 3 else 1
    return PlaneGeom(dim=params.dim, k=params.cell_capacity,
                     nx=nx, ny=ny, nz=nz, n_bx=n_bx, py=py, pz=pz,
                     n_by=n_by, cells=pz * n_bx * py * LANES)


def snap_cell(params: SimParams, max_stretch: float = 1.06,
              min_gain: float = 0.85) -> SimParams:
    """Pick a binning cell (>= h) that avoids pathological slot padding.

    A grid whose x extent lands just past a 126-lane tile boundary (or y
    past a 64-row boundary) allocates a mostly empty extra tile.  Stretching
    the cell slightly (the 3^d stencil only needs cell >= h) can fold the
    grid back under the boundary.  Keeps the smallest stretch within
    ``max_stretch`` that shrinks the slot space to <= ``min_gain`` of the
    unsnapped layout.  No-op when ``cell_size`` was set explicitly.
    """
    if params.cell_size > 0.0 or params.cell_aniso:
        return params
    base = params.h
    base_cells = geometry(params).cells
    cands = set()
    for d in range(params.dim):
        extent = params.bounds_max[d] - params.bounds_min[d]
        n = max(1, int(math.ceil(extent / base - 1e-9)))
        n_lo = max(1, int(math.floor(n / max_stretch)))
        for n2 in range(n_lo, n):
            c = extent / n2
            if base < c <= base * max_stretch:
                cands.add(c)
    best = None
    for c in sorted(cands):
        cells = geometry(params.replace(cell_size=c)).cells
        if cells <= min_gain * base_cells and (
                best is None or cells < best[1]):
            best = (c, cells)
    if best is None:
        return params
    return params.replace(cell_size=best[0])


def lattice_dx(params: SimParams) -> float:
    """The scene's lattice spacing, from mass = rho0 * dx^dim."""
    return (params.particle_mass / params.rest_density) ** (1.0 / params.dim)


def cell_linear_parts(pos: torch.Tensor, params: SimParams,
                      geom: PlaneGeom, x_origin=None) -> torch.Tensor:
    """(N, d) -> (N,) int32 linear cell index in the allocated plane frame.

    Keeps the reference's float32 ``floor((pos - lo) * (1/cell))`` form, so
    both packages bin every particle into the same cell: a Python scalar
    enters a float32 op rounded to float32.  The scalars stay on the host
    (a tensor built from them on the card would be a synchronizing copy).
    ``x_origin`` (a float32 value as a Python float) replaces
    ``bounds_min[0]`` as the x origin: a sharded slab's.
    """
    lo = params.bounds_min
    cax = params.cells_axis

    def axis(d, n, origin=None):
        base = lo[d] if origin is None else origin
        c = torch.floor((pos[:, d] - base) * (1.0 / cax[d])).to(torch.int32)
        return torch.clamp(c, 0, n - 1)

    x = axis(0, geom.nx, x_origin)
    xo = x // TILE_X
    xi = x % TILE_X + 1                              # lane 0 = halo/ghost
    y = axis(1, geom.ny) + ROWS_PER_BLOCK            # ghost block below
    z = (axis(2, geom.nz) + 1 if params.dim == 3
         else torch.zeros_like(x))
    return ((z * geom.n_bx + xo) * geom.py + y) * LANES + xi


def own_cid(geom: PlaneGeom, device=None) -> torch.Tensor:
    """(pz, n_bx, py, 128) int32: the linear cell id of each plane column
    (the linearization of ``cell_linear_parts``)."""
    return torch.arange(geom.cells, dtype=torch.int32, device=device) \
        .reshape(geom.pz, geom.n_bx, geom.py, LANES)


def halo_x(arr: torch.Tensor) -> torch.Tensor:
    """Mirror x-tile edge cells into the neighbour tiles' halo lanes, IN
    PLACE (the callers own the freshly built planes, so no copy is made).

    arr: (..., n_bx, py, 128).  lane 0 of tile t+1 <- lane 126 of tile t;
    lane 127 of tile t <- lane 1 of tile t+1.  No-op when n_bx == 1.
    Returns ``arr``.
    """
    if arr.shape[-3] == 1:
        return arr
    arr[..., 1:, :, 0] = arr[..., :-1, :, TILE_X]
    arr[..., :-1, :, LANES - 1] = arr[..., 1:, :, 1]
    return arr


def interior_mask(geom: PlaneGeom, device=None) -> torch.Tensor:
    """(pz, n_bx, py, 128) bool: the cells a particle can bin into."""
    z = torch.arange(geom.pz, device=device)
    xo = torch.arange(geom.n_bx, device=device)
    y = torch.arange(geom.py, device=device)
    lane = torch.arange(LANES, device=device)
    z_ok = (z >= 1) & (z <= geom.nz) if geom.dim == 3 else z == 0
    y_ok = (y >= ROWS_PER_BLOCK) & (y < ROWS_PER_BLOCK + geom.ny)
    gx = xo[:, None] * TILE_X + lane[None, :] - 1
    x_ok = (lane[None, :] >= 1) & (lane[None, :] <= TILE_X) & (gx < geom.nx)
    return (z_ok[:, None, None, None] & x_ok[None, :, None, :]
            & y_ok[None, None, :, None])


class PlaneTable(NamedTuple):
    """Binned particle data in rank-planar layout.

    Particle arrays come back slot-sorted: the caller adopts that order as
    the new canonical particle order and carries identity in ``ids``.

    The reference's table also carries ``shifts`` (a routing channel that
    only its inverse butterfly network reads) and ``starts`` (per routing
    tile particle offsets).  The port reads per-particle values back with a
    direct gather kernel (``route.gather``), so it needs neither.
    """
    planes: torch.Tensor      # (6 [+1 id], K, pz, n_bx, py, 128) f32
                              #   (see FIELD_*)
    slot: torch.Tensor        # (N,) int32 flat slot k*cells + cell of the
                              #   sorted particle i; k*cells when dropped
    ok: torch.Tensor          # (N,) bool: sorted particle landed in a slot
    pos_s: torch.Tensor       # (N, d) slot-sorted positions
    vel_s: torch.Tensor       # (N, d) slot-sorted velocities
    ids_s: torch.Tensor       # (N,)   slot-sorted particle identities
    overflow: torch.Tensor    # ()     int32


def build_planes(pos, vel, ids, params: SimParams, geom: PlaneGeom,
                 with_ids: bool = False, x_origin=None,
                 active=None) -> PlaneTable:
    """Bin particles into rank planes.

    Sort by cell id, rank within the cell from a cummax over run starts
    (ranks are dense from 0), drop ranks >= K into the overflow count, sort
    by the rank-major slot ``rank*cells + cell``, then place the fields
    (``route.place``).  Both sorts are unstable: the rank order inside a
    cell is physically arbitrary.

    ``with_ids`` adds the particle id as a 7th f32 plane channel (empty
    slots 0; the x-channel sentinel marks them), as the incremental path
    carries identity in the planes.

    Sharded slabs: ``x_origin`` is the slab's binning origin
    (``cell_linear_parts``) and ``active`` (N,) bool marks live rows; the
    others (free slots: id -1, parked at the sentinel) bind to no cell,
    sort past every live row and are not counted as overflow.
    """
    from . import route

    n = pos.shape[0]
    k = geom.k
    cells = geom.cells
    dim = params.dim

    cid = cell_linear_parts(pos, params, geom, x_origin).to(torch.int64)
    if active is not None:
        cid = torch.where(active, cid, cells)       # one past every cell
    cid_sorted, order = torch.sort(cid)
    idx = torch.arange(n, dtype=torch.int64, device=pos.device)
    starts = torch.where(cid_sorted[1:] != cid_sorted[:-1], idx[1:],
                         torch.zeros_like(idx[1:]))
    run_start = torch.cat([torch.zeros_like(idx[:1]), starts])
    rank = idx - torch.cummax(run_start, dim=0).values
    in_domain = cid_sorted < cells
    ok1 = (rank < k) & in_domain
    overflow = torch.sum(~ok1 & in_domain).to(torch.int32)
    slot1 = torch.where(ok1, rank * cells + cid_sorted,
                        torch.full_like(cid_sorted, k * cells))

    slot, order2 = torch.sort(slot1)
    perm = order[order2]                  # composed: original -> slot order
    pos_s = pos[perm]
    vel_s = vel[perm]
    ids_s = ids[perm]
    ok = slot < k * cells
    slot = slot.to(torch.int32)

    cols = [pos_s.T, vel_s.T]
    if with_ids:
        cols.append(ids_s.to(torch.float32)[None])
    fields = torch.cat(cols, dim=0)              # (2*dim [+1], N)
    stack = route.place(fields, slot, ok, geom, n_pos=dim)
    if dim == 3:
        planes = stack
    else:
        # 2D keeps the reference's 6-channel layout: all-zero z and vz
        zero = torch.zeros_like(stack[:1])
        planes = torch.cat([stack[0:2], zero, stack[2:4], zero, stack[4:]],
                           dim=0)
    planes = halo_x(planes)
    return PlaneTable(planes=planes, slot=slot, ok=ok, pos_s=pos_s,
                      vel_s=vel_s, ids_s=ids_s, overflow=overflow)


# --------------------------------------------------------------------------
# kernel 1: per-row maximum occupancy
# --------------------------------------------------------------------------

def occ_rowmax_plain(planes_x: torch.Tensor) -> torch.Tensor:
    """(K, pz, n_bx, py, 128) x-channel -> (pz, n_bx, py) int32: the count
    of valid ranks per cell, maxed over the 128 lanes of each row.  Ranks
    are dense, so a cell's count stops at its first sentinel rank."""
    valid = (planes_x < SENTINEL * 0.5).to(torch.int32)
    lead = torch.cummin(valid, dim=0).values
    return torch.sum(lead, dim=0, dtype=torch.int32).amax(dim=-1)


def _check_x(planes_x: torch.Tensor, geom: PlaneGeom) -> None:
    shape = (geom.k, geom.pz, geom.n_bx, geom.py, LANES)
    _build.check_tensor(planes_x, "planes_x", torch.float32, shape)
    if planes_x.data_ptr() % 16:
        raise ValueError("planes_x must be 16-byte aligned")
    if geom.k * geom.cells >= 2 ** 31:
        raise ValueError(f"the CUDA occ_rowmax indexes with 32 bits: K * "
                         f"cells = {geom.k * geom.cells} is too large")


def _occ_launch(planes_x, rowmax, occ_q, occ_s, geom: PlaneGeom) -> None:
    null = ctypes.c_void_p(None)
    _build.launch("occ_rowmax", planes_x, _build.ptr(planes_x),
                  null if rowmax is None else _build.ptr(rowmax),
                  null if occ_q is None else _build.ptr(occ_q),
                  null if occ_s is None else _build.ptr(occ_s),
                  ctypes.c_int(geom.dim), ctypes.c_int(geom.k),
                  ctypes.c_int(geom.nz), ctypes.c_int(geom.n_bx),
                  ctypes.c_int(geom.py), ctypes.c_int(geom.pz),
                  ctypes.c_int(geom.n_by), ctypes.c_longlong(geom.cells))


def occ_rowmax(planes_x: torch.Tensor, geom: PlaneGeom) -> torch.Tensor:
    """Per-row maximum occupancy; the CUDA kernel ``occ_rowmax`` on the
    card, the plain version for CPU tensors."""
    if planes_x.device.type == "cpu":
        return occ_rowmax_plain(planes_x)
    _check_x(planes_x, geom)
    out = torch.empty((geom.pz, geom.n_bx, geom.py), dtype=torch.int32,
                      device=planes_x.device)
    _occ_launch(planes_x, out, None, None, geom)
    return out


def occupancy_bounds_plain(planes: torch.Tensor, params: SimParams,
                           geom: PlaneGeom):
    """``occupancy_bounds`` in plain PyTorch: ``occ_rowmax_plain``, pooled
    by 8-row block, its edge rows and the neighbouring z planes."""
    rowmax = occ_rowmax_plain(planes[FIELD_X])
    nb = geom.n_by
    blk = rowmax.reshape(geom.pz, geom.n_bx, -1, ROWS_PER_BLOCK)
    blkmax = torch.amax(blk, dim=-1)                      # (pz, n_bx, nby+2)
    edge_lo = rowmax[..., ROWS_PER_BLOCK - 1::ROWS_PER_BLOCK]   # row y0-1
    edge_hi = rowmax[..., ROWS_PER_BLOCK::ROWS_PER_BLOCK]       # row y0+8
    occ_q = blkmax[..., 1:nb + 1]
    slab = torch.maximum(blkmax[..., 1:nb + 1],
                         torch.maximum(edge_lo[..., 0:nb],
                                       edge_hi[..., 1:nb + 1]))
    if params.dim == 3:
        zpad = torch.zeros_like(slab[:1])
        occ_s = torch.stack([
            torch.cat([zpad, slab[:-1]], dim=0),          # z-1
            slab,                                         # z
            torch.cat([slab[1:], zpad], dim=0),           # z+1
        ], dim=-1)
        occ_q = occ_q[1:geom.nz + 1]
        occ_s = occ_s[1:geom.nz + 1]
    else:
        occ_s = torch.stack([slab * 0, slab, slab * 0], dim=-1)
    return occ_q, occ_s


def occupancy_bounds(planes: torch.Tensor, params: SimParams,
                     geom: PlaneGeom):
    """Per-block occupancy bounds (occ_q, occ_s) from the halo'd planes.

    occ_q (nz|1, n_bx, n_by): max rank count of each interior 8-row block;
    occ_s (..., 3): the same over the block's y window, for the planes
    z-1, z, z+1.  The sweep kernels (``sph.density_planes``,
    ``accel_planes``, ``accel_step``, ``accel_step_cont``) skip a block
    whose occ_q is 0, bound its query ranks by occ_q and the ranks they
    stage from plane z+dz by occ_s; every rank loop still stops at a cell's
    first sentinel rank.  On the card one launch of the kernel
    ``occ_rowmax`` writes both (contiguous views of one allocation); for
    CPU tensors ``occupancy_bounds_plain``.
    """
    if planes.device.type == "cpu":
        return occupancy_bounds_plain(planes, params, geom)
    planes_x = planes[FIELD_X]
    _check_x(planes_x, geom)
    nzq = geom.nz if params.dim == 3 else 1
    nq = nzq * geom.n_bx * geom.n_by
    buf = torch.empty(4 * nq, dtype=torch.int32, device=planes.device)
    occ_q = buf[:nq].view(nzq, geom.n_bx, geom.n_by)
    occ_s = buf[nq:].view(nzq, geom.n_bx, geom.n_by, 3)
    _occ_launch(planes_x, None, occ_q, occ_s, geom)
    return occ_q, occ_s
