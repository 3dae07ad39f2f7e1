"""The neighbour sweeps over the rank planes and the full-rebuild step.

Counterpart: ``gpufluidsimulator_tpu/ops/pallas_sph.py`` (``density_planes``,
``accel_planes`` in plain mode, ``step_pallas``).  The two sweeps are the
hand-written CUDA kernels ``csrc/density.cu`` (kernel 3) and
``csrc/force.cu`` (kernel 4); their plain PyTorch versions below loop over
the 3^d stencil offsets with shifted slices of the plane tensors and
broadcast over all (query rank, candidate rank) pairs.

Both sweeps define every slot: valid ranks of interior cells get the sum,
every other slot 0 (the TPU kernels leave those undefined).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..models.params import SimParams
from . import kernels, physics
from . import planes as pm
from . import route
from .planes import LANES, PlaneGeom

# The CUDA sweeps keep a cell's query ranks in registers, unrolled up to
# this many (csrc/density.cu, csrc/force.cu)
MAX_KERNEL_K = 16


def _offsets(dim: int):
    dzs = (-1, 0, 1) if dim == 3 else (0,)
    return [(dz, dy, dx) for dz in dzs for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]


def _window(a: torch.Tensor, geom: PlaneGeom, dz=0, dy=0, dx=0):
    """(..., pz, n_bx, py, 128) -> the cells one offset away from every cell
    of the interior's bounding box (z 1..nz in 3D, y 8..8+ny-1, the used
    lanes of 1..126); the 3^d stencil of that box stays inside the array."""
    z0, z1 = (1, geom.nz + 1) if geom.dim == 3 else (0, 1)
    y0, y1 = pm.ROWS_PER_BLOCK, pm.ROWS_PER_BLOCK + geom.ny
    l1 = min(geom.nx, pm.TILE_X) + 1 if geom.n_bx == 1 else LANES - 1
    return a[..., z0 + dz:z1 + dz, :, y0 + dy:y1 + dy, 1 + dx:l1 + dx]


def _query_mask(x: torch.Tensor, geom: PlaneGeom) -> torch.Tensor:
    """Valid ranks of interior cells, over the interior's bounding box."""
    interior = _window(pm.interior_mask(geom, x.device), geom)
    return (_window(x, geom) < pm.SENTINEL * 0.5) & interior


def _check_bounds(occ_q, occ_s, geom: PlaneGeom) -> None:
    """The bounds are taken for interface parity and not read by the
    kernels, so they may be strided views."""
    nzq = geom.nz if geom.dim == 3 else 1
    for name, t, shape in (("occ_q", occ_q, (nzq, geom.n_bx, geom.n_by)),
                           ("occ_s", occ_s, (nzq, geom.n_bx, geom.n_by, 3))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if geom.k > MAX_KERNEL_K:
        raise ValueError(f"the CUDA sweeps take cell_capacity <= "
                         f"{MAX_KERNEL_K}, got {geom.k}")


def _geom_args(geom: PlaneGeom):
    return [ctypes.c_int(geom.dim), ctypes.c_int(geom.k),
            ctypes.c_int(geom.nx), ctypes.c_int(geom.ny),
            ctypes.c_int(geom.nz), ctypes.c_int(geom.n_bx),
            ctypes.c_int(geom.py), ctypes.c_int(geom.pz),
            ctypes.c_longlong(geom.cells)]


# --------------------------------------------------------------------------
# kernel 3: density
# --------------------------------------------------------------------------

def density_plain(pos_planes: torch.Tensor, params: SimParams,
                  geom: PlaneGeom) -> torch.Tensor:
    """(3, K, pz, n_bx, py, 128) position planes -> (K, ...) density."""
    c_poly6 = kernels.poly6_coef(params.h, params.dim) * params.particle_mass
    h2 = params.h * params.h
    q = [_window(pos_planes[j], geom)[:, None] for j in range(params.dim)]
    acc = torch.zeros_like(q[0][:, 0])
    for dz, dy, dx in _offsets(params.dim):
        r2 = None
        for j in range(params.dim):
            d = q[j] - _window(pos_planes[j], geom, dz, dy, dx)[None]
            r2 = d * d if r2 is None else r2 + d * d
        w = torch.clamp_min(h2 - r2, 0.0)
        acc += torch.sum(w * w * w, dim=1)
    out = torch.zeros_like(pos_planes[0])
    _window(out, geom)[...] = torch.where(
        _query_mask(pos_planes[0], geom), c_poly6 * acc, 0.0)
    return out


def density_planes(pos_planes: torch.Tensor, occ_q: torch.Tensor,
                   occ_s: torch.Tensor, params: SimParams,
                   geom: PlaneGeom) -> torch.Tensor:
    """Summation density on the planes: the CUDA kernel ``density`` on the
    card, the plain version for CPU tensors.  ``occ_q``/``occ_s`` are the
    reference's rank-loop bounds; the kernel bounds its loops per cell
    instead (ranks are dense, it stops at the first sentinel)."""
    if pos_planes.device.type == "cpu":
        return density_plain(pos_planes, params, geom)
    shape = (geom.k, geom.pz, geom.n_bx, geom.py, LANES)
    _build.check_tensor(pos_planes, "pos_planes", torch.float32,
                        (pm.N_POS_FIELDS,) + shape)
    _check_bounds(occ_q, occ_s, geom)
    rho = torch.empty(shape, dtype=torch.float32, device=pos_planes.device)
    c_poly6 = kernels.poly6_coef(params.h, params.dim) * params.particle_mass
    _build.launch("density", pos_planes,
                  _build.ptr(pos_planes), _build.ptr(rho), *_geom_args(geom),
                  ctypes.c_float(params.h * params.h),
                  ctypes.c_float(c_poly6))
    return rho


# --------------------------------------------------------------------------
# kernel 4: force (plain mode)
# --------------------------------------------------------------------------

def _force_constants(params: SimParams):
    m_spiky = -kernels.spiky_grad_coef(params.h, params.dim) \
        * params.particle_mass
    m_visc_sqrt = math.sqrt(kernels.visc_lap_coef(params.h, params.dim)
                            * params.particle_mass * params.viscosity)
    return m_spiky, m_visc_sqrt


def accel_plain(field_planes: torch.Tensor, rho_planes: torch.Tensor,
                params: SimParams, geom: PlaneGeom) -> torch.Tensor:
    """(6, K, ...) pos/vel planes + (K, ...) density -> (3, K, ...)
    pressure + viscosity acceleration (no gravity)."""
    dim = params.dim
    rest = params.rest_density
    m_spiky, m_visc_sqrt = _force_constants(params)
    valid = field_planes[0] < pm.SENTINEL * 0.5
    rho_s = torch.where(valid, torch.clamp_min(rho_planes, 1e-3 * rest),
                        rest)
    pres = physics.eos_pressure(rho_s, params)
    chans = [field_planes[j] for j in range(dim)] \
        + [field_planes[3 + j] for j in range(dim)] \
        + [m_spiky * pres / (rho_s * rho_s), m_visc_sqrt / rho_s]
    q = [_window(a, geom)[:, None] for a in chans]
    qp, qir = q[2 * dim], q[2 * dim + 1]
    acc = [torch.zeros_like(q[0][:, 0]) for _ in range(dim)]
    sv = torch.zeros_like(q[0][:, 0])
    for dz, dy, dx in _offsets(dim):
        c = [_window(a, geom, dz, dy, dx)[None] for a in chans]
        dd = [q[j] - c[j] for j in range(dim)]
        r2 = dd[0] * dd[0] + dd[1] * dd[1]
        if dim == 3:
            r2 = r2 + dd[2] * dd[2]
        inv_r = torch.rsqrt(torch.clamp_min(r2, 1e-16))
        hr = torch.clamp_min(params.h - r2 * inv_r, 0.0)
        coef_p = (qp + c[2 * dim]) * (hr * hr * inv_r)
        coef_v = hr * (qir * c[2 * dim + 1])
        sv += torch.sum(coef_v, dim=1)
        for j in range(dim):
            acc[j] += torch.sum(coef_p * dd[j] + coef_v * c[dim + j], dim=1)
    mask = _query_mask(field_planes[0], geom)
    out = torch.zeros((3,) + tuple(field_planes.shape[1:]),
                      dtype=torch.float32, device=field_planes.device)
    for j in range(dim):
        a = acc[j] - q[dim + j][:, 0] * sv
        _window(out[j], geom)[...] = torch.where(mask, a, 0.0)
    return out


def accel_planes(field_planes: torch.Tensor, rho_planes: torch.Tensor,
                 occ_q: torch.Tensor, occ_s: torch.Tensor,
                 params: SimParams, geom: PlaneGeom) -> torch.Tensor:
    """Pressure + viscosity acceleration on the planes, the EOS fused: the
    CUDA kernel ``force`` on the card, the plain version for CPU tensors.
    ``rho_planes`` must already carry refreshed halo lanes (``halo_x``)."""
    if field_planes.device.type == "cpu":
        return accel_plain(field_planes, rho_planes, params, geom)
    shape = (geom.k, geom.pz, geom.n_bx, geom.py, LANES)
    _build.check_tensor(field_planes, "field_planes", torch.float32,
                        (6,) + shape)
    _build.check_tensor(rho_planes, "rho_planes", torch.float32, shape)
    _check_bounds(occ_q, occ_s, geom)
    out = torch.empty((3,) + shape, dtype=torch.float32,
                      device=field_planes.device)
    m_spiky, m_visc_sqrt = _force_constants(params)
    rest = params.rest_density
    tait_b = params.stiffness * rest / params.tait_gamma
    _build.launch("force", field_planes,
                  _build.ptr(field_planes), _build.ptr(rho_planes),
                  _build.ptr(out), *_geom_args(geom),
                  ctypes.c_float(params.h), ctypes.c_float(rest),
                  ctypes.c_float(1e-3 * rest),
                  ctypes.c_float(params.stiffness),
                  ctypes.c_int(params.eos == "tait"), ctypes.c_float(tait_b),
                  ctypes.c_float(params.tait_gamma),
                  ctypes.c_float(m_spiky), ctypes.c_float(m_visc_sqrt),
                  ctypes.c_int(params.clamp_negative_pressure))
    return out


# --------------------------------------------------------------------------
# full step
# --------------------------------------------------------------------------

def step_pallas(pos, vel, ids, params: SimParams):
    """One full-rebuild SPH step on the rank planes.

    bin (sorts + ``place``) -> occupancy bounds (``occ_rowmax``) -> density
    sweep -> halo refresh -> force sweep -> per-particle ``gather`` ->
    integrate.  Returns (pos, vel, rho, pres, ids, overflow) in slot-sorted
    order; ``ids`` carries identity.
    """
    geom = pm.geometry(params)
    table = pm.build_planes(pos, vel, ids, params, geom)
    planes = table.planes
    occ_q, occ_s = pm.occupancy_bounds(planes, params, geom)
    rho_p = density_planes(planes[:pm.N_POS_FIELDS], occ_q, occ_s, params,
                           geom)
    # the force sweep reads halo lanes as candidates: refresh them from the
    # owning tiles (in place; particles never bin into halo lanes, so the
    # gather below reads the same values either way)
    rho_p = pm.halo_x(rho_p)
    acc_p = accel_planes(planes, rho_p, occ_q, occ_s, params, geom)

    # one gather for acc (+ the density diagnostic); the reference gathers
    # rho_d = max(rho, 1e-3 rho0) and its EOS pressure as two more channels,
    # which are elementwise in rho, so the port computes them per particle
    stack = (torch.cat([acc_p, rho_p[None]], dim=0) if params.diagnostics
             else acc_p)
    out = route.gather(stack, table.slot)
    ok = table.ok
    out = torch.where(ok[:, None], out, 0.0)
    grav = torch.tensor(params.gravity + (0.0,) * (3 - params.dim),
                        dtype=torch.float32, device=pos.device)
    acc = (out[:, :3] + grav)[:, :params.dim]   # dropped rows: gravity only
    if params.diagnostics:
        rho_d = torch.clamp_min(out[:, 3], 1e-3 * params.rest_density)
        pres = torch.where(ok, physics.eos_pressure(rho_d, params), 0.0)
        rho = torch.where(ok, rho_d, params.rest_density)
    else:
        rho = torch.full_like(out[:, 0], params.rest_density)
        pres = torch.zeros_like(out[:, 0])
    pos, vel = physics.integrate(table.pos_s, table.vel_s, acc, params)
    return pos, vel, rho, pres, table.ids_s, table.overflow
