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
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..models.params import SimParams
from ..utils import profiling
from . import kernels, physics
from . import planes as pm
from . import route
from .planes import LANES, PlaneGeom

# The CUDA sweeps take up to this many ranks a cell (csrc/tile.cuh lays
# out up to 16 query ranks a cell and stages them in two passes)
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


def _check_bounds(occ_q, occ_s, geom: PlaneGeom, device=None) -> None:
    """The sweep kernels read the bounds through their strides, so they may
    be strided views; with ``device``, they must lie on it."""
    nzq = geom.nz if geom.dim == 3 else 1
    for name, t, shape in (("occ_q", occ_q, (nzq, geom.n_bx, geom.n_by)),
                           ("occ_s", occ_s, (nzq, geom.n_bx, geom.n_by, 3))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if device is not None and t.device != device:
            raise ValueError(f"{name} must be on {device}, got {t.device}")
    if geom.k > MAX_KERNEL_K:
        raise ValueError(f"the CUDA sweeps take cell_capacity <= "
                         f"{MAX_KERNEL_K}, got {geom.k}")


def _occ_args(occ_q, occ_s):
    """The bounds as csrc/force.cu and csrc/density.cu take them: two
    pointers and a host array of their 7 strides in elements."""
    strides = (ctypes.c_longlong * 7)(*occ_q.stride(), *occ_s.stride())
    return [_build.ptr(occ_q), _build.ptr(occ_s),
            ctypes.cast(strides, ctypes.c_void_p)]


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
    reference's rank-loop bounds (``planes.occupancy_bounds`` of the same
    planes): the kernel skips an 8-row block whose ``occ_q`` is 0 and
    bounds its rank loops by them, as the force kernels do."""
    if pos_planes.device.type == "cpu":
        return density_plain(pos_planes, params, geom)
    shape = (geom.k, geom.pz, geom.n_bx, geom.py, LANES)
    _build.check_tensor(pos_planes, "pos_planes", torch.float32,
                        (pm.N_POS_FIELDS,) + shape)
    _check_bounds(occ_q, occ_s, geom, pos_planes.device)
    rho = torch.empty(shape, dtype=torch.float32, device=pos_planes.device)
    c_poly6 = kernels.poly6_coef(params.h, params.dim) * params.particle_mass
    _build.launch("density", pos_planes,
                  _build.ptr(pos_planes), *_occ_args(occ_q, occ_s),
                  _build.ptr(rho), *_geom_args(geom),
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


class ContConsts(NamedTuple):
    """The continuity step's constants, folded on the host in Python floats
    as the reference folds them (pallas_sph.py:281-372).  ``form`` is
    ``params.cont_form``, except "delta" for the rate form with
    ``cont_delta > 0``."""
    form: str
    h2: float
    drho_scale: float        # -6 dt c_poly6 m: the rate accumulator's scale
    rho_sum_scale: float     # c_poly6 m: the sum form's
    kappa_d2: float          # relax: the summation folded into the rate
    one_m_l: float           # relax: 1 - lambda
    use_corr: bool           # cont_beta > 0: the clamped deferred correction
    c_corr: float
    corr_cap: float
    use_alpha: bool          # cont_alpha > 0: Monaghan's viscosity term
    c_av: float
    eps_h2: float
    kappa: float             # delta: 2 delta h c
    kappa_over_mv: float     # delta: kappa / m_visc_sqrt


# continuity form -> csrc/force.cu FK_CONT_*
CONT_FORMS = {"rate": 1, "relax": 2, "sum": 3, "delta": 4}


def _cont_constants(params: SimParams) -> ContConsts:
    h, dim, m = params.h, params.dim, params.particle_mass
    rest = params.rest_density
    c = params.sound_speed
    poly6 = kernels.poly6_coef(h, dim)
    spiky = -kernels.spiky_grad_coef(h, dim)
    form = params.cont_form
    if form == "rate" and params.cont_delta > 0.0 and params.viscosity > 0.0:
        form = "delta"
    lam = params.cont_relax if form == "relax" else 0.0
    c_sum = poly6 * m
    drho = -6.0 * params.dt * poly6 * m
    m_visc = math.sqrt(kernels.visc_lap_coef(h, dim) * m
                       * params.viscosity) or 1.0
    return ContConsts(
        form=form, h2=h * h, drho_scale=drho, rho_sum_scale=poly6 * m,
        kappa_d2=(lam * c_sum / ((1.0 - lam) * drho)
                  if form == "relax" and lam < 1.0 else 0.0),
        one_m_l=1.0 - lam,
        use_corr=params.cont_beta > 0.0,
        c_corr=(params.cont_beta * spiky * m * 12.0 * poly6 * m
                * params.stiffness * params.dt / (rest ** 2)),
        corr_cap=spiky * m * params.stiffness * 0.2 / rest,
        use_alpha=params.cont_alpha > 0.0,
        c_av=spiky * m * params.cont_alpha * c * h / rest,
        eps_h2=0.01 * h * h,
        kappa=2.0 * params.cont_delta * h * c,
        kappa_over_mv=2.0 * params.cont_delta * h * c / m_visc)


def _accel_window(field_planes: torch.Tensor, rho_planes: torch.Tensor,
                  params: SimParams, geom: PlaneGeom, cont: ContConsts = None):
    """The pair loop of every force version over the interior's bounding
    box: -> (acc, query, sr), ``acc`` the dim pressure + viscosity
    accelerations (no gravity) and ``query`` the 6 pos/vel channels, each
    (K, ...window).  With ``cont`` the pair loop also runs the continuity
    terms (pallas_sph.py:443-456, 469-486) and ``sr`` is the fifth
    accumulator; else ``sr`` is None."""
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
    sr = None if cont is None else torch.zeros_like(sv)
    if cont is not None and cont.form == "delta":
        # kappa rho_i / m_visc_sqrt from the RAW carried rho; paired with
        # the candidate's m_visc_sqrt / rho_j it gives kappa rho_i / rho_j
        qdel = _window(rho_planes, geom)[:, None] * cont.kappa_over_mv
    for dz, dy, dx in _offsets(dim):
        c = [_window(a, geom, dz, dy, dx)[None] for a in chans]
        dd = [q[j] - c[j] for j in range(dim)]
        r2 = dd[0] * dd[0] + dd[1] * dd[1]
        if dim == 3:
            r2 = r2 + dd[2] * dd[2]
        inv_r = torch.rsqrt(torch.clamp_min(r2, 1e-16))
        hr = torch.clamp_min(params.h - r2 * inv_r, 0.0)
        psum = qp + c[2 * dim]
        if cont is not None:
            dot = (q[dim] - c[dim]) * dd[0] + (q[dim + 1] - c[dim + 1]) * dd[1]
            if dim == 3:
                dot = dot + (q[dim + 2] - c[dim + 2]) * dd[2]
            d2 = torch.clamp_min(cont.h2 - r2, 0.0)
            d4 = d2 * d2
            t_dot = d4 * dot
            if cont.use_corr:
                psum = psum - torch.clamp(cont.c_corr * t_dot,
                                          -cont.corr_cap, cont.corr_cap)
            if cont.use_alpha:
                rr = torch.rsqrt(r2 + cont.eps_h2)
                psum = psum - cont.c_av * torch.clamp_max(dot * (rr * rr),
                                                          0.0)
            if cont.form == "sum":
                w = d4 * d2
            elif cont.form == "relax":
                w = d4 * (dot + cont.kappa_d2 * d2)
            elif cont.form == "delta":
                w = d4 * ((dot - cont.kappa) + qdel * c[2 * dim + 1])
            else:
                w = t_dot
            sr += torch.sum(w, dim=1)
        coef_p = psum * (hr * hr * inv_r)
        coef_v = hr * (qir * c[2 * dim + 1])
        sv += torch.sum(coef_v, dim=1)
        for j in range(dim):
            acc[j] += torch.sum(coef_p * dd[j] + coef_v * c[dim + j], dim=1)
    query = [_window(field_planes[j], geom) for j in range(6)]
    acc = [acc[j] - query[3 + j] * sv for j in range(dim)]
    return acc, query, sr


def _eos_args(params: SimParams):
    """The pair loop's constants as csrc/force.cu takes them: h, then the
    fused EOS (FkEos)."""
    m_spiky, m_visc_sqrt = _force_constants(params)
    rest = params.rest_density
    tait_b = params.stiffness * rest / params.tait_gamma
    return [ctypes.c_float(params.h), ctypes.c_float(rest),
            ctypes.c_float(1e-3 * rest), ctypes.c_float(params.stiffness),
            ctypes.c_int(params.eos == "tait"), ctypes.c_float(tait_b),
            ctypes.c_float(params.tait_gamma), ctypes.c_float(m_spiky),
            ctypes.c_float(m_visc_sqrt),
            ctypes.c_int(params.clamp_negative_pressure)]


def accel_plain(field_planes: torch.Tensor, rho_planes: torch.Tensor,
                params: SimParams, geom: PlaneGeom) -> torch.Tensor:
    """(6, K, ...) pos/vel planes + (K, ...) density -> (3, K, ...)
    pressure + viscosity acceleration (no gravity)."""
    acc, _, _ = _accel_window(field_planes, rho_planes, params, geom)
    mask = _query_mask(field_planes[0], geom)
    out = torch.zeros((3,) + tuple(field_planes.shape[1:]),
                      dtype=torch.float32, device=field_planes.device)
    for j in range(params.dim):
        _window(out[j], geom)[...] = torch.where(mask, acc[j], 0.0)
    return out


def accel_planes(field_planes: torch.Tensor, rho_planes: torch.Tensor,
                 occ_q: torch.Tensor, occ_s: torch.Tensor,
                 params: SimParams, geom: PlaneGeom) -> torch.Tensor:
    """Pressure + viscosity acceleration on the planes, the EOS fused: the
    CUDA kernel ``force`` on the card, the plain version for CPU tensors.
    ``rho_planes`` must already carry refreshed halo lanes (``halo_x``).
    The kernel skips an 8-row block whose ``occ_q`` is 0 and bounds its
    rank loops by ``occ_q``/``occ_s``, so they must come from these planes
    (``planes.occupancy_bounds``)."""
    if field_planes.device.type == "cpu":
        return accel_plain(field_planes, rho_planes, params, geom)
    shape = (geom.k, geom.pz, geom.n_bx, geom.py, LANES)
    _build.check_tensor(field_planes, "field_planes", torch.float32,
                        (6,) + shape)
    _build.check_tensor(rho_planes, "rho_planes", torch.float32, shape)
    _check_bounds(occ_q, occ_s, geom, field_planes.device)
    out = torch.empty((3,) + shape, dtype=torch.float32,
                      device=field_planes.device)
    _build.launch("force", field_planes,
                  _build.ptr(field_planes), _build.ptr(rho_planes),
                  *_occ_args(occ_q, occ_s), _build.ptr(out),
                  *_geom_args(geom), *_eos_args(params))
    return out


# --------------------------------------------------------------------------
# kernel 4b: force + EOS + integrate + collide + mover flag (the fused step)
# --------------------------------------------------------------------------

# obstacles the CUDA kernel takes (csrc/force.cu FK_MAX_OBS)
MAX_KERNEL_OBSTACLES = 4


def _slab(params: SimParams, geom: PlaneGeom = None, x_origin=None):
    """[binning x origin, slab end) of the mover flag's slab test.  On one
    card: the global domain padded by one cell, which no particle leaves
    (collide clamps x inside the walls), the reference's default
    (pallas_sph.py:772-776).  A sharded slab (``x_origin``, a float32 value
    as a Python float): [x_origin, x_origin + nx * cell), summed in
    float32 as the reference's step_planes does (inc.py:1180-1183)."""
    if x_origin is None:
        return params.bounds_min[0], params.bounds_max[0] + params.cell
    x0 = np.float32(x_origin)
    return float(x0), float(x0 + np.float32(geom.nx * params.cell))


def accel_step_plain(field_planes: torch.Tensor, rho_planes: torch.Tensor,
                     params: SimParams, geom: PlaneGeom, x_origin=None,
                     wall_params: SimParams = None):
    """(6, K, ...) pos/vel planes + (K, ...) density -> (new6, flagp).

    new6: the post-step pos/vel planes of every valid rank of an interior
    cell (gravity, symplectic Euler, walls then obstacles), UNBLANKED: a
    particle that left its cell stays in its slot.  flagp: 1.0 on those
    slots whose particle now bins into another cell (the reference's float32
    ``floor((x - lo) * (1/cell))``, pallas_sph.py:552-578) or left the x
    slab.  Every other slot holds the sentinel (positions) or 0 (velocities,
    flag).

    A sharded slab: ``x_origin`` is its binning origin (the flag's x cell
    and slab test, ``_slab``) and ``wall_params`` the global domain's walls
    and obstacles, which collide uses in place of ``params``'."""
    acc, q, _ = _accel_window(field_planes, rho_planes, params, geom)
    return _step_epilogue(acc, q, field_planes, params, geom, x_origin,
                          wall_params)


def _step_epilogue(acc, q, field_planes: torch.Tensor, params: SimParams,
                   geom: PlaneGeom, x_origin=None,
                   wall_params: SimParams = None):
    """Integrate, collide and flag the movers of the window's queries ->
    (new6, flagp) planes (see ``accel_step_plain``)."""
    dim = params.dim
    grav = params.gravity
    dt = params.dt
    vs = [q[3 + c] + (acc[c] + grav[c]) * dt for c in range(dim)]
    ps = [q[c] + vs[c] * dt for c in range(dim)]
    ps, vs = physics.collide_axes(ps, vs, wall_params or params)
    mask = _query_mask(field_planes[0], geom)
    cid = pm.cell_linear_parts(
        torch.stack([p.reshape(-1) for p in ps], dim=-1), params, geom,
        x_origin)
    own = _window(pm.own_cid(geom, mask.device), geom)
    x0, x1 = _slab(params, geom, x_origin)
    moved = (cid.reshape(ps[0].shape) != own) | (ps[0] < x0) \
        | (ps[0] >= x1)
    moved = moved & mask
    if dim == 2:
        zero = torch.zeros_like(ps[0])
        ps, vs = ps + [zero], vs + [zero]
    new6 = torch.zeros_like(field_planes[:6])
    new6[:3] = pm.SENTINEL
    for c in range(3):
        _window(new6[c], geom)[...] = torch.where(mask, ps[c], pm.SENTINEL)
        _window(new6[3 + c], geom)[...] = torch.where(mask, vs[c], 0.0)
    flagp = torch.zeros_like(field_planes[0])
    _window(flagp, geom)[...] = moved.to(torch.float32)
    return new6, flagp


def _step_args(params: SimParams, geom: PlaneGeom = None, x_origin=None,
               wall_params: SimParams = None):
    """The fused epilogue's constants as the host float array that
    csrc/force.cu reads (FkStep): dt, -restitution, 1 + restitution,
    gravity[3], lo[3], hi[3], 1/cell[3], slab[2], then 7 floats per
    obstacle (kind 0 box / 1 sphere, centre[3], half extents[3] or the
    radius).  The walls (restitution, lo, hi, obstacles) come from
    ``wall_params`` when given, the slab from ``_slab``: the kernel bins x
    by slab[0] and collides against lo and hi."""
    walls = wall_params or params
    pad = (0.0,) * (3 - params.dim)
    vals = [params.dt, -walls.restitution, 1.0 + walls.restitution]
    vals += list(params.gravity + pad) + list(walls.bounds_min + pad)
    vals += list(walls.bounds_max + pad)
    vals += [1.0 / c for c in params.cells_axis] + [1.0] * (3 - params.dim)
    vals += list(_slab(params, geom, x_origin))
    for ob in walls.obstacles:
        kind, centre, extent = ob
        if kind == "box":
            vals += [0.0, *centre, *pad, *extent, *pad]
        elif kind == "sphere":
            vals += [1.0, *centre, *pad, extent, 0.0, 0.0]
        else:
            raise ValueError(f"unknown obstacle kind {kind!r}")
    return (ctypes.c_float * len(vals))(*vals)


def accel_step(field_planes: torch.Tensor, rho_planes: torch.Tensor,
               occ_q: torch.Tensor, occ_s: torch.Tensor,
               params: SimParams, geom: PlaneGeom, x_origin=None,
               wall_params: SimParams = None):
    """The fused force step of the incremental path (see
    ``accel_step_plain``, also for a sharded slab's ``x_origin`` and
    ``wall_params``): the CUDA kernel ``force_step`` on the card, the plain
    version for CPU tensors.  ``rho_planes`` must carry refreshed halo
    lanes."""
    if field_planes.device.type == "cpu":
        return accel_step_plain(field_planes, rho_planes, params, geom,
                                x_origin, wall_params)
    shape = _check_step_inputs(field_planes, rho_planes, occ_q, occ_s,
                               params, geom, wall_params)
    step = _step_args(params, geom, x_origin, wall_params)
    new6 = torch.empty((6,) + shape, dtype=torch.float32,
                       device=field_planes.device)
    flagp = torch.empty(shape, dtype=torch.float32,
                        device=field_planes.device)
    _build.launch("force_step", field_planes,
                  _build.ptr(field_planes), _build.ptr(rho_planes),
                  *_occ_args(occ_q, occ_s), _build.ptr(new6),
                  _build.ptr(flagp), *_geom_args(geom), *_eos_args(params),
                  ctypes.cast(step, ctypes.c_void_p),
                  ctypes.c_int(len((wall_params or params).obstacles)))
    return new6, flagp


def _check_step_inputs(field_planes, rho_planes, occ_q, occ_s,
                       params: SimParams, geom: PlaneGeom,
                       wall_params: SimParams = None):
    """Raise on what the fused CUDA step does not take; -> a plane's shape."""
    shape = (geom.k, geom.pz, geom.n_bx, geom.py, LANES)
    _build.check_tensor(field_planes, "field_planes", torch.float32,
                        (6,) + shape)
    _build.check_tensor(rho_planes, "rho_planes", torch.float32, shape)
    _check_bounds(occ_q, occ_s, geom, field_planes.device)
    n_obs = len((wall_params or params).obstacles)
    if n_obs > MAX_KERNEL_OBSTACLES:
        raise ValueError(f"the CUDA force step takes at most "
                         f"{MAX_KERNEL_OBSTACLES} obstacles, got {n_obs}")
    return shape


# --------------------------------------------------------------------------
# kernel 4c: the fused step of the continuity tier
# --------------------------------------------------------------------------

def accel_step_cont_plain(field_planes: torch.Tensor, rho_planes: torch.Tensor,
                          params: SimParams, geom: PlaneGeom, x_origin=None,
                          wall_params: SimParams = None):
    """(6, K, ...) pos/vel planes + (K, ...) CARRIED density -> (new6,
    rho_new, flagp): ``accel_step_plain`` with the continuity terms in the
    pair loop (the reference's ``accel_planes(..., continuity=True)``).

    The EOS reads max(rho, 1e-3 rho0); the pair loop adds the clamped
    deferred correction (``cont_beta > 0``) and Monaghan's term
    (``cont_alpha > 0``) to the pressure sum and accumulates ``sr`` in the
    form of ``params.cont_form`` (pallas_sph.py:443-486).  rho_new
    (pallas_sph.py:588-606), from the query's RAW carried rho_q:
      sum:   c_poly6 m sr;
      relax: (1 - lambda) (rho_q + drho_scale sr);
      rate:  rho_q + drho_scale sr  (with the delta-SPH term in sr when
             ``cont_delta > 0``);
    and 0 on every slot that is not a valid rank of an interior cell.
    ``x_origin`` and ``wall_params``: a sharded slab's, as in
    ``accel_step_plain``."""
    cont = _cont_constants(params)
    acc, q, sr = _accel_window(field_planes, rho_planes, params, geom, cont)
    new6, flagp = _step_epilogue(acc, q, field_planes, params, geom,
                                 x_origin, wall_params)
    if cont.form == "sum":
        rho_new = cont.rho_sum_scale * sr
    else:
        rho_q = _window(rho_planes, geom)
        rho_new = rho_q + cont.drho_scale * sr
        if cont.form == "relax":
            rho_new = cont.one_m_l * rho_new
    out = torch.zeros_like(field_planes[0])
    _window(out, geom)[...] = torch.where(
        _query_mask(field_planes[0], geom), rho_new, 0.0)
    return new6, out, flagp


def _cont_args(params: SimParams):
    """The continuity constants as csrc/force.cu takes them: the form
    (CONT_FORMS), the two switches, then the float array of FkCont."""
    c = _cont_constants(params)
    vals = [c.h2, c.drho_scale, c.rho_sum_scale, c.kappa_d2, c.one_m_l,
            c.c_corr, c.corr_cap, c.c_av, c.eps_h2, c.kappa, c.kappa_over_mv]
    return [ctypes.c_int(CONT_FORMS[c.form]), ctypes.c_int(c.use_corr),
            ctypes.c_int(c.use_alpha),
            ctypes.cast((ctypes.c_float * len(vals))(*vals),
                        ctypes.c_void_p)]


def accel_step_cont(field_planes: torch.Tensor, rho_planes: torch.Tensor,
                    occ_q: torch.Tensor, occ_s: torch.Tensor,
                    params: SimParams, geom: PlaneGeom, x_origin=None,
                    wall_params: SimParams = None):
    """The fused force step of the continuity tier (see
    ``accel_step_cont_plain``): the CUDA kernel ``force_step_cont`` on the
    card, the plain version for CPU tensors.  ``rho_planes`` is the carried
    density with refreshed halo lanes."""
    if field_planes.device.type == "cpu":
        return accel_step_cont_plain(field_planes, rho_planes, params, geom,
                                     x_origin, wall_params)
    shape = _check_step_inputs(field_planes, rho_planes, occ_q, occ_s,
                               params, geom, wall_params)
    step = _step_args(params, geom, x_origin, wall_params)
    dev = field_planes.device
    new6 = torch.empty((6,) + shape, dtype=torch.float32, device=dev)
    rho_new = torch.empty(shape, dtype=torch.float32, device=dev)
    flagp = torch.empty(shape, dtype=torch.float32, device=dev)
    _build.launch("force_step_cont", field_planes,
                  _build.ptr(field_planes), _build.ptr(rho_planes),
                  *_occ_args(occ_q, occ_s), _build.ptr(new6),
                  _build.ptr(rho_new), _build.ptr(flagp), *_geom_args(geom),
                  *_eos_args(params), ctypes.cast(step, ctypes.c_void_p),
                  ctypes.c_int(len((wall_params or params).obstacles)),
                  *_cont_args(params))
    return new6, rho_new, flagp


# --------------------------------------------------------------------------
# full step
# --------------------------------------------------------------------------

def one_slab(steps):
    """Run a step generator (``pallas_phases``, ``inc.step_phases``) that
    was given no exchange, and so yields nothing, to its end; returns the
    step's value."""
    try:
        next(steps)
    except StopIteration as stop:
        return stop.value
    raise RuntimeError("a step without an exchange reached one")


def step_pallas(pos, vel, ids, params: SimParams):
    """One full-rebuild SPH step on the rank planes, on one card
    (``pallas_phases`` without an exchange).

    bin (sorts + ``place``) -> occupancy bounds (``occ_rowmax``) -> density
    sweep -> halo refresh -> force sweep -> per-particle ``gather`` ->
    integrate.  Returns (pos, vel, rho, pres, ids, overflow) in slot-sorted
    order; ``ids`` carries identity."""
    with profiling.span("pallas.step"):
        return one_slab(pallas_phases(pos, vel, ids, params))


def pallas_phases(pos, vel, ids, params: SimParams, x_origin=None,
                  active=None, exchange=None, wall_params: SimParams = None):
    """``step_pallas`` as a generator, the sharded step of one slab
    (``parallel/sharded.py``), as the reference's (pallas_sph.py:818-890):
    ``x_origin`` is the slab's binning origin, ``active`` masks its live
    capacity slots, ``wall_params`` holds the global walls, and with
    ``exchange`` (``parallel.sharded.SlabExchange``) it yields
    ``(exchange, stack)`` after binning and for rho after ``halo_x``, and
    takes back the stack with its outermost halo lanes filled from the
    neighbouring slabs (``parallel.mesh.lockstep``).  Its phases are
    spans (``utils/profiling``), none open across a ``yield``; the step's
    own span is its caller's."""
    geom = pm.geometry(params)
    with profiling.span("pallas.binning"):
        table = pm.build_planes(pos, vel, ids, params, geom,
                                x_origin=x_origin, active=active)
        profiling.tally(("drops_cell_capacity",), table.overflow)
    planes = table.planes
    if exchange is not None:
        planes = yield exchange.fields(pm.N_POS_FIELDS), planes
    with profiling.span("pallas.density"):
        occ_q, occ_s = pm.occupancy_bounds(planes, params, geom)
        rho_p = density_planes(planes[:pm.N_POS_FIELDS], occ_q, occ_s,
                               params, geom)
        # the force sweep reads halo lanes as candidates: refresh them from
        # the owning tiles (in place; particles never bin into halo lanes,
        # so the gather below reads the same values either way)
        rho_h = pm.halo_x(rho_p)
    if exchange is not None:
        # the cross-slab halo lanes of rho (0 at the mesh's edges)
        rho_h = (yield exchange.fields(0), rho_h[None])[0]
    with profiling.span("pallas.force"):
        acc_p = accel_planes(planes, rho_h, occ_q, occ_s, params, geom)
    with profiling.span("pallas.gather"):
        # one gather for acc (+ the density diagnostic); the reference
        # gathers rho_d = max(rho, 1e-3 rho0) and its EOS pressure as two
        # more channels, which are elementwise in rho, so the port computes
        # them per particle
        stack = (torch.cat([acc_p, rho_p[None]], dim=0)
                 if params.diagnostics else acc_p)
        out = route.gather(stack, table.slot)
        ok = table.ok
        out = torch.where(ok[:, None], out, 0.0)
        grav = physics.constant(params.gravity + (0.0,) * (3 - params.dim),
                                out)
        # dropped rows: gravity only
        acc = (out[:, :3] + grav)[:, :params.dim]
        if params.diagnostics:
            rho_d = torch.clamp_min(out[:, 3], 1e-3 * params.rest_density)
            pres = torch.where(ok, physics.eos_pressure(rho_d, params), 0.0)
            rho = torch.where(ok, rho_d, params.rest_density)
        else:
            rho = torch.full_like(out[:, 0], params.rest_density)
            pres = torch.zeros_like(out[:, 0])
        if active is not None:
            active_s = table.ids_s >= 0
            acc = torch.where(active_s[:, None], acc, 0.0)
        # the walls may differ from the binning grid: a slab's grid covers
        # the slab, its walls are the global domain's
        pos, vel = physics.integrate(table.pos_s, table.vel_s, acc,
                                     wall_params or params)
        if active is not None:
            # free slots stay parked at the sentinel
            pos = torch.where(active_s[:, None], pos, pm.SENTINEL)
            vel = torch.where(active_s[:, None], vel, 0.0)
        return pos, vel, rho, pres, table.ids_s, table.overflow
