"""Gridded SPH density and forces on the dense cell table (config 2: the 2D
dam break of 65,522 particles).

Counterpart: ``gpufluidsimulator_tpu/ops/gridded.py``, which the reference
computes in XLA outside any Pallas kernel; the port keeps it as plain
PyTorch on the caller's device.  All work happens in the ``(C, K, ...)``
layout of ``ops/grid.py``: each stencil offset is a static slice of the
once-padded table, and contributes one ``(C, K, K)`` pair block.  Pair
distances are direct coordinate differences, as in the reference.
"""

from __future__ import annotations

import torch

from ..models.params import SimParams
from . import grid as gridmod
from . import kernels, physics
from .grid import CellTable


def _shift_views(dense: torch.Tensor, offsets, pad_value: float):
    """{off: view} with view[c] == dense[c + off] for interior cells: one
    padded copy along the cell axis, then a slice per offset."""
    m = max(abs(o) for o in offsets)
    c = dense.shape[0]
    padded = torch.full((c + 2 * m,) + tuple(dense.shape[1:]), pad_value,
                        dtype=dense.dtype, device=dense.device)
    padded[m:m + c] = dense
    return {off: padded[m + off:m + off + c] for off in offsets}


def density_dense(table: CellTable, params: SimParams) -> torch.Tensor:
    """Per-slot density (C, K) over the stencil."""
    offs = gridmod.neighbor_offsets(params)
    pos_views = _shift_views(table.pos, offs, gridmod.SENTINEL)
    rho = torch.zeros(table.pos.shape[:2], dtype=torch.float32,
                      device=table.pos.device)
    for off in offs:
        diff = table.pos[:, :, None, :] - pos_views[off][:, None, :, :]
        r2 = torch.sum(diff * diff, dim=-1)              # (C, K, K)
        w = kernels.poly6(r2, params.h, params.dim)
        rho = rho + torch.sum(w, dim=-1)
    return params.particle_mass * rho


def accel_dense(table: CellTable, rho: torch.Tensor, pres: torch.Tensor,
                params: SimParams) -> torch.Tensor:
    """Per-slot acceleration (C, K, d): symmetric pressure gradient +
    viscosity + gravity (the physics of ``ops/naive.py``)."""
    m = params.particle_mass
    h = params.h
    p_r2 = pres / (rho * rho)                            # (C, K)
    inv_rho = 1.0 / rho

    offs = gridmod.neighbor_offsets(params)
    pos_views = _shift_views(table.pos, offs, gridmod.SENTINEL)
    vel_views = _shift_views(table.vel, offs, 0.0)
    pr2_views = _shift_views(p_r2, offs, 0.0)
    irho_views = _shift_views(inv_rho, offs, 1.0)

    acc = torch.zeros_like(table.pos)
    for off in offs:
        diff = table.pos[:, :, None, :] - pos_views[off][:, None, :, :]
        r2 = torch.sum(diff * diff, dim=-1)
        r = torch.sqrt(torch.clamp_min(r2, 1e-24))
        valid = (r2 < h * h) & (r2 > 1e-16)

        g = kernels.spiky_grad_mag(r, h, params.dim)
        coef_p = torch.where(
            valid,
            -m * (p_r2[:, :, None] + pr2_views[off][:, None, :]) * g / r,
            0.0)
        acc = acc + torch.sum(coef_p[..., None] * diff, dim=2)

        lap = kernels.visc_lap(r, h, params.dim)
        coef_v = torch.where(
            valid,
            params.viscosity * m
            * inv_rho[:, :, None] * irho_views[off][:, None, :] * lap,
            0.0)
        dvel = vel_views[off][:, None, :, :] - table.vel[:, :, None, :]
        acc = acc + torch.sum(coef_v[..., None] * dvel, dim=2)

    return acc + physics.constant(params.gravity, acc)


def slot_density(table: CellTable, params: SimParams) -> torch.Tensor:
    """``density_dense`` with empty slots at rest density: they would divide
    by ~0 downstream."""
    return torch.where(table.valid, density_dense(table, params),
                       params.rest_density)


def finish(pos: torch.Tensor, vel: torch.Tensor, table: CellTable,
           rho_d: torch.Tensor, pres_d: torch.Tensor, acc_d: torch.Tensor,
           params: SimParams):
    """The per-slot results back in particle order, then the integration.
    Dropped particles fall freely (the reference's overflow policy; the
    shipped scenes keep overflow at 0).  Returns (pos, vel, rho, pres,
    overflow)."""
    acc = gridmod.gather_per_particle(acc_d, table.slot, 0.0)
    acc = torch.where((table.slot >= 0)[:, None], acc,
                      physics.constant(params.gravity, acc))
    rho = gridmod.gather_per_particle(rho_d[..., None], table.slot,
                                      params.rest_density)[..., 0]
    pres = gridmod.gather_per_particle(pres_d[..., None], table.slot,
                                       0.0)[..., 0]

    pos, vel = physics.integrate(pos, vel, acc, params)
    return pos, vel, rho, pres, table.overflow


def step_gridded(pos: torch.Tensor, vel: torch.Tensor, params: SimParams):
    """One full gridded SPH step. Returns (pos, vel, rho, pres, overflow),
    particles in their input order."""
    table = gridmod.build_cell_table(pos, vel, params)
    rho_d = slot_density(table, params)
    pres_d = physics.eos_pressure(rho_d, params)
    acc_d = accel_dense(table, rho_d, pres_d, params)
    return finish(pos, vel, table, rho_d, pres_d, acc_d, params)
