"""Naive O(N^2) SPH density/pressure and force evaluation.

Counterpart: ``gpufluidsimulator_tpu/ops/naive.py``.  All-pairs tensors, the
small-N solver (``auto`` picks it up to 8,192 particles) and the cheap
reference the rank-plane path is tested against.

  rho_i = m sum_j W_poly6(|x_ij|)                     (includes j = i)
  p_i   = EOS(rho_i)
  a_i   = sum_{j!=i} [ -m (p_i/rho_i^2 + p_j/rho_j^2) gradW_spiky(x_ij)
                       + mu m (v_j-v_i)/(rho_i rho_j) lapW_visc(|x_ij|) ] + g
"""

from __future__ import annotations

import torch

from ..models.params import SimParams
from . import kernels, physics


def density_naive(pos: torch.Tensor, params: SimParams) -> torch.Tensor:
    """(N, d) positions -> (N,) density via all-pairs poly6."""
    diff = pos[:, None, :] - pos[None, :, :]          # (N, N, d)
    r2 = torch.sum(diff * diff, dim=-1)               # (N, N)
    w = kernels.poly6(r2, params.h, params.dim)
    return params.particle_mass * torch.sum(w, dim=1)


def accel_naive(pos, vel, rho, pres, params: SimParams) -> torch.Tensor:
    """All-pairs pressure-gradient + viscosity acceleration (plus gravity)."""
    m = params.particle_mass
    diff = pos[:, None, :] - pos[None, :, :]          # x_i - x_j
    r2 = torch.sum(diff * diff, dim=-1)
    r = torch.sqrt(torch.clamp_min(r2, 1e-24))
    valid = (r2 < params.h * params.h) & (r2 > 1e-16)  # exclude self / overlap
    zero = torch.zeros_like(r2)

    p_over_rho2 = pres / (rho * rho)                  # (N,)
    g = kernels.spiky_grad_mag(r, params.h, params.dim)
    coef_p = torch.where(valid, -m * (p_over_rho2[:, None]
                                      + p_over_rho2[None, :]) * g / r, zero)
    a_pres = torch.sum(coef_p[..., None] * diff, dim=1)

    lap = kernels.visc_lap(r, params.h, params.dim)
    inv_rho = 1.0 / rho
    coef_v = torch.where(
        valid,
        params.viscosity * m * inv_rho[:, None] * inv_rho[None, :] * lap, zero)
    dvel = vel[None, :, :] - vel[:, None, :]          # v_j - v_i
    a_visc = torch.sum(coef_v[..., None] * dvel, dim=1)

    grav = physics.constant(params.gravity, pos)
    return a_pres + a_visc + grav


def step_naive(pos, vel, params: SimParams):
    """One full O(N^2) SPH step: density -> pressure -> forces -> integrate."""
    rho = density_naive(pos, params)
    pres = physics.eos_pressure(rho, params)
    acc = accel_naive(pos, vel, rho, pres, params)
    pos, vel = physics.integrate(pos, vel, acc, params)
    return pos, vel, rho, pres
