"""Float64 NumPy O(N^2) oracle: the port's correctness anchor.

Counterpart: ``gpufluidsimulator_tpu/oracle/numpy_ref.py``, copied function
for function with the same float64 arithmetic in the same order, so that on
equal inputs the two return equal arrays bit for bit.  It reads the port's
``SimParams`` (the reference's field names).

Implements exactly the physics of ``ops/naive.py`` in NumPy float64,
entirely off the device.  It imports NumPy only (no torch, no JAX, nothing
of either package's device path), so it cannot share a bug with the path it
checks.
"""

from __future__ import annotations

import math

import numpy as np


def _coefs(h: float, dim: int):
    if dim == 3:
        return (315.0 / (64.0 * math.pi * h**9),
                -45.0 / (math.pi * h**6),
                45.0 / (math.pi * h**6))
    return (4.0 / (math.pi * h**8),
            -30.0 / (math.pi * h**5),
            40.0 / (math.pi * h**5))


def density(pos: np.ndarray, params) -> np.ndarray:
    h, dim = params.h, params.dim
    c_poly6, _, _ = _coefs(h, dim)
    diff = pos[:, None, :] - pos[None, :, :]
    r2 = np.sum(diff * diff, axis=-1)
    d = np.maximum(h * h - r2, 0.0)
    return params.particle_mass * np.sum(c_poly6 * d**3, axis=1)


def pressure(rho: np.ndarray, params) -> np.ndarray:
    if params.eos == "tait":
        b = params.stiffness * params.rest_density / params.tait_gamma
        p = b * ((rho / params.rest_density) ** params.tait_gamma - 1.0)
    else:
        p = params.stiffness * (rho - params.rest_density)
    if params.clamp_negative_pressure:
        p = np.maximum(p, 0.0)
    return p


def accel(pos, vel, rho, pres, params) -> np.ndarray:
    h, dim, m = params.h, params.dim, params.particle_mass
    _, c_spiky, c_visc = _coefs(h, dim)
    diff = pos[:, None, :] - pos[None, :, :]
    r2 = np.sum(diff * diff, axis=-1)
    r = np.sqrt(np.maximum(r2, 1e-24))
    valid = (r2 < h * h) & (r2 > 1e-16)

    p_over_rho2 = pres / (rho * rho)
    g = c_spiky * np.maximum(h - r, 0.0) ** 2
    coef_p = np.where(valid, -m * (p_over_rho2[:, None]
                                   + p_over_rho2[None, :]) * g / r, 0.0)
    a_pres = np.sum(coef_p[..., None] * diff, axis=1)

    lap = c_visc * np.maximum(h - r, 0.0)
    inv_rho = 1.0 / rho
    coef_v = np.where(
        valid,
        params.viscosity * m * inv_rho[:, None] * inv_rho[None, :] * lap, 0.0)
    dvel = vel[None, :, :] - vel[:, None, :]
    a_visc = np.sum(coef_v[..., None] * dvel, axis=1)

    grav = np.asarray(params.gravity, pos.dtype)
    return a_pres + a_visc + grav


def _sdf_normal(pos, obstacle, dim):
    kind = obstacle[0]
    if kind == "sphere":
        _, center, radius = obstacle
        d = pos - np.asarray(center, pos.dtype)
        r = np.sqrt(np.sum(d * d, axis=-1) + 1e-20)
        return r - radius, d / r[..., None]
    if kind == "box":
        _, center, half = obstacle
        q = np.abs(pos - np.asarray(center, pos.dtype)) - np.asarray(
            half, pos.dtype)
        outside = np.maximum(q, 0.0)
        sdf_out = np.sqrt(np.sum(outside * outside, axis=-1) + 1e-20)
        qmax = np.max(q, axis=-1)
        sdf = np.where(qmax > 0.0, sdf_out, np.minimum(qmax, 0.0))
        n_out = outside * np.sign(pos - np.asarray(center, pos.dtype))
        n_out = n_out / (sdf_out[..., None] + 1e-20)
        axis = np.argmax(q, axis=-1)
        n_in = np.eye(dim, dtype=pos.dtype)[axis] * np.sign(
            pos - np.asarray(center, pos.dtype))
        n = np.where((qmax > 0.0)[..., None], n_out, n_in)
        return sdf, n
    raise ValueError(kind)


def collide(pos, vel, params):
    lo = np.asarray(params.bounds_min, pos.dtype)
    hi = np.asarray(params.bounds_max, pos.dtype)
    hit = (pos < lo) | (pos > hi)
    vel = np.where(hit, vel * (-params.restitution), vel)
    pos = np.clip(pos, lo, hi)
    for ob in params.obstacles:
        sdf, n = _sdf_normal(pos, ob, params.dim)
        inside = sdf < 0.0
        pos = np.where(inside[..., None], pos - sdf[..., None] * n, pos)
        vn = np.sum(vel * n, axis=-1)
        reflect = inside & (vn < 0.0)
        dv = (1.0 + params.restitution) * vn
        vel = np.where(reflect[..., None], vel - dv[..., None] * n, vel)
    return pos, vel


def step(pos, vel, params):
    """One float64 oracle step; returns (pos, vel, rho, pres)."""
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    rho = density(pos, params)
    pres = pressure(rho, params)
    a = accel(pos, vel, rho, pres, params)
    vel = vel + a * params.dt
    pos = pos + vel * params.dt
    pos, vel = collide(pos, vel, params)
    return pos, vel, rho, pres


def run(pos, vel, params, n_steps: int):
    for _ in range(n_steps):
        pos, vel, rho, pres = step(pos, vel, params)
    return pos, vel, rho, pres
