"""Shared physics pieces: equation of state, boundary and obstacle response,
symplectic Euler integration.

Counterpart: ``gpufluidsimulator_tpu/ops/physics.py``; same math in the same
operation order, on float32 tensors.
"""

from __future__ import annotations

import torch

from ..models.params import SimParams


def eos_pressure(rho: torch.Tensor, params: SimParams) -> torch.Tensor:
    """Pressure from density.

    linear:  p = k (rho - rho_0)
    tait:    p = k rho_0/gamma ((rho/rho_0)^gamma - 1)
    """
    if params.eos == "tait":
        b = params.stiffness * params.rest_density / params.tait_gamma
        p = b * ((rho / params.rest_density) ** params.tait_gamma - 1.0)
    else:
        p = params.stiffness * (rho - params.rest_density)
    if params.clamp_negative_pressure:
        p = torch.clamp_min(p, 0.0)
    return p


def _obstacle_sdf_normal(pos: torch.Tensor, obstacle, dim: int):
    """Signed distance (negative inside) and outward normal for one obstacle.

    pos: (..., dim). Returns (sdf (...,), normal (..., dim)).
    """
    kind = obstacle[0]
    if kind == "sphere":
        _, center, radius = obstacle
        c = torch.tensor(center, dtype=pos.dtype, device=pos.device)
        d = pos - c
        r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-20)
        return r - radius, d / r[..., None]
    if kind == "box":
        _, center, half = obstacle
        c = torch.tensor(center, dtype=pos.dtype, device=pos.device)
        hx = torch.tensor(half, dtype=pos.dtype, device=pos.device)
        q = torch.abs(pos - c) - hx                      # per-axis distance
        outside = torch.clamp_min(q, 0.0)
        sdf_out = torch.sqrt(torch.sum(outside * outside, dim=-1) + 1e-20)
        qmax = torch.amax(q, dim=-1)
        sdf_in = torch.clamp_max(qmax, 0.0)
        sdf = torch.where(qmax > 0.0, sdf_out, sdf_in)
        # outside: gradient of the outside distance; inside: the FIRST axis
        # attaining the max (torch.argmax returns the first maximal index,
        # as jnp.argmax does)
        sgn = torch.sign(pos - c)
        n_out = outside * sgn / (sdf_out[..., None] + 1e-20)
        axis = torch.argmax(q, dim=-1)
        n_in = torch.nn.functional.one_hot(axis, dim).to(pos.dtype) * sgn
        n = torch.where((qmax > 0.0)[..., None], n_out, n_in)
        return sdf, n
    raise ValueError(f"unknown obstacle kind {kind!r}")


def collide(pos: torch.Tensor, vel: torch.Tensor, params: SimParams):
    """Walls: clamp position to the box and reflect the normal velocity,
    damped by ``restitution``.  Obstacles: project out along the SDF normal
    and reflect the inward normal velocity."""
    lo = torch.tensor(params.bounds_min, dtype=pos.dtype, device=pos.device)
    hi = torch.tensor(params.bounds_max, dtype=pos.dtype, device=pos.device)
    damp = -params.restitution

    hit = (pos < lo) | (pos > hi)
    vel = torch.where(hit, vel * damp, vel)
    pos = torch.clamp(pos, lo, hi)

    for ob in params.obstacles:
        sdf, n = _obstacle_sdf_normal(pos, ob, params.dim)
        inside = sdf < 0.0
        pos = torch.where(inside[..., None], pos - sdf[..., None] * n, pos)
        vn = torch.sum(vel * n, dim=-1)
        reflect = inside & (vn < 0.0)
        dv = (1.0 + params.restitution) * vn
        vel = torch.where(reflect[..., None], vel - dv[..., None] * n, vel)
    return pos, vel


def integrate(pos, vel, acc, params: SimParams):
    """Symplectic Euler: v += a dt;  x += v dt;  then collide."""
    vel = vel + acc * params.dt
    pos = pos + vel * params.dt
    return collide(pos, vel, params)


def collide_axes(ps, vs, params: SimParams):
    """``collide`` on axis-separated component lists (same math, same op
    order) — the form a fused integrate epilogue uses."""
    dim = len(ps)
    lo, hi = params.bounds_min, params.bounds_max
    damp = -params.restitution
    ps = list(ps)
    vs = list(vs)
    for d in range(dim):
        hit = (ps[d] < lo[d]) | (ps[d] > hi[d])
        vs[d] = torch.where(hit, vs[d] * damp, vs[d])
        ps[d] = torch.clamp(ps[d], lo[d], hi[d])

    for ob in params.obstacles:
        kind = ob[0]
        if kind == "sphere":
            _, center, radius = ob
            dvec = [ps[d] - center[d] for d in range(dim)]
            r = torch.sqrt(sum(x * x for x in dvec) + 1e-20)
            sdf = r - radius
            n = [x / r for x in dvec]
        elif kind == "box":
            _, center, half = ob
            q = [torch.abs(ps[d] - center[d]) - half[d] for d in range(dim)]
            qmax = q[0]
            for d in range(1, dim):
                qmax = torch.maximum(qmax, q[d])
            outside = [torch.clamp_min(x, 0.0) for x in q]
            sdf_out = torch.sqrt(sum(x * x for x in outside) + 1e-20)
            sgn = [torch.sign(ps[d] - center[d]) for d in range(dim)]
            n_out = [outside[d] * sgn[d] / (sdf_out + 1e-20)
                     for d in range(dim)]
            # inside normal: FIRST axis attaining the max (argmax semantics)
            taken = None
            is_max = []
            for d in range(dim):
                m = q[d] == qmax
                if taken is not None:
                    m = m & ~taken
                taken = m if taken is None else (taken | m)
                is_max.append(m)
            is_out = qmax > 0.0
            sdf = torch.where(is_out, sdf_out, torch.clamp_max(qmax, 0.0))
            zero = torch.zeros_like(qmax)
            n = [torch.where(is_out, n_out[d],
                             torch.where(is_max[d], sgn[d], zero))
                 for d in range(dim)]
        else:
            raise ValueError(f"unknown obstacle kind {kind!r}")
        inside = sdf < 0.0
        ps = [torch.where(inside, ps[d] - sdf * n[d], ps[d])
              for d in range(dim)]
        vn = sum(vs[d] * n[d] for d in range(dim))
        reflect = inside & (vn < 0.0)
        dv = (1.0 + params.restitution) * vn
        vs = [torch.where(reflect, vs[d] - dv * n[d], vs[d])
              for d in range(dim)]
    return ps, vs
