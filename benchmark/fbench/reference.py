"""The plain reference: weakly compressible SPH on a cell list, and the
frame's splat and tonemap, in plain PyTorch.

Written from the method's equations, independent of the code under test
(it imports torch, numpy and the standard library only).  In float64 it
is the yardstick.  Given bfloat16 it is the control, the precision below
the float32 the configuration states, as a program that moved its pair
arithmetic there would run: every pair term and per-particle factor in
bfloat16, the sums and the particles' state in float32.

For particles i and neighbours j within the support radius h
(r = |x_i - x_j|, poly6 / spiky / viscosity kernels of Mueller et al.):

    rho_i = m sum_j W(r)                          (j = i included)
    W(r)  = 315 / (64 pi h^9) (h^2 - r^2)^3
    p_i   = max(k (max(rho_i, 1e-3 rho0) - rho0), 0)
    a_i   = sum_{j != i} m C (p_i / rho_i^2 + p_j / rho_j^2) (h - r)^2
              (x_i - x_j) / r
          + sum_{j != i} mu m C (h - r) (v_j - v_i) / (rho_i rho_j)  + g,
            C = 45 / (pi h^6)
    v <- v + a dt;  x <- x + v dt;  then the walls (clamp each axis into
    the box, the velocity of an axis that left it times -restitution),
    then each obstacle in turn (a particle inside is moved out along the
    signed distance's normal, and an inward normal velocity is reflected
    with (1 + restitution)).

The continuity tier ("rate" form with the clamped correction, beta = 1)
carries each particle's density instead of summing it:

    rho_i' = rho_i - 6 dt W0 m sum_{j != i} (h^2 - r^2)^2 (v_i - v_j).(x_i - x_j),
             W0 = 315 / (64 pi h^9),
    the pressure term's factor less clamp(c_corr (h^2 - r^2)^2
    (v_i - v_j).(x_i - x_j), -cap, cap), with
    c_corr = beta C m 12 W0 m k dt / rho0^2 and cap = 0.2 C m k / rho0,
    and the carried density re-summed (rho_i above) at the call's first
    step and every ``resum_every`` steps after it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

OFFSETS3 = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]


class Pairs(NamedTuple):
    """Ordered pairs (i, j), i != j, with |x_i - x_j| < h, and their
    separation x_i - x_j and squared distance."""
    i: torch.Tensor
    j: torch.Tensor
    d: torch.Tensor
    r2: torch.Tensor


def cell_pairs(pos: torch.Tensor, h: float, lo, hi) -> Pairs:
    """All ordered pairs within h, found on a grid of cells of edge >= h
    (a particle's neighbours lie in its own and the 3^dim adjacent
    cells)."""
    n, dim = pos.shape
    dev = pos.device
    res = [max(1, int(math.floor((hi[d] - lo[d]) / h))) for d in range(dim)]
    edge = [(hi[d] - lo[d]) / res[d] for d in range(dim)]
    c = torch.stack([
        torch.clamp(torch.floor(torch.nan_to_num(
            (pos[:, d].double() - lo[d]) / edge[d])), 0, res[d] - 1).long()
        for d in range(dim)], dim=1)
    strides = [1]
    for d in range(1, dim):
        strides.append(strides[-1] * res[d - 1])
    key = sum(c[:, d] * strides[d] for d in range(dim))
    order = torch.argsort(key)
    ks, cs, ps = key[order], c[order], pos[order]
    n_cells = math.prod(res)
    counts = torch.bincount(ks, minlength=n_cells)
    starts = torch.cumsum(counts, 0) - counts
    occ = int(counts.max())
    slots = torch.arange(occ, device=dev)
    me = torch.arange(n, device=dev)
    h2 = h * h
    out_i, out_j = [], []
    offsets = OFFSETS3 if dim == 3 else [(0,) + o[1:] for o in OFFSETS3[9:18]]
    step = max(1, (1 << 25) // max(1, occ * dim))   # bounded temporaries
    for off in offsets:
        shift = off[::-1][:dim]               # (dx, dy[, dz])
        for a0 in range(0, n, step):
            sl = slice(a0, min(n, a0 + step))
            nc = cs[sl] + torch.tensor(shift, device=dev)
            inside = torch.ones(nc.shape[0], dtype=torch.bool, device=dev)
            for d in range(dim):
                inside &= (nc[:, d] >= 0) & (nc[:, d] < res[d])
            nkey = sum(torch.clamp(nc[:, d], 0, res[d] - 1) * strides[d]
                       for d in range(dim))
            cnt = torch.where(inside, counts[nkey], 0)
            j = starts[nkey][:, None] + slots[None, :]
            live = slots[None, :] < cnt[:, None]
            j = torch.where(live, j, 0)
            dd = ps[sl][:, None, :] - ps[j]
            r2 = torch.sum(dd * dd, dim=-1)
            keep = live & (r2 < h2) & (j != me[sl][:, None])
            a, b = torch.nonzero(keep, as_tuple=True)
            out_i.append(a + a0)
            out_j.append(j[a, b])
    i = order[torch.cat(out_i)]
    j = order[torch.cat(out_j)]
    d = pos[i] - pos[j]
    return Pairs(i=i, j=j, d=d, r2=torch.sum(d * d, dim=-1))


def pair_count(pos: torch.Tensor, h: float, lo, hi) -> int:
    """Ordered pairs (i != j) within h, from float64 positions."""
    return int(cell_pairs(pos.double(), h, lo, hi).i.numel())


class Reference:
    """One scene's constants (``scene.Constants``) and its steps: the pair
    arithmetic in ``dtype``, the sums and the state in float64 when
    ``dtype`` is, else in float32."""

    def __init__(self, const, dtype=torch.float64, resum_every: int = 64):
        self.c = const
        self.pd = dtype
        self.dtype = torch.float64 if dtype == torch.float64 \
            else torch.float32
        self.resum_every = resum_every
        h = const.h
        dim = const.dim
        if dim == 3:
            self.w0 = 315.0 / (64.0 * math.pi * h ** 9)
            self.cs = 45.0 / (math.pi * h ** 6)
            self.cv = 45.0 / (math.pi * h ** 6)
        else:
            self.w0 = 4.0 / (math.pi * h ** 8)
            self.cs = 30.0 / (math.pi * h ** 5)
            self.cv = 40.0 / (math.pi * h ** 5)

    # -- sums over pairs ----------------------------------------------------
    def pairs(self, x):
        return cell_pairs(x, self.c.h, self.c.bounds_min, self.c.bounds_max)

    def density(self, x, pr: Pairs):
        c = self.c
        h2 = c.h * c.h
        d = pr.d.to(self.pd)
        w = c.mass * self.w0 * (h2 - torch.sum(d * d, dim=-1)) ** 3
        rho = torch.full((x.shape[0],), c.mass * self.w0 * h2 ** 3,
                         dtype=x.dtype, device=x.device)
        return rho.index_add(0, pr.i, w.to(x.dtype))

    def accel(self, x, v, rho, pr: Pairs, cont: bool):
        """-> (acceleration with gravity, the continuity sum or None)."""
        c = self.c
        rest = c.rest_density
        rho_s = torch.clamp_min(rho.to(self.pd), 1e-3 * rest)
        p = torch.clamp_min(c.stiffness * (rho_s - rest), 0.0)
        por2 = p / (rho_s * rho_s)
        d = pr.d.to(self.pd)
        r2 = torch.sum(d * d, dim=-1)
        r = torch.sqrt(torch.clamp_min(r2, 1e-16))
        hr = c.h - r
        fac = c.mass * self.cs * (por2[pr.i] + por2[pr.j])
        dv = (v[pr.i] - v[pr.j]).to(self.pd)
        sr = None
        if cont:
            dot = torch.sum(dv * d, dim=-1)
            d4dot = (c.h * c.h - r2) ** 2 * dot
            c_corr = (self.cs * c.mass * 12.0 * self.w0 * c.mass
                      * c.stiffness * c.dt / rest ** 2)
            cap = self.cs * c.mass * c.stiffness * 0.2 / rest
            fac = fac - torch.clamp(c_corr * d4dot, -cap, cap)
            sr = torch.zeros_like(rho).index_add(0, pr.i, d4dot.to(x.dtype))
        term = (fac * hr * hr / r)[:, None] * d \
            - (c.viscosity * c.mass * self.cv * hr
               / (rho_s[pr.i] * rho_s[pr.j]))[:, None] * dv
        acc = torch.zeros_like(x).index_add(0, pr.i, term.to(x.dtype))
        g = torch.tensor(c.gravity, dtype=x.dtype, device=x.device)
        return acc + g, sr

    # -- walls and obstacles ------------------------------------------------
    def collide(self, x, v):
        c = self.c
        lo = torch.tensor(c.bounds_min, dtype=x.dtype, device=x.device)
        hi = torch.tensor(c.bounds_max, dtype=x.dtype, device=x.device)
        hit = (x < lo) | (x > hi)
        v = torch.where(hit, -c.restitution * v, v)
        x = torch.minimum(torch.maximum(x, lo), hi)
        for kind, centre, extent in c.obstacles:
            ctr = torch.tensor(centre, dtype=x.dtype, device=x.device)
            if kind == "sphere":
                dd = x - ctr
                rr = torch.sqrt(torch.sum(dd * dd, dim=-1) + 1e-20)
                sdf = rr - extent
                nrm = dd / rr[:, None]
            elif kind == "box":
                half = torch.tensor(extent, dtype=x.dtype, device=x.device)
                q = torch.abs(x - ctr) - half
                sdf, axis = torch.max(q, dim=-1)
                sgn = torch.sign(x - ctr)
                nrm = torch.nn.functional.one_hot(axis, c.dim).to(x.dtype) \
                    * sgn
            else:
                raise ValueError(f"unknown obstacle kind {kind!r}")
            inside = sdf < 0.0
            x = torch.where(inside[:, None], x - sdf[:, None] * nrm, x)
            vn = torch.sum(v * nrm, dim=-1)
            refl = inside & (vn < 0.0)
            v = torch.where(refl[:, None],
                            v - ((1.0 + c.restitution) * vn)[:, None] * nrm,
                            v)
        return x, v

    # -- steps ----------------------------------------------------------------
    def run(self, x, v, n_steps: int, continuity: bool = False):
        """``n_steps`` steps from (x, v) -> (x, v, rho_final, rho_last):
        rho_final the summed density at the final positions, rho_last the
        density the last step's pressure read (clamped at 1e-3 rho0)."""
        c = self.c
        x = x.to(self.dtype)
        v = v.to(self.dtype)
        carried = None
        rho = None
        for age in range(n_steps):
            pr = self.pairs(x)
            if not continuity or age % self.resum_every == 0:
                rho = self.density(x, pr)
            else:
                rho = carried
            acc, sr = self.accel(x, v, rho, pr, continuity)
            if continuity:
                carried = rho - 6.0 * c.dt * self.w0 * c.mass * sr
            v = v + acc * c.dt
            x = x + v * c.dt
            x, v = self.collide(x, v)
        rho_last = None if rho is None else torch.clamp_min(
            rho, 1e-3 * c.rest_density)
        rho_final = self.density(x, self.pairs(x))
        return x, v, rho_final, rho_last


# --------------------------------------------------------------------------
# the frame: an orthographic camera, a bilinear splat, a tonemap
# --------------------------------------------------------------------------

def camera(dim: int, azimuth: float, elevation: float) -> np.ndarray:
    """World -> (right, up, depth): a turn by ``azimuth`` about y, then by
    ``elevation`` about x."""
    if dim == 2:
        return np.eye(2)
    a, e = math.radians(azimuth), math.radians(elevation)
    turn_y = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                       [-math.sin(a), 0.0, math.cos(a)]])
    turn_x = np.array([[1.0, 0.0, 0.0], [0.0, math.cos(e), math.sin(e)],
                       [0.0, -math.sin(e), math.cos(e)]])
    return turn_x @ turn_y


def splat(x, v, lo, hi, width: int, height: int, azimuth: float,
          elevation: float, dtype=torch.float64) -> torch.Tensor:
    """(height, width) intensity: each particle adds (0.3 + |v|) times its
    depth shade (0.55 + 0.45 depth, depth in [0, 1]) to the four pixels
    around its projection, bilinearly.  Per-particle arithmetic in
    ``dtype``, the sums in float64 when ``dtype`` is, else float32."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    x = x.to(dtype)
    v = v.to(dtype)
    dim = x.shape[1]
    lo_t = torch.tensor(lo, dtype=dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=dtype, device=x.device)
    cam = torch.tensor(camera(dim, azimuth, elevation), dtype=dtype,
                       device=x.device)
    proj = ((x - lo_t) / (hi_t - lo_t) - 0.5) @ cam.T
    u = (proj[:, 0] + 0.5) * (width - 1)
    w_ = (0.5 - proj[:, 1]) * (height - 1)
    if dim == 3:
        shade = 0.55 + 0.45 * torch.clamp(proj[:, 2] + 0.5, 0.0, 1.0)
    else:
        shade = torch.ones_like(u)
    weight = shade * (0.3 + torch.sqrt(torch.sum(v * v, dim=-1)))
    u0, w0 = torch.floor(u), torch.floor(w_)
    fu, fw = u - u0, w_ - w0
    fb = torch.zeros(height * width, dtype=acc, device=x.device)
    for du, dw, bw in ((0, 0, (1 - fu) * (1 - fw)), (1, 0, fu * (1 - fw)),
                       (0, 1, (1 - fu) * fw), (1, 1, fu * fw)):
        px = u0.long() + du
        py = w0.long() + dw
        ok = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        fb.index_add_(0, (py * width + px)[ok], (weight * bw)[ok].to(acc))
    return fb.reshape(height, width)


def tonemap(fb: np.ndarray, dtype=np.float64,
            gamma: float = 0.45) -> np.ndarray:
    """Intensity -> (H, W, 3) uint8: scaled by the 95th percentile of the
    lit pixels, gamma 0.45, a blue -> cyan -> white ramp, unlit pixels
    dark blue; the arithmetic in ``dtype``."""
    fb = np.asarray(fb, dtype)
    lit = fb > 0
    scale = np.percentile(fb[lit], 95.0) if lit.any() else 1.0
    t = np.clip(fb / dtype(max(scale, 1e-9)), 0.0, 1.0) ** dtype(gamma)
    rgb = np.stack([np.clip(1.8 * t - 0.8, 0.0, 1.0),
                    np.clip(1.4 * t - 0.15, 0.0, 1.0),
                    np.clip(0.25 + 1.1 * t, 0.0, 1.0) * (t > 0)
                    + 0.04 * (t == 0)], axis=-1)
    return (rgb * 255.0 + 0.5).astype(np.uint8)
