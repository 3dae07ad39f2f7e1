"""What decides ``correct``: the program's outputs against the reference.

A call of ``n`` steps cannot be followed by the reference step by step
from outside (the program keeps its state on the card between steps), and
a trajectory of 1,000 steps of a splashing flow is too long for any two
float implementations to agree particle by particle.  So the reference
follows the timed entry for ``check_steps`` steps from the timed call's
own input (the evolved state), and from the scene the harness made (the
warm-up's first method: the start of the stage it skips); each checked
frame is followed from its own input; and every timed call's returned
state is held to the configuration's guarantees (``Guard``).

Each comparison gives these numbers, particles matched by id (a cell's
``checks/<workload>.json`` names those it compares, each with its limit):

  pos_p999_h  the 99.9th percentile of the particles' position gaps, in h
  vel_p999_c  the 99.9th percentile of the velocity gaps, over the sound
              speed sqrt(stiffness)
  rho_p999    the 99.9th percentile of the returned density's gaps, over
              rho0
  pos_max_h   the largest position gap, in h: for the record only.  The
              few particles whose wall, floor or obstacle contact float32
              and float64 decide differently (the look: at the corner of
              the floor and the box pillar) carry gaps up to 0.7 h after
              80 steps, seed by seed, where the median particle's is 4e-5
              h; they set every widest gap and every root mean square, so
              the compared numbers leave out the worst thousandth.
and for a frame also
  fb_rel      the largest gap of the framebuffer from the reference's
              splat of the program's state, over the largest pixel
  img_levels  the largest gap of the image's 8-bit channels from the
              reference's tonemap of the program's framebuffer (the two
              stages checked apart: a pixel whose sum is nought in one
              and 1e-10 in the other is unlit in one image, lit in the
              other, 54 levels apart).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def by_id(ids: torch.Tensor, *arrays):
    """Rows reordered so that row k holds particle id k."""
    order = torch.argsort(ids.long())
    return [a[order] for a in arrays]


def q999(gaps: torch.Tensor) -> float:
    """The 99.9th percentile (the value of rank ceil(0.999 n))."""
    k = max(1, math.ceil(0.999 * gaps.numel()))
    return float(torch.kthvalue(gaps.flatten(), k).values)


def state_gaps(prog_ids, prog_pos, prog_vel, prog_rho, ref_ids, ref_pos,
               ref_vel, ref_rho, h: float, speed: float,
               rest: float) -> Dict[str, float]:
    """The state numbers (module docstring), in float64 on the device of
    the tensors."""
    pp, pv, pr = by_id(prog_ids, prog_pos.double(), prog_vel.double(),
                       prog_rho.double())
    rp, rv, rr = by_id(ref_ids, ref_pos.double(), ref_vel.double(),
                       ref_rho.double())
    dpos = torch.linalg.vector_norm(pp - rp, dim=-1)
    return {
        "pos_p999_h": q999(dpos) / h,
        "vel_p999_c": q999(torch.linalg.vector_norm(pv - rv, dim=-1))
        / speed,
        "rho_p999": q999(torch.abs(pr - rr)) / rest,
        "pos_max_h": float(dpos.max()) / h,
    }


def frame_gaps(prog_fb, prog_img, ref_fb, ref_img) -> Dict[str, float]:
    """``ref_fb``: the reference's splat of the program's state;
    ``ref_img``: the reference's tonemap of the program's framebuffer."""
    pf = prog_fb.double().cpu()
    rf = ref_fb.double().cpu()
    return {
        "fb_rel": float((pf - rf).abs().max() / rf.abs().max()),
        "img_levels": float(np.abs(prog_img.astype(np.int16)
                                   - ref_img.astype(np.int16)).max()),
    }


def worst(readings) -> Dict[str, float]:
    """Per name, the largest reading over several comparisons."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v) if np.isfinite(v) else float("inf")
    return out


def verdict(numbers: Dict[str, float], limits) -> tuple:
    """(every number within its limit, [(name, number, limit)]).  A number
    without a limit, or a limit without its number, fails."""
    if not limits:
        return False, [(k, v, None) for k, v in numbers.items()]
    rows = [(k, numbers.get(k, float("inf")), lim)
            for k, lim in limits.items()]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


class Guard:
    """The configuration's guarantees on a returned state: ``guard(state)``
    is a () int64 tensor on the state's device, 1 when a particle was lost
    to overflow, a value is not finite, an id is missing, or a particle
    lies more than ``tol_h`` h outside the walls or inside an obstacle,
    else 0.  (The walls and obstacles are applied in turn, in float32: a
    particle pushed out of the box that stands on the floor lands on the
    floor to within rounding, either side of it.)  It queues work on the
    card and reads nothing back."""

    def __init__(self, const, device, tol_h: float = 1e-3):
        def t(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        self.lo, self.hi = t(const.bounds_min), t(const.bounds_max)
        self.tol = tol_h * const.h
        self.obstacles = [(kind, t(centre), t(extent))
                          for kind, centre, extent in const.obstacles]

    def __call__(self, state) -> torch.Tensor:
        pos = state.pos
        bad = (state.overflow > 0).long() + (state.ids < 0).sum()
        for a in (pos, state.vel, state.rho):
            bad = bad + (~torch.isfinite(a)).sum()
        bad = bad + ((pos < self.lo - self.tol)
                     | (pos > self.hi + self.tol)).sum()
        for kind, centre, extent in self.obstacles:
            if kind == "sphere":
                depth = extent - torch.linalg.vector_norm(pos - centre,
                                                          dim=-1)
            else:
                depth = -torch.amax(torch.abs(pos - centre) - extent,
                                    dim=-1)
            bad = bad + (depth > self.tol).sum()
        return (bad > 0).long()

    def explain(self, state) -> dict:
        """What ``__call__`` found, by guarantee (read back to the host)."""
        pos = state.pos
        out = {"overflow": int(state.overflow),
               "ids_missing": int((state.ids < 0).sum()),
               "not_finite": int(sum((~torch.isfinite(a)).sum()
                                     for a in (pos, state.vel, state.rho))),
               "outside_walls": int(((pos < self.lo - self.tol)
                                     | (pos > self.hi + self.tol))
                                    .any(dim=-1).sum())}
        for i, (kind, centre, extent) in enumerate(self.obstacles):
            if kind == "sphere":
                depth = extent - torch.linalg.vector_norm(pos - centre,
                                                          dim=-1)
            else:
                depth = -torch.amax(torch.abs(pos - centre) - extent,
                                    dim=-1)
            out[f"inside_{kind}_{i}"] = int((depth > self.tol).sum())
            out[f"depth_{kind}_{i}_h"] = float(depth.max()) / self.tol \
                * 1e-3
        return out

