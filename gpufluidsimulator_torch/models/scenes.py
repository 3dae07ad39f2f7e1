"""Scene construction: dam break, double dam break (+ obstacles), spawn boxes.

Counterpart: ``gpufluidsimulator_tpu/models/scenes.py``.  The numpy lattice
code and the derived SPH constants are the same, so both packages build
bitwise-equal initial positions and equal parameters from the same call.
Every scene takes ``device`` (default: the card, see
``state.resolve_device``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.planes import snap_cell
from .params import SimParams
from .state import DeviceLike, State, make_state

_ETA = 1.3          # h / dx smoothing ratio
_CFL = 0.35


def _lattice(box_min: Sequence[float], box_max: Sequence[float], dx: float,
             jitter: float = 0.0, seed: int = 0) -> np.ndarray:
    """Fill an axis-aligned box with a regular particle lattice."""
    dim = len(box_min)
    axes = [np.arange(box_min[d] + 0.5 * dx, box_max[d] - 1e-9, dx)
            for d in range(dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    if jitter > 0.0:
        rng = np.random.default_rng(seed)
        pts = pts + rng.uniform(-jitter * dx, jitter * dx, pts.shape)
    return pts.astype(np.float32)


def _derive(n_request: int, fluid_vol: float, dim: int, height: float,
            bounds: Tuple[Tuple[float, ...], Tuple[float, ...]],
            obstacles=()) -> SimParams:
    dx = (fluid_vol / n_request) ** (1.0 / dim)
    h = _ETA * dx
    rho0 = 1000.0
    mass = rho0 * dx**dim
    # speed of sound ~ 10x the dam-break free-fall speed
    v_max = math.sqrt(2.0 * 9.81 * max(height, 0.1))
    c_s = 10.0 * v_max
    stiffness = c_s * c_s
    dt = _CFL * h / c_s
    grav = tuple(-9.81 if d == 1 else 0.0 for d in range(dim))
    params = SimParams(dim=dim, h=h, rest_density=rho0, stiffness=stiffness,
                       viscosity=0.25, particle_mass=mass, dt=dt, gravity=grav,
                       bounds_min=bounds[0], bounds_max=bounds[1],
                       obstacles=tuple(obstacles))
    # fold grids that land just past an x-tile / y-tile boundary back under
    # it (see planes.snap_cell)
    return snap_cell(params)


def dam_break(n: int = 4096, dim: int = 2, jitter: float = 0.0,
              seed: int = 0, device: DeviceLike = None
              ) -> Tuple[SimParams, State]:
    """A fluid column over 40% of x and 80% of y (full z in 3D) of a unit
    box."""
    lo = tuple(0.0 for _ in range(dim))
    hi = tuple(1.0 for _ in range(dim))
    col_max = [0.4, 0.8] + ([1.0] if dim == 3 else [])
    vol = math.prod(col_max)
    params = _derive(n, vol, dim, height=0.8, bounds=(lo, hi))
    dx = params.h / _ETA
    pos = _lattice(lo, col_max, dx, jitter=jitter, seed=seed)
    return params, make_state(pos, device=device)


def double_dam_break(n: int = 1_000_000, dim: int = 3, jitter: float = 0.0,
                     seed: int = 0, device: DeviceLike = None
                     ) -> Tuple[SimParams, State]:
    """Two opposing fluid columns plus a box pillar and a sphere."""
    lo = tuple(0.0 for _ in range(dim))
    hi = tuple(1.0 for _ in range(dim))
    frac = [0.25, 0.7] + ([1.0] if dim == 3 else [])
    vol = 2.0 * math.prod(frac)
    if dim == 3:
        obstacles = (
            ("box", (0.5, 0.15, 0.5), (0.06, 0.15, 0.06)),
            ("sphere", (0.5, 0.45, 0.5), 0.08),
        )
    else:
        obstacles = (
            ("box", (0.5, 0.12), (0.05, 0.12)),
            ("sphere", (0.5, 0.4), 0.07),
        )
    params = _derive(n, vol, dim, height=0.7, bounds=(lo, hi),
                     obstacles=obstacles)
    dx = params.h / _ETA
    left = _lattice(lo, [0.25, 0.7] + ([1.0] if dim == 3 else []), dx,
                    jitter=jitter, seed=seed)
    right_lo = [0.75, 0.0] + ([0.0] if dim == 3 else [])
    right = _lattice(right_lo, hi, dx, jitter=jitter, seed=seed + 1)
    pos = np.concatenate([left, right], axis=0)
    return params, make_state(pos, device=device)


def spawn_box(params: SimParams,
              box_min: Sequence[float], box_max: Sequence[float],
              velocity: Optional[Sequence[float]] = None,
              jitter: float = 0.0, seed: int = 0,
              device: DeviceLike = None) -> State:
    """A lattice-filled box of particles under existing params."""
    dx = params.h / _ETA
    pos = _lattice(box_min, box_max, dx, jitter=jitter, seed=seed)
    vel = None
    if velocity is not None:
        vel = np.broadcast_to(np.asarray(velocity, np.float32),
                              pos.shape).copy()
    return make_state(pos, vel, device=device)


def add_states(a: State, b: State) -> State:
    """Concatenate two particle sets (multiple spawn boxes in one scene)."""
    return State(
        pos=torch.cat([a.pos, b.pos], dim=0),
        vel=torch.cat([a.vel, b.vel], dim=0),
        rho=torch.cat([a.rho, b.rho], dim=0),
        pres=torch.cat([a.pres, b.pres], dim=0),
        ids=torch.cat([a.ids, b.ids + a.n], dim=0),
        overflow=a.overflow + b.overflow,
    )


def spawn_boxes(n: int = 4096, dim: int = 2, jitter: float = 0.0,
                seed: int = 0, boxes: Optional[Sequence[Tuple]] = None,
                device: DeviceLike = None) -> Tuple[SimParams, State]:
    """Several spawn boxes in one scene.

    ``boxes``: sequence of (box_min, box_max[, velocity]) in the unit box.
    Default: a resting pool in the lower part plus a block dropped into it
    with a downward kick.  ``n`` is the total particle budget, shared in
    proportion to the boxes' volumes.
    """
    lo = tuple(0.0 for _ in range(dim))
    hi = tuple(1.0 for _ in range(dim))
    if boxes is None:
        pool = ([0.0] * dim, [1.0, 0.3] + [1.0] * (dim - 2))
        drop_lo = [0.35, 0.6] + ([0.35] if dim == 3 else [])
        drop_hi = [0.65, 0.9] + ([0.65] if dim == 3 else [])
        kick = tuple(-1.0 if d == 1 else 0.0 for d in range(dim))
        boxes = [pool, (drop_lo, drop_hi, kick)]
    vol = 0.0
    height = 0.1
    for b in boxes:
        bmin, bmax = b[0], b[1]
        vol += math.prod(max(bmax[d] - bmin[d], 0.0) for d in range(dim))
        height = max(height, bmax[1] - bmin[1])
    params = _derive(n, vol, dim, height=height, bounds=(lo, hi))
    state = None
    for i, b in enumerate(boxes):
        bmin, bmax = b[0], b[1]
        velocity = b[2] if len(b) > 2 else None
        s = spawn_box(params, bmin, bmax, velocity=velocity,
                      jitter=jitter, seed=seed + i, device=device)
        state = s if state is None else add_states(state, s)
    return params, state


SCENES = {
    "dam_break": dam_break,
    "double_dam_break": double_dam_break,
    "spawn_boxes": spawn_boxes,
}
