"""Inputs from a configuration file and a seed.

A configuration names a scene of fluid boxes and obstacles in a box
domain, as the upstream project's dam-break scenes build them: a regular
lattice of spacing dx = (V / n_request) ** (1 / dim) in every fluid box
(each box offset by half a spacing from its lower corner), V the product
of ``fluid_volume``'s factors, and the physical constants that follow
from dx (the lattice's spacing taken back from h, h / eta, as the
program's scenes take it, so both agree to the last bit):

    h = eta dx,  mass = rest_density dx^dim,
    c = sound_speed_factor sqrt(2 g max(height, 0.1)),  stiffness = c^2,
    dt = cfl h / c.

``--seed`` draws the lattice jitter (uniform in +-jitter dx on each axis,
the box's own stream: seed + box index), so every seed gives the same
particle count and scene, with another small disorder of the lattice.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np

SEED_MOD = 2 ** 63


class Constants(NamedTuple):
    """The physical constants both sides run, as Python floats."""
    dim: int
    h: float
    mass: float
    rest_density: float
    stiffness: float
    viscosity: float
    dt: float
    gravity: Tuple[float, ...]
    bounds_min: Tuple[float, ...]
    bounds_max: Tuple[float, ...]
    restitution: float
    obstacles: tuple
    cell_capacity: int


def spacing(cfg: dict) -> float:
    sc = cfg["scene"]
    return (math.prod(sc["fluid_volume"]) / sc["n_request"]) \
        ** (1.0 / sc["dim"])


def constants(cfg: dict) -> Constants:
    sc, ph = cfg["scene"], cfg["physics"]
    if (ph["eos"], ph["clamp_negative_pressure"], ph["precision"]) != (
            "linear", True, "float32"):
        raise ValueError("the harness and its reference run the linear "
                         "equation of state, clamped, in float32 only")
    dim = sc["dim"]
    dx = spacing(cfg)
    h = ph["eta"] * dx
    g = ph["gravity"]
    c = ph["sound_speed_factor"] * math.sqrt(
        2.0 * abs(g[1]) * max(sc["height"], 0.1))
    obstacles = tuple(
        (o[0], tuple(o[1]), tuple(o[2]) if isinstance(o[2], list) else o[2])
        for o in sc["obstacles"])
    return Constants(
        dim=dim, h=h, mass=ph["rest_density"] * dx ** dim,
        rest_density=ph["rest_density"], stiffness=c * c,
        viscosity=ph["viscosity"], dt=ph["cfl"] * h / c,
        gravity=tuple(g), bounds_min=tuple(sc["bounds"][0]),
        bounds_max=tuple(sc["bounds"][1]),
        restitution=ph["restitution"], obstacles=obstacles,
        cell_capacity=ph["cell_capacity"])


def positions(cfg: dict, seed: int) -> np.ndarray:
    """(N, dim) float32 lattice positions of every fluid box, jittered by
    the seed."""
    eta = cfg["physics"]["eta"]
    dx = eta * spacing(cfg) / eta
    jitter = cfg["assumed"]["jitter"]
    seed = int(seed) % SEED_MOD
    parts = []
    for i, (lo, hi) in enumerate(cfg["scene"]["fluid_boxes"]):
        axes = [np.arange(lo[d] + 0.5 * dx, hi[d] - 1e-9, dx)
                for d in range(len(lo))]
        grids = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([g.ravel() for g in grids], axis=-1)
        if jitter > 0.0:
            rng = np.random.default_rng(seed + i)
            pts = pts + rng.uniform(-jitter * dx, jitter * dx, pts.shape)
        parts.append(pts.astype(np.float32))
    return np.concatenate(parts, axis=0)
