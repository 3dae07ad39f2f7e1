"""Simulation parameter surface.

Counterpart: ``gpufluidsimulator_tpu/models/params.py``.  Same fields,
defaults, validation and derived properties, so a parameter set converts
between the two packages field by field (``convert.params_from_dict``).

A frozen dataclass of Python scalars and tuples: the kernels receive the
derived constants (kernel normalisations, grid strides, EOS constants) as
scalar launch arguments computed in Python float64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# Obstacle descriptors:
#   ("box",    (cx, cy[, cz]), (hx, hy[, hz]))   axis-aligned box, half-extents
#   ("sphere", (cx, cy[, cz]), radius)
Obstacle = Tuple


@dataclasses.dataclass(frozen=True)
class SimParams:
    """All physical and numerical constants for one simulation."""

    dim: int = 3                       # 2 or 3
    h: float = 0.04                    # smoothing / interaction radius
    rest_density: float = 1000.0       # rho_0
    stiffness: float = 2000.0          # EOS gas constant k:  p = k (rho - rho_0)
    viscosity: float = 0.25            # dynamic viscosity mu
    particle_mass: float = 1.0
    dt: float = 4e-4
    gravity: Tuple[float, ...] = (0.0, -9.81, 0.0)
    bounds_min: Tuple[float, ...] = (0.0, 0.0, 0.0)
    bounds_max: Tuple[float, ...] = (1.0, 1.0, 1.0)
    restitution: float = 0.5           # boundary bounce damping in [0, 1]
    clamp_negative_pressure: bool = True
    # EOS selection: "linear" (k*(rho-rho0)) or "tait" (WCSPH, gamma=7)
    eos: str = "linear"
    tait_gamma: float = 7.0
    # binning cell edge; 0.0 -> h
    cell_size: float = 0.0
    # per-axis binning cell sizes (overrides cell_size when non-empty); axis
    # 0 may be finer than h, the other axes must stay >= h
    cell_aniso: Tuple[float, ...] = ()
    # K: fixed particle slots (ranks) per cell
    cell_capacity: int = 8
    obstacles: Tuple[Obstacle, ...] = ()
    # gather per-particle rho/pres each step
    diagnostics: bool = True
    # continuity-density tier knobs (used by the incremental pipeline; kept
    # here so parameter sets convert between the packages unchanged)
    cont_alpha: float = 0.0
    cont_delta: float = 0.0
    cont_beta: float = 1.0
    cont_form: str = "rate"
    cont_relax: float = 0.125

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        for name in ("gravity", "bounds_min", "bounds_max"):
            v = getattr(self, name)
            if len(v) != self.dim:
                raise ValueError(
                    f"{name} has length {len(v)} but dim={self.dim}"
                )
        if self.eos not in ("linear", "tait"):
            raise ValueError(f"unknown eos {self.eos!r}")
        if self.cell_aniso:
            if len(self.cell_aniso) != self.dim:
                raise ValueError(
                    f"cell_aniso has length {len(self.cell_aniso)} but "
                    f"dim={self.dim}")
            if any(c <= 0.0 for c in self.cell_aniso):
                raise ValueError(f"cell_aniso must be > 0: {self.cell_aniso}")
            for c in self.cell_aniso[1:]:
                if c < self.h * (1.0 - 1e-6):
                    raise ValueError(
                        "cell_aniso y/z cells must be >= h (their stencil "
                        f"halfwidth is 1): {self.cell_aniso} vs h={self.h}")
            if self.x_halfwidth > 3:
                raise ValueError(
                    f"cell_aniso[0]={self.cell_aniso[0]} needs an x-stencil "
                    f"halfwidth {self.x_halfwidth} > 3")
        if self.cont_form not in ("relax", "sum", "rate"):
            raise ValueError(f"unknown cont_form {self.cont_form!r}")
        if self.cont_form == "relax" and not (
                0.0 < self.cont_relax < 1.0):
            raise ValueError(
                f"cont_relax must be in (0, 1) for cont_form='relax' "
                f"(use cont_form='sum' for full re-anchoring), got "
                f"{self.cont_relax}")
        if self.cont_delta > 0.0 and self.cont_form != "rate":
            raise ValueError(
                "cont_delta requires cont_form='rate' (the sum/relax "
                "forms have no freely integrated density field to "
                "diffuse)")
        if self.cont_delta > 0.0 and self.viscosity == 0.0:
            raise ValueError(
                "cont_delta > 0 requires viscosity > 0 (the delta-SPH term "
                "rides the viscosity window channel and is statically "
                "disabled on inviscid configs)")

    @property
    def sound_speed(self) -> float:
        """EOS sound speed at rest density (linear and Tait alike)."""
        return math.sqrt(self.stiffness)

    @property
    def cell(self) -> float:
        """Edge length of an axis-0 grid cell (defaults to h)."""
        if self.cell_aniso:
            return self.cell_aniso[0]
        return self.cell_size if self.cell_size > 0.0 else self.h

    @property
    def cells_axis(self) -> Tuple[float, ...]:
        """Per-axis binning cell sizes."""
        if self.cell_aniso:
            return self.cell_aniso
        return (self.cell,) * self.dim

    @property
    def x_halfwidth(self) -> int:
        """x-stencil halfwidth (1 for cells >= h)."""
        cx = self.cell_aniso[0] if self.cell_aniso else self.cell
        return max(1, int(math.ceil(self.h / cx - 1e-6)))

    @property
    def grid_res(self) -> Tuple[int, ...]:
        """Cells per axis covering [bounds_min, bounds_max]."""
        return tuple(
            max(1, int(math.ceil((hi - lo) / c - 1e-9)))
            for (lo, hi), c in zip(
                zip(self.bounds_min, self.bounds_max), self.cells_axis)
        )

    @property
    def num_cells(self) -> int:
        n = 1
        for r in self.grid_res:
            n *= r
        return n

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)
