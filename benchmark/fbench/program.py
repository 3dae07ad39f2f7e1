"""The system under test, ``gpufluidsimulator_torch``, through its public
entry points: ``SimParams`` (with the binning cell ``planes.snap_cell``
picks, as the package's own scenes do), ``make_state``, ``solver.run``,
``FluidSim`` and ``ops.render``.  The only module of the harness that
imports the package."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

from gpufluidsimulator_torch import SimParams, make_state  # noqa: E402
from gpufluidsimulator_torch.models import solver  # noqa: E402
from gpufluidsimulator_torch.ops import render  # noqa: E402
from gpufluidsimulator_torch.ops.planes import snap_cell  # noqa: E402

__all__ = ["params", "state", "solver", "render"]


def params(const) -> SimParams:
    """The program's parameters for ``scene.Constants``."""
    return snap_cell(SimParams(
        dim=const.dim, h=const.h, rest_density=const.rest_density,
        stiffness=const.stiffness, viscosity=const.viscosity,
        particle_mass=const.mass, dt=const.dt, gravity=const.gravity,
        bounds_min=const.bounds_min, bounds_max=const.bounds_max,
        restitution=const.restitution, obstacles=const.obstacles,
        cell_capacity=const.cell_capacity))


def state(pos, device):
    return make_state(pos, device=device)
