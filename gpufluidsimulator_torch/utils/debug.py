"""Sanitizer tier: NaN / overflow checks and a determinism harness.

Counterpart: ``gpufluidsimulator_tpu/utils/debug.py``:

  * ``checked_step`` - a step that raises ``RuntimeError`` on non-finite
    positions or velocities and on a cell-capacity overflow (the
    reference's checkify wrapper; here one wait for the card a call);
  * ``assert_deterministic`` - the same state run twice must give
    bitwise-equal results (a race detector's analog).

The reference's ``interpret_mode`` (Pallas kernels through the
interpreter) has no counterpart: ``device="cpu"`` runs every kernel's
plain PyTorch version, which serves the same purpose.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.params import SimParams
from ..models.state import DeviceLike, State


def checked_step(params: SimParams, method: str = "pallas") -> Callable:
    """Returns step(state) -> state that raises ``RuntimeError`` on
    non-finite positions or velocities, or on capacity overflow, after the
    step.  It waits for the card once per call."""
    from ..models import solver
    fn = solver.METHODS[method]

    def step(state: State) -> State:
        out = fn(state, params)
        finite_pos, finite_vel, overflow = torch.stack([
            torch.isfinite(out.pos).all().to(torch.int64),
            torch.isfinite(out.vel).all().to(torch.int64),
            out.overflow.to(torch.int64)]).tolist()
        if not finite_pos:
            raise RuntimeError("non-finite positions after step")
        if not finite_vel:
            raise RuntimeError("non-finite velocities after step")
        if overflow != 0:
            raise RuntimeError(
                f"cell-capacity overflow: {overflow} particles dropped "
                f"(raise SimParams.cell_capacity)")
        return out

    return step


def assert_deterministic(params: SimParams, state: State, n_steps: int = 10,
                         method: str = "pallas",
                         device: DeviceLike = None) -> None:
    """Race-detector analog: identical inputs must give bitwise-equal
    states after ``n_steps`` of ``solver.run``."""
    from ..models.solver import run

    a = run(state, params, n_steps, method=method, device=device)
    b = run(state, params, n_steps, method=method, device=device)
    for name, x, y in zip(State._fields, a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"nondeterministic field {name!r} after "
                                 f"{n_steps} steps with method={method!r}")
