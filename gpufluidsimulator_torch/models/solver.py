"""The step engine: State -> State, rollouts as a Python loop of steps.

Counterpart: ``gpufluidsimulator_tpu/models/solver.py``.  Method names match
the reference for API parity; ``"pallas"`` here means the rank-plane
kernel tier (hand-written CUDA kernels on the card).  Ported: ``naive`` and
``pallas``.  The reference's other methods raise ``NotImplementedError``
naming the ROADMAP item that ports them; ``auto`` resolves exactly as the
reference's does and raises where that lands on an unported method.

Every entry point takes ``device`` (default: the card; see
``state.resolve_device``) and moves the state there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import naive
from .params import SimParams
from .state import DeviceLike, State, resolve_device

# method -> ROADMAP.md queue-1 item that ports it
UNPORTED = {
    "gridded": "queue 1, item 9 (gridded tier)",
    "pallas_inc": "queue 1, item 5 (incremental pipeline, slice 2)",
    "pallas_inc_cont": "queue 1, item 5 (incremental pipeline, continuity "
                       "tier)",
    "native": "queue 1, item 6 (FluidSim method='native')",
}


def _step_naive(state: State, params: SimParams) -> State:
    pos, vel, rho, pres = naive.step_naive(state.pos, state.vel, params)
    return State(pos=pos, vel=vel, rho=rho, pres=pres, ids=state.ids,
                 overflow=torch.zeros((), dtype=torch.int32,
                                      device=pos.device))


def _step_pallas(state: State, params: SimParams) -> State:
    from ..ops import sph
    pos, vel, rho, pres, ids, overflow = sph.step_pallas(
        state.pos, state.vel, state.ids, params)
    return State(pos=pos, vel=vel, rho=rho, pres=pres, ids=ids,
                 overflow=overflow)


METHODS = {"naive": _step_naive, "pallas": _step_pallas}


def _ported(method: str) -> str:
    if method in UNPORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported to PyTorch yet: ROADMAP.md "
            f"{UNPORTED[method]}")
    return method


def resolve_method(method: str, n: int) -> str:
    """'auto' picks naive up to 8,192 particles and pallas above, as the
    reference does with every method registered."""
    if method != "auto":
        if method not in METHODS and method not in UNPORTED:
            raise ValueError(
                f"unknown method {method!r}; available: "
                f"{sorted(METHODS)} or 'auto'")
        return _ported(method)
    return "naive" if n <= 8192 else "pallas"


def _run_method(method: str, n_steps: int, n: int) -> str:
    """The reference's ``run``: 'auto' upgrades long rollouts at scale to
    the incremental pipeline."""
    auto = method == "auto"
    method = resolve_method(method, n)
    if auto and method == "pallas" and n_steps >= 16 and n > 32768:
        method = _ported("pallas_inc")
    return method


def step(state: State, params: SimParams, method: str = "auto",
         device: DeviceLike = None) -> State:
    """One SPH step. method: 'naive' | 'pallas' | 'auto'."""
    state = state.to(resolve_device(device))
    return METHODS[resolve_method(method, state.n)](state, params)


def run(state: State, params: SimParams, n_steps: int, method: str = "auto",
        device: DeviceLike = None) -> State:
    """Advance ``n_steps``.  Kernel launches queue on the current stream;
    nothing waits for the device between steps."""
    state = state.to(resolve_device(device))
    fn = METHODS[_run_method(method, n_steps, state.n)]
    for _ in range(n_steps):
        state = fn(state, params)
    return state


def rollout(state: State, params: SimParams, n_steps: int,
            method: str = "auto", record_every: int = 1,
            device: DeviceLike = None):
    """Like ``run`` but records positions: returns (final, traj) with traj
    (n_steps // record_every, N, dim).  The pallas path keeps particles
    slot-sorted, so row i of different frames may be different particles;
    re-align by ``State.ids`` for per-particle trajectories."""
    state = state.to(resolve_device(device))
    fn = METHODS[_run_method(method, n_steps, state.n)]
    frames = []
    for _ in range(n_steps // record_every):
        for _ in range(record_every):
            state = fn(state, params)
        frames.append(state.pos)
    traj = (torch.stack(frames) if frames else
            state.pos.new_zeros((0,) + tuple(state.pos.shape)))
    return state, traj


class FluidSim:
    """Object facade (init / step / get_positions) over the functional
    core.  The state moves to ``device`` (default: the card)."""

    def __init__(self, params: SimParams, state: State, method: str = "auto",
                 device: DeviceLike = None):
        self.params = params
        self.device = resolve_device(device)
        self.state = state.to(self.device)
        self.method = resolve_method(method, state.n)
        # the raw request: run() upgrades 'auto' rollouts at scale
        self._requested = method

    def step(self, n: int = 1) -> State:
        self.state = run(self.state, self.params, n, self._requested,
                         device=self.device)
        return self.state

    def get_positions(self) -> np.ndarray:
        """Positions in spawn order, although the device order is sorted."""
        return self._unsort(self.state.pos)

    def get_velocities(self) -> np.ndarray:
        return self._unsort(self.state.vel)

    def _unsort(self, arr: torch.Tensor) -> np.ndarray:
        arr = arr.cpu().numpy()
        ids = self.state.ids.cpu().numpy()
        out = np.empty_like(arr)
        out[ids] = arr
        return out
