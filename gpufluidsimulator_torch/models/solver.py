"""The step engine: State -> State, rollouts as a Python loop of steps.

Counterpart: ``gpufluidsimulator_tpu/models/solver.py``.  Method names match
the reference for API parity; ``"pallas"`` here means the rank-plane
kernel tier (hand-written CUDA kernels on the card).  Ported: ``naive``,
``gridded`` (the uniform-grid cell table, ``ops/gridded.py``, plain
PyTorch as the reference's is plain XLA), ``pallas``, ``pallas_inc`` (the
incremental path, ``ops/inc.py``, which ``run``/``rollout`` keep
planes-resident for a whole call) and ``pallas_inc_cont`` (its
continuity-density tier); ``auto`` resolves exactly as the reference's
does.  ``native``, the C++ CPU engine (``oracle/native.py``), steps on the
host, so as in the reference it lives in ``FluidSim`` only: ``step``,
``run`` and ``rollout`` refuse it with ``ValueError``.

Every entry point takes ``device`` (default: the card; see
``state.resolve_device``) and moves the state there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import naive
from ..utils import profiling
from .params import SimParams
from .state import DeviceLike, State, resolve_device


def _step_naive(state: State, params: SimParams) -> State:
    with profiling.span("naive.step"):
        pos, vel, rho, pres = naive.step_naive(state.pos, state.vel, params)
    return State(pos=pos, vel=vel, rho=rho, pres=pres, ids=state.ids,
                 overflow=torch.zeros((), dtype=torch.int32,
                                      device=pos.device))


def _step_gridded(state: State, params: SimParams) -> State:
    from ..ops import gridded
    with profiling.span("gridded.step"):
        pos, vel, rho, pres, overflow = gridded.step_gridded(
            state.pos, state.vel, params)
    return State(pos=pos, vel=vel, rho=rho, pres=pres, ids=state.ids,
                 overflow=overflow)


def _step_pallas(state: State, params: SimParams) -> State:
    from ..ops import sph
    pos, vel, rho, pres, ids, overflow = sph.step_pallas(
        state.pos, state.vel, state.ids, params)
    return State(pos=pos, vel=vel, rho=rho, pres=pres, ids=ids,
                 overflow=overflow)


def _step_pallas_inc(state: State, params: SimParams) -> State:
    # single-step facade; multi-step calls dispatch to inc.run_inc in run()
    # so the planes stay resident across the whole loop
    from ..ops import inc
    return inc.run_inc(state, params, 1)


def _step_pallas_inc_cont(state: State, params: SimParams) -> State:
    # single-step facade, as the reference's (solver.py:69-82): each call
    # converts flat -> planes afresh, which resets the carried density's
    # age to 0, so every call pays the seeding density sweep and never
    # reaches the steady continuity step; run()/rollout() keep the planes
    # and the age resident for a whole call
    from ..ops import inc
    return inc.run_inc(state, params, 1, continuity=True)


METHODS = {"naive": _step_naive, "gridded": _step_gridded,
           "pallas": _step_pallas,
           "pallas_inc": _step_pallas_inc,
           "pallas_inc_cont": _step_pallas_inc_cont}
INC_METHODS = ("pallas_inc", "pallas_inc_cont")


def resolve_method(method: str, n: int) -> str:
    """'auto' picks naive up to 8,192 particles and pallas above, as the
    reference does with every method registered."""
    if method != "auto":
        if method not in METHODS:
            raise ValueError(
                f"unknown method {method!r}; available: "
                f"{sorted(METHODS)} or 'auto'")
        return method
    return "naive" if n <= 8192 else "pallas"


def _run_method(method: str, n_steps: int, n: int) -> str:
    """The reference's ``run``: 'auto' upgrades long rollouts at scale to
    the incremental pipeline."""
    auto = method == "auto"
    method = resolve_method(method, n)
    if auto and method == "pallas" and n_steps >= 16 and n > 32768:
        method = "pallas_inc"
    return method


def step(state: State, params: SimParams, method: str = "auto",
         device: DeviceLike = None) -> State:
    """One SPH step. method: 'naive' | 'gridded' | 'pallas' | 'pallas_inc' |
    'pallas_inc_cont' | 'auto'.  'pallas_inc_cont' re-seeds its carried
    density on every call (see ``_step_pallas_inc_cont``)."""
    state = state.to(resolve_device(device))
    return METHODS[resolve_method(method, state.n)](state, params)


def run(state: State, params: SimParams, n_steps: int, method: str = "auto",
        device: DeviceLike = None) -> State:
    """Advance ``n_steps``.  Kernel launches queue on the current stream;
    nothing waits for the device between steps.  One call of the profiling
    record (span ``solver.run``)."""
    with profiling.span("solver.run"):
        state = state.to(resolve_device(device))
        method = _run_method(method, n_steps, state.n)
        if method in INC_METHODS:
            from ..ops import inc
            return inc.run_inc(state, params, n_steps,
                               continuity=method == "pallas_inc_cont")
        fn = METHODS[method]
        for _ in range(n_steps):
            state = fn(state, params)
        return state


def rollout(state: State, params: SimParams, n_steps: int,
            method: str = "auto", record_every: int = 1,
            device: DeviceLike = None):
    """Like ``run`` but records positions: returns (final, traj) with traj
    (n_steps // record_every, N, dim).  The pallas paths keep particles
    slot-sorted, so row i of different frames may be different particles;
    re-align by ``State.ids`` for per-particle trajectories.
    'pallas_inc' and 'pallas_inc_cont' record frames out of the resident
    planes (``inc.rollout_inc``).  One call of the profiling record (span
    ``solver.rollout``)."""
    with profiling.span("solver.rollout"):
        state = state.to(resolve_device(device))
        method = _run_method(method, n_steps, state.n)
        if method in INC_METHODS:
            from ..ops import inc
            return inc.rollout_inc(state, params, n_steps, record_every,
                                   continuity=method == "pallas_inc_cont")
        fn = METHODS[method]
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
    core.  The state moves to ``device`` (default: the card).

    ``method="native"`` steps the C++ CPU engine (``oracle/native.py``,
    built at first use) on the host in float64; the state it returns is
    float32 on ``device``.  Raises ``RuntimeError`` when the engine cannot
    be built: nothing falls back."""

    def __init__(self, params: SimParams, state: State, method: str = "auto",
                 device: DeviceLike = None):
        self.params = params
        self.device = resolve_device(device)
        self.state = state.to(self.device)
        if method == "native":
            from ..oracle import native
            if not native.available():
                raise RuntimeError(
                    "native fluidcore engine unavailable: "
                    f"{native.unavailable_reason()}")
            self.method = "native"
        else:
            self.method = resolve_method(method, state.n)
        # the raw request: run() upgrades 'auto' rollouts at scale
        self._requested = method

    def step(self, n: int = 1) -> State:
        if self.method == "native":
            return self._step_native(n)
        self.state = run(self.state, self.params, n, self._requested,
                         device=self.device)
        return self.state

    def _step_native(self, n: int) -> State:
        from ..oracle import native
        pos, vel, rho, pres = native.run(
            self.state.pos.to("cpu", torch.float64).numpy(),
            self.state.vel.to("cpu", torch.float64).numpy(),
            self.params, n)

        def f32(a):
            return torch.from_numpy(a.astype(np.float32)).to(self.device)

        self.state = State(pos=f32(pos), vel=f32(vel), rho=f32(rho),
                           pres=f32(pres), ids=self.state.ids,
                           overflow=torch.zeros((), dtype=torch.int32,
                                                device=self.device))
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
