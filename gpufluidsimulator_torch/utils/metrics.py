"""Run metrics: physical invariants, per-interval rates, JSON / CSV dumps.

Counterpart: ``gpufluidsimulator_tpu/utils/metrics.py``.  ``invariants``
pulls positions, velocities and densities to the host once, in float64,
and computes on numpy exactly as the reference does.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List

import numpy as np
import torch

from ..models.params import SimParams
from ..models.state import State

log = logging.getLogger("gpufluidsimulator_torch")


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.to(device="cpu", dtype=torch.float64).numpy()


def invariants(state: State, params: SimParams) -> Dict[str, float]:
    """Physical invariants for observability and regression checks."""
    vel = _host64(state.vel)
    pos = _host64(state.pos)
    rho = _host64(state.rho)
    m = params.particle_mass
    ke = float(0.5 * m * np.sum(vel ** 2))
    # potential energy against the gravity vector
    g = np.asarray(params.gravity, np.float64)
    pe = float(-m * np.sum(pos @ g))
    mom = m * vel.sum(axis=0)
    return {
        "kinetic_energy": ke,
        "potential_energy": pe,
        "total_energy": ke + pe,
        "momentum": [float(x) for x in mom],
        "vmax": float(np.abs(vel).max()) if vel.size else 0.0,
        "rho_mean": float(rho.mean()) if rho.size else 0.0,
        "rho_max_rel_err": float(
            np.abs(rho / params.rest_density - 1.0).max()) if rho.size
        else 0.0,
        "overflow": int(state.overflow),
        "nan": bool(~np.isfinite(pos).all() or ~np.isfinite(vel).all()),
    }


class RunMetrics:
    """Collects per-interval step timings + invariants; dumps JSON/CSV.

    The host clock between two ``record`` calls covers the steps queued
    between them: ``invariants`` waits for the card."""

    def __init__(self, params: SimParams, n_particles: int,
                 method: str) -> None:
        self.meta = {
            "n_particles": n_particles,
            "method": method,
            "dim": params.dim,
            "h": params.h,
            "dt": params.dt,
        }
        self.samples: List[Dict] = []
        self._t0 = time.time()
        self._last_t = self._t0
        self._last_step = 0

    def record(self, step: int, state: State, params: SimParams) -> Dict:
        inv = invariants(state, params)
        now = time.time()
        dsteps = step - self._last_step
        wall = now - self._last_t
        sample = {
            "step": step,
            "wall_s": now - self._t0,
            "steps_per_sec": dsteps / wall if wall > 0 else 0.0,
            "ms_per_frame": 1e3 * wall / max(dsteps, 1),
            "particle_steps_per_sec":
                self.meta["n_particles"] * dsteps / wall if wall > 0 else 0.0,
            **inv,
        }
        self.samples.append(sample)
        self._last_t = now
        self._last_step = step
        log.info("step %d: %.1f steps/s, vmax=%.3f, overflow=%d",
                 step, sample["steps_per_sec"], sample["vmax"],
                 sample["overflow"])
        return sample

    def summary(self) -> Dict:
        tail = self.samples[1:] or self.samples    # drop the warm-up sample
        return {
            **self.meta,
            "total_wall_s": time.time() - self._t0,
            "steps": self._last_step,
            "mean_steps_per_sec": float(np.mean(
                [s["steps_per_sec"] for s in tail])) if tail else 0.0,
            "mean_particle_steps_per_sec": float(np.mean(
                [s["particle_steps_per_sec"] for s in tail])) if tail else 0.0,
            "samples": self.samples,
        }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)

    def dump_csv(self, path: str) -> None:
        if not self.samples:
            return
        keys = [k for k in self.samples[0] if k != "momentum"]
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for s in self.samples:
                f.write(",".join(str(s[k]) for k in keys) + "\n")
