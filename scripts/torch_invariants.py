"""Physical invariants of a method's runs, at the reference's sizes.

    python3 scripts/torch_invariants.py [method ...]   # default: naive
                                                       # pallas_inc
                                                       # pallas_inc_cont

The checks of the reference's ``tests/test_invariants.py:13-77``, each a
function of (method, device) that runs its scene and returns its reading
beside its bar:

  * ``momentum``:    a free blob (no walls reached, no gravity), 30 steps:
                     |total momentum| / (n x largest |v|) below 1e-4;
  * ``energy``:      the 2D dam break of 400, 300 steps: kinetic energy
                     finite and below 2x the column's initial potential
                     energy (height 0.8);
  * ``finite``:      the jittered 2D dam break of 256, 400 steps: every
                     field of the state finite;
  * ``determinism``: the jittered 2D dam break of 256, 50 steps twice:
                     bitwise equal states;
  * ``bounds``:      the jittered 2D dam break of 256, 300 steps: every
                     position within 1e-6 of the box;
  * ``obstacles``:   the 2D double dam break of 2,000, 200 steps: no
                     particle deeper than 1e-4 inside an obstacle.

Prints one JSON line per check and exits 1 if one fails.  Imports the
package next to the scripts folder, never JAX.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from gpufluidsimulator_torch import run, scenes  # noqa: E402

METHODS = ("naive", "pallas_inc", "pallas_inc_cont")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def momentum(method, device) -> dict:
    steps = 30
    params, _ = scenes.dam_break(n=4000, dim=2, device=device)
    params = params.replace(gravity=(0.0, 0.0))
    # a small centred blob, so that the expanding fluid never meets a wall
    state = scenes.spawn_box(params, [0.42, 0.42], [0.58, 0.58],
                             jitter=0.3, seed=3, device=device)
    st = run(state, params, steps, method=method, device=device)
    pos, vel = _host(st.pos), _host(st.vel)
    off_walls = bool(pos.min() > 1e-3 and pos.max() < 1 - 1e-3)
    v_scale = max(np.abs(vel).max(), 1e-9)
    drift = float(np.abs(vel.sum(axis=0)).max() / (state.n * v_scale))
    return dict(value=drift, bar=1e-4, ok=off_walls and drift < 1e-4,
                off_walls=off_walls, particles=state.n, steps=steps)


def energy(method, device) -> dict:
    steps = 300
    params, state = scenes.dam_break(n=400, dim=2, device=device)
    st = run(state, params, steps, method=method, device=device)
    ke = 0.5 * params.particle_mass * float(np.sum(
        _host(st.vel).astype(np.float64) ** 2))
    h0 = 0.8                 # the column's height: the free-fall bound
    pe0 = params.particle_mass * 9.81 * h0 * state.n
    return dict(value=ke, bar=2.0 * pe0,
                ok=bool(np.isfinite(ke) and ke < 2.0 * pe0),
                particles=state.n, steps=steps)


def finite(method, device) -> dict:
    steps = 400
    params, state = scenes.dam_break(n=256, dim=2, jitter=0.2, seed=4,
                                     device=device)
    st = run(state, params, steps, method=method, device=device)
    ok = all(bool(np.all(np.isfinite(_host(leaf)))) for leaf in st)
    return dict(value=ok, bar=True, ok=ok, particles=state.n, steps=steps)


def determinism(method, device) -> dict:
    steps = 50
    params, state = scenes.dam_break(n=256, dim=2, jitter=0.2, seed=5,
                                     device=device)
    a = run(state, params, steps, method=method, device=device)
    b = run(state, params, steps, method=method, device=device)
    ok = all(np.array_equal(_host(x), _host(y)) for x, y in zip(a, b))
    return dict(value=ok, bar=True, ok=ok, particles=state.n, steps=steps)


def bounds(method, device) -> dict:
    steps = 300
    params, state = scenes.dam_break(n=256, dim=2, jitter=0.2, seed=6,
                                     device=device)
    st = run(state, params, steps, method=method, device=device)
    pos = _host(st.pos)
    out = max(float(np.max(np.asarray(params.bounds_min) - pos)),
              float(np.max(pos - np.asarray(params.bounds_max))), 0.0)
    return dict(value=out, bar=1e-6, ok=out <= 1e-6, particles=state.n,
                steps=steps)


def obstacles(method, device) -> dict:
    steps = 200
    params, state = scenes.double_dam_break(n=2000, dim=2, device=device)
    st = run(state, params, steps, method=method, device=device)
    pos = _host(st.pos)
    depth = 0.0
    for ob in params.obstacles:
        if ob[0] == "sphere":
            _, c, r = ob
            inside = r - np.linalg.norm(pos - np.asarray(c), axis=-1)
        else:
            _, c, half = ob
            q = np.abs(pos - np.asarray(c)) - np.asarray(half)
            inside = -np.max(q, axis=-1)
        depth = max(depth, float(np.max(inside)))
    return dict(value=depth, bar=1e-4, ok=depth <= 1e-4, particles=state.n,
                steps=steps)


CHECKS = {"momentum": momentum, "energy": energy, "finite": finite,
          "determinism": determinism, "bounds": bounds,
          "obstacles": obstacles}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_invariants: CUDA is not available; this script needs "
              "a card", file=sys.stderr)
        return 1
    bad = 0
    for method in sys.argv[1:] or METHODS:
        for name, fn in CHECKS.items():
            r = fn(method, "cuda")
            bad += not r["ok"]
            print(json.dumps({"check": name, "method": method, **r}),
                  flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
