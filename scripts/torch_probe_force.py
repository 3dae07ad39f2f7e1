"""Split the rank-plane force kernels' time on the card by what a tile does.

    python3 scripts/torch_probe_force.py [--warm 2000] [--reps 20]

Evolves config 4 (``double_dam_break(n=1_000_000, dim=3)``, 1,197,770
particles) through ``FluidSim(method="auto")`` for ``--warm`` steps, builds
its planes as the incremental step does, and times ``accel_planes``
(``force``), ``accel_step`` (``force_step``) and ``accel_step_cont``
(``force_step_cont``) with CUDA events, each with three sets of occupancy
bounds:

- ``full``: the true bounds, as the step passes them;
- ``no_stage``: ``occ_s`` all 0, so every tile finds its queries, loads
  them and writes their outputs, but stages no neighbour plane and
  evaluates no pair;
- ``fill_only``: ``occ_q`` all 0 too, so every tile only fills its slots.

The kernels are the committed ones; only their inputs change.  So
``full - no_stage`` is the staging and the pair loop together and
``no_stage - fill_only`` the queries' loads and epilogue.  Prints one JSON
line with the card's name and power limit.  Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def event_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call over ``reps`` calls after two warm-up
    calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import gpufluidsimulator_torch as ft
    from gpufluidsimulator_torch.ops import inc, sph
    from gpufluidsimulator_torch.ops import planes as pm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    params, state = ft.scenes.double_dam_break(n=1_000_000, dim=3)
    sim = ft.FluidSim(params, state, method="auto")
    sim.step(args.warm)
    state = sim.state
    geom = pm.geometry(params)
    p6 = pm.halo_x(inc.to_planes(state.pos, state.vel, state.ids, params,
                                 geom).fields6)
    occ_q, occ_s = pm.occupancy_bounds(p6, params, geom)
    rho = pm.halo_x(sph.density_planes(p6[:3], occ_q, occ_s, params, geom))
    bounds = {"full": (occ_q, occ_s),
              "no_stage": (occ_q, torch.zeros_like(occ_s)),
              "fill_only": (torch.zeros_like(occ_q),
                            torch.zeros_like(occ_s))}
    kernels = {"force": sph.accel_planes, "force_step": sph.accel_step,
               "force_step_cont": sph.accel_step_cont}
    ms = {name: {label: event_ms(torch, lambda: fn(p6, rho, q, s, params,
                                                   geom), args.reps)
                 for label, (q, s) in bounds.items()}
          for name, fn in kernels.items()}
    print(json.dumps({"card": card, "particles": state.n,
                      "steps_before": args.warm, "reps": args.reps,
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
