"""Split the density sweep's time on the card by what a tile does.

    python3 scripts/torch_probe_density.py [--warm 2000] [--reps 20]

Evolves config 4 (``double_dam_break(n=1_000_000, dim=3)``, 1,197,770
particles) through ``FluidSim(method="auto")`` for ``--warm`` steps, builds
its planes as the incremental step does, and times ``density_planes``
(``density``) with CUDA events, with three sets of occupancy bounds:

- ``full``: the true bounds, as the step passes them;
- ``no_stage``: ``occ_s`` all 0, so every tile finds its queries and
  writes them, but stages no neighbour plane and evaluates no pair;
- ``fill_only``: ``occ_q`` all 0 too, so every tile only writes zeros.

The kernel is the committed one; only its inputs change.  So
``full - no_stage`` is the staging and the pair walk together and
``no_stage - fill_only`` the query layout.  The true bounds' result is
held against ``density_plain`` (relative 1e-5) first.  Also times config
3 (``dam_break(n=262144, dim=3)``, 260,850 particles, as binned) with the
true bounds.  Prints one JSON line with the card's name and power limit.
Needs a CUDA card; imports nothing of JAX.
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
    params3, state3 = ft.scenes.dam_break(n=262144, dim=3)
    geom3 = pm.geometry(params3)
    planes3 = pm.build_planes(state3.pos, state3.vel, state3.ids, params3,
                              geom3).planes
    params, state = ft.scenes.double_dam_break(n=1_000_000, dim=3)
    sim = ft.FluidSim(params, state, method="auto")
    sim.step(args.warm)
    geom = pm.geometry(params)
    p6 = pm.halo_x(inc.to_planes(sim.state.pos, sim.state.vel,
                                 sim.state.ids, params, geom).fields6)
    del sim

    ms, rel_err = {}, {}
    for label, planes, prm, g in (("config3", planes3, params3, geom3),
                                  ("config4", p6, params, geom)):
        pos = planes[:3].contiguous()
        occ_q, occ_s = pm.occupancy_bounds(planes, prm, g)
        got = sph.density_planes(pos, occ_q, occ_s, prm, g)
        want = sph.density_plain(pos, prm, g)
        rel = float((got.double() - want.double()).abs().max()
                    / want.double().abs().max())
        if not rel <= 1e-5:
            raise SystemExit(f"density ({label}): rel err {rel}")
        rel_err[label] = rel
        bounds = {"full": (occ_q, occ_s)}
        if label == "config4":
            bounds.update(no_stage=(occ_q, torch.zeros_like(occ_s)),
                          fill_only=(torch.zeros_like(occ_q),
                                     torch.zeros_like(occ_s)))
        ms[label] = {b: event_ms(torch, lambda: sph.density_planes(
            pos, q, s, prm, g), args.reps) for b, (q, s) in bounds.items()}
    print(json.dumps({"card": card, "particles": {"config3": state3.n,
                                                  "config4": state.n},
                      "steps_before": args.warm, "reps": args.reps,
                      "rel_err": rel_err, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
