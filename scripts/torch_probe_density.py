"""Split the density sweep's time on the card by what a tile does.

    python3 scripts/torch_probe_density.py [--warm 2000] [--warm5 3175]
        [--reps 20] [--z 3] [--cap 704]

Evolves config 4 (``double_dam_break(n=1_000_000, dim=3)``, 1,197,770
particles) for ``--warm`` steps and config 5 (``BASELINE.json``
``configs[4]``, ``double_dam_break(n=4_000_000, dim=3)``, 4,825,800
particles on planes two x tiles wide) for ``--warm5`` steps, each through
``FluidSim(method="auto")``: the states the benchmark's ``ddb3d_1m`` and
``ddb3d_5m`` cells start their calls from.  On each it builds the planes
as the incremental step does and times ``density_planes`` (``density``)
with CUDA events, with three sets of occupancy bounds:

- ``full``: the true bounds, as the step passes them;
- ``no_stage``: ``occ_s`` all 0, so no plane is staged and no pair
  evaluated (the z-marching column takes its queries from the staged
  plane z, so it finds none either: the fill and the march of the
  planes whose ``occ_q`` is not 0; the row tile still laid out and wrote
  its queries);
- ``fill_only``: ``occ_q`` all 0 too, so every tile only writes zeros.

The kernel is the committed one; only its inputs change.  So
``full - no_stage`` is the staging, the query layout and the pair walk
together and ``no_stage - fill_only`` the march over the planes that
hold particles.  The true bounds' result is held against
``density_plain`` (relative 1e-5) first.  Also times config 3
(``dam_break(n=262144, dim=3)``, 260,850 particles, as binned) with the
true bounds.

From the same planes, ``tiles`` counts what the staging has to do
(``torch_probe_force.tile_stats``, by PyTorch on the planes, independent
of any kernel), for columns of ``--z`` planes and ring planes of ``--cap``
slots (csrc/density.cu's FD_Z and FD_CAP): the slots staged per query by
the row tile and by the column, the ring planes past the capacity
(``ring_planes_over_cap``) and the largest ring plane.
``ring_overflows_per_launch`` is the density sweep's own count
(``sph.ring_overflows(device, sph.DENSITY_RING_OVERFLOWS)``) over the
launches with true bounds; null on a tree without it.  Prints one JSON
line with the card's name and power limit.  Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scripts.torch_probe_force import tile_stats  # noqa: E402
from scripts.torch_timing import card_line, event_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=2000)
    ap.add_argument("--warm5", type=int, default=3175)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--z", type=int, default=3,
                    help="planes a column marches (csrc/density.cu FD_Z)")
    ap.add_argument("--cap", type=int, default=704,
                    help="slots a ring plane holds (csrc/density.cu FD_CAP)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import gpufluidsimulator_torch as ft
    from gpufluidsimulator_torch.ops import inc, sph
    from gpufluidsimulator_torch.ops import planes as pm

    card = card_line()
    name = getattr(sph, "DENSITY_RING_OVERFLOWS", None)

    def overflows(device):
        return sph.ring_overflows(device, name) if name else None

    def evolved(n, warm):
        params, state = ft.scenes.double_dam_break(n=n, dim=3)
        sim = ft.FluidSim(params, state, method="auto")
        sim.step(warm)
        geom = pm.geometry(params)
        p6 = pm.halo_x(inc.to_planes(sim.state.pos, sim.state.vel,
                                     sim.state.ids, params, geom).fields6)
        return p6, params, geom, sim.state.n

    params3, state3 = ft.scenes.dam_break(n=262144, dim=3)
    geom3 = pm.geometry(params3)
    scenes = {"config3": (pm.build_planes(state3.pos, state3.vel,
                                          state3.ids, params3,
                                          geom3).planes,
                          params3, geom3, state3.n),
              "config4": evolved(1_000_000, args.warm),
              "config5": evolved(4_000_000, args.warm5)}

    out = {"card": card, "steps_before": {"config4": args.warm,
                                          "config5": args.warm5},
           "reps": args.reps, "particles": {}, "rel_err": {}, "ms": {},
           "tiles": {}}
    for label, (planes, prm, g, n) in scenes.items():
        pos = planes[:3].contiguous()
        occ_q, occ_s = pm.occupancy_bounds(planes, prm, g)
        got = sph.density_planes(pos, occ_q, occ_s, prm, g)
        want = sph.density_plain(pos, prm, g)
        rel = float((got.double() - want.double()).abs().max()
                    / want.double().abs().max())
        del got, want
        if not rel <= 1e-5:
            raise SystemExit(f"density ({label}): rel err {rel}")
        out["particles"][label] = n
        out["rel_err"][label] = rel
        bounds = {"full": (occ_q, occ_s)}
        if label != "config3":
            bounds.update(no_stage=(occ_q, torch.zeros_like(occ_s)),
                          fill_only=(torch.zeros_like(occ_q),
                                     torch.zeros_like(occ_s)))
        before = overflows(pos.device)
        out["ms"][label] = {b: event_ms(torch, lambda: sph.density_planes(
            pos, q, s, prm, g), args.reps) for b, (q, s) in bounds.items()}
        if label == "config3":
            continue
        tiles = tile_stats(torch, planes, occ_s, g, args.z, args.cap)
        tiles["ring_overflows_per_launch"] = (
            (overflows(pos.device) - before) / (args.reps + 2)
            if name else None)
        out["tiles"][label] = tiles
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
