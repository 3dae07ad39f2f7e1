"""Where one full-rebuild step of the PyTorch port spends its time on the card.

    python3 scripts/torch_profile_step.py [--n 262144] [--dim 3] [--steps 10]

Runs the phases of ``gpufluidsimulator_torch.ops.sph.step_pallas`` one by one
with CUDA events between them (binning incl. the place kernel, occupancy
bounds, density, halo refresh, force, gather, integrate), averaged over
``--steps`` steps of the 3D dam break; then a ``torch.profiler`` trace of
whole steps, summed by kernel name, and the device busy share of that
window.  Prints JSON lines; needs a CUDA card.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import gpufluidsimulator_torch as ft
    from gpufluidsimulator_torch.ops import physics, route, sph
    from gpufluidsimulator_torch.ops import planes as pm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    params, state = ft.scenes.dam_break(n=args.n, dim=args.dim)
    sim = ft.FluidSim(params, state, method="pallas")
    sim.step(3)                                       # warm
    torch.cuda.synchronize()
    geom = pm.geometry(params)
    names = ["bin_sort_place", "occupancy_bounds", "density", "halo_x",
             "force", "stack_gather", "integrate"]
    totals = dict.fromkeys(names, 0.0)
    st = sim.state
    for _ in range(args.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        table = pm.build_planes(st.pos, st.vel, st.ids, params, geom)
        ev[1].record()
        occ_q, occ_s = pm.occupancy_bounds(table.planes, params, geom)
        ev[2].record()
        rho = sph.density_planes(table.planes[:3], occ_q, occ_s, params,
                                 geom)
        ev[3].record()
        rho = pm.halo_x(rho)
        ev[4].record()
        acc = sph.accel_planes(table.planes, rho, occ_q, occ_s, params, geom)
        ev[5].record()
        out = route.gather(torch.cat([acc, rho[None]]), table.slot)
        ev[6].record()
        out = torch.where(table.ok[:, None], out, 0.0)
        grav = torch.tensor(params.gravity, device=out.device)
        pos, vel = physics.integrate(table.pos_s, table.vel_s,
                                     out[:, :params.dim] + grav, params)
        ev[7].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
        st = st._replace(pos=pos, vel=vel, ids=table.ids_s)
    phases = {k: v / args.steps for k, v in totals.items()}
    print(json.dumps({"phase": "step_breakdown_ms", "card": card,
                      "particles": state.n, "steps": args.steps,
                      "ms": phases, "sum_ms": sum(phases.values())}),
          flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, fills): the host ops that
    # launched them report the same device time again
    rows = []
    device_total = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            device_total += dev_us
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    print(json.dumps({
        "phase": "profile", "card": card, "steps": args.steps,
        "wall_ms_per_step": wall_ms / args.steps,
        "device_ms_per_step": device_total / 1e3 / args.steps,
        "device_busy_share": device_total / 1e3 / wall_ms,
        "top": [{"name": k[:80], "calls": c,
                 "ms_per_step": us / 1e3 / args.steps}
                for us, k, c in rows[:15]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
