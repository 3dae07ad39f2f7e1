"""Where one step of the PyTorch port spends its time on the card.

    python3 scripts/torch_profile_step.py [--n 262144] [--dim 3] [--steps 10]
    python3 scripts/torch_profile_step.py --method pallas_inc \
        --scene double_dam_break --n 1000000 --warm 100
    python3 scripts/torch_profile_step.py --method pallas_inc_cont \
        --scene double_dam_break --n 1000000 --warm 100
    python3 scripts/torch_profile_step.py --method gridded --dim 2 \
        --n 65536 --warm 1
    python3 scripts/torch_profile_step.py --method pallas_inc \
        --scene double_dam_break --n 4000000 --warm 1 --slabs 8

``--method pallas`` (default) runs the phases of the full-rebuild
``ops.sph.step_pallas`` one by one with CUDA events between them (binning
incl. the place kernel, occupancy bounds, density, halo refresh, force,
gather, integrate); ``--method pallas_inc`` those of the incremental
``ops.inc.step_planes`` (occupancy bounds, density, force_step, compact,
mover sort + start table, consolidate), after ``--warm`` full-rebuild
steps as bench.py warms its early operating point; ``--method
pallas_inc_cont`` those of its continuity tier (the density phase then
runs only at a re-sum age: the carried rho is seeded by one sweep and the
age starts at 1, as bench.py times it); ``--method gridded`` those of
``ops.gridded.step_gridded`` (cell table, density, EOS, force, gather +
integrate) after ``--warm`` gridded steps.  With ``--slabs`` N > 1 an
incremental method runs sharded over N x slabs of the card in lock step
(``parallel.sharded``, as ``run_sharded_inc`` steps them) and only the
whole steps are timed.  All are averaged over ``--steps`` steps.  Device
time by kernel and the device's busy share come from the benchmark's
traced run (``benchmark/run.py --trace 1``), host time by phase from the
CLI's ``--profile-dir`` record.  Prints JSON lines; needs a CUDA card.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--scene", default="dam_break",
                    choices=["dam_break", "double_dam_break"])
    ap.add_argument("--method", default="pallas",
                    choices=["pallas", "pallas_inc", "pallas_inc_cont",
                             "gridded"])
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--slabs", type=int, default=1)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import gpufluidsimulator_torch as ft
    from gpufluidsimulator_torch.ops import planes as pm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    params, state = ft.scenes.SCENES[args.scene](n=args.n, dim=args.dim)
    inc_path = args.method.startswith("pallas_inc")
    if inc_path:
        params = params.replace(diagnostics=False)     # as bench.py:59
    gridded = args.method == "gridded"
    sim = ft.FluidSim(params, state,
                      method="gridded" if gridded else "pallas")
    sim.step(args.warm)
    torch.cuda.synchronize()
    if args.slabs > 1:
        if not inc_path:
            print("--slabs takes pallas_inc or pallas_inc_cont",
                  file=sys.stderr)
            return 1
        step = _sharded_steps(torch, params, sim.state, args.slabs,
                              args.method == "pallas_inc_cont")
        step(2)                                       # first touch
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        step(args.steps)
        t1.record()
        torch.cuda.synchronize()
        print(json.dumps({"phase": "sharded_steps", "card": card,
                          "method": args.method, "scene": args.scene,
                          "particles": state.n, "slabs": args.slabs,
                          "steps": args.steps,
                          "ms_per_step": t0.elapsed_time(t1) / args.steps}),
              flush=True)
        return 0
    if gridded:
        phases = _gridded_phases(torch, params, sim.state, args.steps)
    elif inc_path:
        phases = _inc_phases(torch, params, pm.geometry(params), sim.state,
                             args.steps, args.method == "pallas_inc_cont")
    else:
        phases = _full_phases(torch, params, pm.geometry(params),
                              sim.state, args.steps)
    print(json.dumps({"phase": "step_breakdown_ms", "card": card,
                      "method": args.method, "scene": args.scene,
                      "particles": state.n, "steps": args.steps,
                      "ms": phases, "sum_ms": sum(phases.values())}),
          flush=True)
    return 0


def _inc_phases(torch, params, geom, state, steps, continuity):
    """CUDA-event phases of ``inc.step_planes`` (its continuity tier with
    ``continuity``)."""
    from gpufluidsimulator_torch.ops import inc, sph
    from gpufluidsimulator_torch.ops import planes as pm

    force = "force_step_cont" if continuity else "force_step"
    names = ["occupancy_bounds", "density", force, "compact",
             "mover_sort_starts", "consolidate_overflow"]
    totals = dict.fromkeys(names, 0.0)
    m_cap = inc.mover_capacity(state.n)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom,
                      continuity=continuity)
    if continuity:
        # bench.py:76-84: rho seeded by one density sweep, age from 1
        p6 = pm.halo_x(s.fields6)
        occ_q, occ_s = pm.occupancy_bounds(p6, params, geom)
        s = s._replace(rhop=sph.density_planes(p6[:3], occ_q, occ_s, params,
                                               geom), age=1)
    movers_total = 0
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        p6 = pm.halo_x(s.fields6)
        occ_q, occ_s = pm.occupancy_bounds(p6, params, geom)
        ev[1].record()
        if continuity and not inc.resums(s, params):
            rho = pm.halo_x(s.rhop)
        else:
            rho = pm.halo_x(sph.density_planes(p6[:3], occ_q, occ_s,
                                               params, geom))
        ev[2].record()
        if continuity:
            new6, rho_new, flagp = sph.accel_step_cont(p6, rho, occ_q,
                                                       occ_s, params, geom)
            chans = [*new6, s.idp, rho_new]
        else:
            new6, flagp = sph.accel_step(p6, rho, occ_q, occ_s, params,
                                         geom)
            rho_new, chans = None, [*new6, s.idp]
        ev[3].record()
        movers, m, total = inc.compact(chans, flagp, m_cap)
        ev[4].record()
        arr = inc.arrival_planes(movers, m, params, geom)
        ev[5].record()
        *cons, dropped = inc.consolidate(new6, s.idp, flagp, arr, geom,
                                         rho_new)
        s = inc.IncState(fields6=cons[0], idp=cons[1],
                         overflow=s.overflow + (total - m) + dropped,
                         mig_overflow=s.mig_overflow,
                         rhop=cons[2] if continuity else None,
                         age=s.age + 1 if continuity else None)
        ev[6].record()
        torch.cuda.synchronize()
        movers_total += int(m)
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
    phases = {k: v / steps for k, v in totals.items()}
    phases_movers = movers_total / steps
    print(json.dumps({"phase": "movers_per_step", "movers": phases_movers,
                      "overflow": int(s.overflow)}), flush=True)
    return phases


def _sharded_steps(torch, params, state, slabs, continuity):
    """A run(n) of n lock-step steps of ``slabs`` x slabs on the card."""
    from gpufluidsimulator_torch.ops import inc
    from gpufluidsimulator_torch.ops import planes as pm
    from gpufluidsimulator_torch.parallel import mesh as meshmod
    from gpufluidsimulator_torch.parallel import sharded

    mesh = meshmod.make_mesh(devices=[torch.device("cuda", 0)] * slabs)
    sstate, _ = sharded.distribute(params, state, mesh)
    params_loc, nxl = sharded.local_params(params, slabs)
    geom = pm.geometry(params_loc)
    n_cap = sstate.pos[0].shape[0]
    ex = sharded.make_exchange(mesh, nxl)
    x0 = {d: sharded.slab_origin(params, nxl, d) for d in range(slabs)}
    box = {"s": {d: inc.to_planes(sstate.pos[d], sstate.vel[d],
                                  sstate.ids[d], params_loc, geom,
                                  x_origin=x0[d], active=sstate.ids[d] >= 0,
                                  continuity=continuity)
                 for d in range(slabs)}}

    def run(n):
        for _ in range(n):
            box["s"] = meshmod.lockstep({d: inc.step_phases(
                s, params_loc, geom, inc.mover_capacity(n_cap),
                x_origin=x0[d], exchange=ex, wall_params=params,
                mig_cap=max(128, n_cap // 64))
                for d, s in box["s"].items()})
    return run


def _gridded_phases(torch, params, st, steps):
    from gpufluidsimulator_torch.ops import grid, gridded, physics

    names = ["cell_table", "density", "eos", "force", "gather_integrate"]
    totals = dict.fromkeys(names, 0.0)
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        table = grid.build_cell_table(st.pos, st.vel, params)
        ev[1].record()
        rho = gridded.slot_density(table, params)
        ev[2].record()
        pres = physics.eos_pressure(rho, params)
        ev[3].record()
        acc = gridded.accel_dense(table, rho, pres, params)
        ev[4].record()
        pos, vel, *_ = gridded.finish(st.pos, st.vel, table, rho, pres, acc,
                                      params)
        ev[5].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
        st = st._replace(pos=pos, vel=vel)
    return {k: v / steps for k, v in totals.items()}


def _full_phases(torch, params, geom, st, steps):
    from gpufluidsimulator_torch.ops import physics, route, sph
    from gpufluidsimulator_torch.ops import planes as pm

    names = ["bin_sort_place", "occupancy_bounds", "density", "halo_x",
             "force", "stack_gather", "integrate"]
    totals = dict.fromkeys(names, 0.0)
    for _ in range(steps):
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
        grav = physics.constant(params.gravity, out)
        pos, vel = physics.integrate(table.pos_s, table.vel_s,
                                     out[:, :params.dim] + grav, params)
        ev[7].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
        st = st._replace(pos=pos, vel=vel, ids=table.ids_s)
    return {k: v / steps for k, v in totals.items()}


if __name__ == "__main__":
    sys.exit(main())
