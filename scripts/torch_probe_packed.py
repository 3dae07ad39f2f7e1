"""Time the packed-pair sweep on the card and count the pairs it evaluates.

    python3 scripts/torch_probe_packed.py [--warm 2000] [--reps 20]

Builds config 4 (``double_dam_break(n=1_000_000, dim=3)``, 1,197,770
particles) and packs it as ``chip_smoke.py``'s packed phase does
(``packed_inputs``: the rank planes' density, floored, and its pressure):
on the initial state and after ``--warm`` steps through
``FluidSim(method="auto")`` (the evolved state).  On each it holds
``sweep_packed`` against ``sweep_packed_plain`` (relative 1e-5), times it
with CUDA events (``ms``) and by ``torch.profiler``'s device time
(``device_ms``), and counts per query the pairs of the kernel's query
groups' row segments (``evaluated``, ``mxu_sweep.group_segments``), of the
rows of those it tests (``tested``, ``group_candidates``), the pairs the
tiles' ranges cover and the exact 27-cell candidates.  The timing helpers
are ``scripts/torch_timing.py``'s.  Prints one JSON line with the card's
name and power limit and the kernel's registers, spills, static and
dynamic shared memory.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scripts.torch_timing import card_line, event_ms, kernel_us  # noqa: E402

# the prefix of the kernel's mangled name in the build's -Xptxas -v report
PACKED_KERNEL = "_Z19packed_sweep_kernel"


def packed_inputs(torch, state, params) -> tuple:
    """accel_mxu's input on a state, from the rank planes: the slot-sorted
    positions and velocities with the density sweep's rho (floored at 1e-3
    rest density, as accel_planes' EOS takes it) and its pressure."""
    from gpufluidsimulator_torch.ops import physics, route, sph
    from gpufluidsimulator_torch.ops import planes as pm

    geom = pm.geometry(params)
    table = pm.build_planes(state.pos, state.vel, state.ids, params, geom)
    if not bool(table.ok.all()):
        raise SystemExit("packed sweep: binning dropped particles")
    planes = table.planes
    occ_q, occ_s = pm.occupancy_bounds(planes, params, geom)
    rho_p = pm.halo_x(sph.density_planes(planes[:3], occ_q, occ_s, params,
                                         geom))
    acc_p = sph.accel_planes(planes, rho_p, occ_q, occ_s, params, geom)
    per = route.gather(torch.cat([acc_p, rho_p[None]]).contiguous(),
                       table.slot)
    rho = torch.clamp_min(per[:, 3], 1e-3 * params.rest_density)
    return (table.pos_s, table.vel_s, rho,
            physics.eos_pressure(rho, params))


def evaluated_pairs(torch, f, cids, desc, params) -> tuple:
    """(evaluated, tested): the pairs of the kernel's query groups' row
    segments (mxu_sweep.group_segments), which it walks, and of the rows of
    those within h of a group's bounding box (group_candidates), which it
    tests; each row against the GROUP queries of its group (pad queries
    included, as covered_pairs counts a tile's 128)."""
    from gpufluidsimulator_torch.ops import mxu_sweep as mx
    _, lo, hi = mx.group_segments(cids, desc, params)
    _, j = mx.group_candidates(f, cids, desc, params)
    return float((hi - lo).sum()) * mx.GROUP, float(j.numel()) * mx.GROUP


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import gpufluidsimulator_torch as ft
    from gpufluidsimulator_torch import _build
    from gpufluidsimulator_torch.ops import grid, mxu_sweep

    card = card_line()
    params, state = ft.scenes.double_dam_break(n=1_000_000, dim=3)
    params = params.replace(diagnostics=False)
    n = state.n
    out = {}
    for label in ("initial", "evolved"):
        if label == "evolved":
            sim = ft.FluidSim(params, state, method="auto")
            sim.step(args.warm)
            state = sim.state
            del sim
        f, cids, _ = mxu_sweep.pack(*packed_inputs(torch, state, params),
                                    params)
        desc = mxu_sweep.build_desc(cids, f.shape[0], params)

        def fn(f=f, cids=cids, desc=desc):
            return mxu_sweep.sweep_packed(f, cids, desc, params)
        got = fn().double()
        want = mxu_sweep.sweep_packed_plain(f, cids, desc, params).double()
        rel = float((got - want).abs().max()
                    / max(float(want.abs().max()), 1e-9))
        del got, want
        if rel > 1e-5:
            raise SystemExit(f"sweep_packed ({label}) rel err {rel} > 1e-5")
        cn = cids.cpu().numpy()
        hist = np.bincount(cn, minlength=grid.num_padded_cells(params))
        ideal = sum(int(hist[cn + o].sum())
                    for o in grid.neighbor_offsets(params))
        covered = mxu_sweep.table_stats(cn, f.shape[0],
                                        params)["covered_pairs"]
        ev, tested = evaluated_pairs(torch, f, cids, desc, params)
        out[label] = {
            "ms": event_ms(torch, fn, args.reps),
            "device_ms": sum(us for us, _ in kernel_us(
                torch, fn, args.reps).values()) / 1e3 / args.reps,
            "rel_err": rel,
            "pairs_per_query": {"evaluated": ev / n, "tested": tested / n,
                                "covered": covered / n, "ideal": ideal / n},
            "evaluated_vs_ideal": ev / ideal,
            "tested_vs_ideal": tested / ideal,
            "evaluated_vs_covered": ev / covered}
        del f, cids, desc
    report = _build.ptxas_report(_build.build_log["text"])
    kern = [dict(v, dynamic_smem=_build.library().fk_sweep_packed_smem())
            for k, v in report.items()
            if k.startswith(PACKED_KERNEL)]
    print(json.dumps({"card": card, "particles": n,
                      "steps_before": args.warm, "reps": args.reps,
                      "group": mxu_sweep.GROUP, "ptxas": kern, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
