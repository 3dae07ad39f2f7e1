"""Split the consolidation's time on the card by what it does, and time the
occupancy bounds hot and cold.

    python3 scripts/torch_probe_consolidate.py [--warm 2000] [--reps 20]

Evolves config 4 (``double_dam_break(n=1_000_000, dim=3)``, 1,197,770
particles) through ``FluidSim(method="auto")`` for ``--warm`` steps and
builds one incremental step's inputs as ``inc.step_planes`` does (halo,
occupancy bounds, density, the fused force step, compact, the mover sort),
in both tiers: ``consolidate`` (7 planes) and ``consolidate_rho`` (8, from
the continuity step with the density sweep's rho as its carried rho).  It
then times the committed kernels with CUDA events on inputs that differ
only in what they hold:

- ``full``: the step's own inputs;
- ``no_movers``: the flag plane all 0 and no arrivals (``m = 0``): the kept
  copy and the fill;
- ``fill_only``: the x plane all SENTINEL and no arrivals, so every cell
  writes K empty ranks;
- ``store_floor``: ``torch.Tensor.fill_`` of the same 7 (8) output planes,
  the card's own rate for those stores.

``full`` is held against ``consolidate_plain`` (exact) first.  Then
``occ_rowmax`` and ``occupancy_bounds`` on the same planes, by
``torch.profiler``'s device time: ``hot`` over ``--reps`` calls in a row
(the x plane stays in L2), ``cold`` with L2 flushed before each call, in
three sessions (``cold_ms``: a ``bitwise_not_`` of a 128 MB buffer
before each call, its kernels left out of the sum); and by CUDA events
(``event_ms``: for these short calls, the host's launch path).  The
timing helpers are ``scripts/torch_timing.py``'s.  Prints one JSON line
with the card's name and power limit.  Needs a CUDA card; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scripts.torch_timing import (card_line, cold_ms, event_ms,  # noqa: E402
                                  kernel_us)


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

    card = card_line()
    params, state = ft.scenes.double_dam_break(n=1_000_000, dim=3)
    params = params.replace(diagnostics=False)
    sim = ft.FluidSim(params, state, method="auto")
    sim.step(args.warm)
    geom = pm.geometry(params)
    n = state.n
    m_cap = inc.mover_capacity(n)
    s = inc.to_planes(sim.state.pos, sim.state.vel, sim.state.ids, params,
                      geom)
    del sim
    p6 = pm.halo_x(s.fields6)
    occ_q, occ_s = pm.occupancy_bounds(p6, params, geom)
    rho = pm.halo_x(sph.density_planes(p6[:3], occ_q, occ_s, params, geom))
    new6, flagp = sph.accel_step(p6, rho, occ_q, occ_s, params, geom)
    movers, m, _ = inc.compact([*new6, s.idp], flagp, m_cap)
    arr = inc.arrival_planes(movers, m, params, geom)
    new6c, rhoc, flagc = sph.accel_step_cont(p6, rho, occ_q, occ_s, params,
                                             geom)
    movers8, m8, _ = inc.compact([*new6c, s.idp, rhoc], flagc, m_cap)
    arr8 = inc.arrival_planes(movers8, m8, params, geom)
    zero = torch.zeros((), dtype=torch.int32, device=m.device)
    no_arr = inc.arrival_planes(movers, zero, params, geom)
    no_arr8 = inc.arrival_planes(movers8, zero, params, geom)

    ms, movers_n = {}, {}
    for name, f6, flag, a, a0, rh in (
            ("consolidate", new6, flagp, arr, no_arr, None),
            ("consolidate_rho", new6c, flagc, arr8, no_arr8, rhoc)):
        got = inc.consolidate(f6, s.idp, flag, a, geom, rh)
        want = inc.consolidate_plain(f6, s.idp, flag, a, geom, rh)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise SystemExit(f"{name} differs from consolidate_plain")
        movers_n[name] = int(a.starts[-1])
        empty6 = f6.clone()
        empty6[0].fill_(pm.SENTINEL)
        outs = [torch.empty_like(t) for t in got[:-1]]
        fills = (pm.SENTINEL, 0.0, -1.0, 0.0)

        def store_floor(outs=outs):
            for o, v in zip(outs, fills):
                o.fill_(v)
        no_flag = torch.zeros_like(flag)
        cases = {
            "full": lambda f6=f6, flag=flag, a=a, rh=rh: inc.consolidate(
                f6, s.idp, flag, a, geom, rh),
            "no_movers": lambda f6=f6, a0=a0, rh=rh, nf=no_flag:
                inc.consolidate(f6, s.idp, nf, a0, geom, rh),
            "fill_only": lambda e6=empty6, a0=a0, rh=rh, nf=no_flag:
                inc.consolidate(e6, s.idp, nf, a0, geom, rh),
            "store_floor": store_floor,
        }
        ms[name] = {c: event_ms(torch, fn, args.reps)
                    for c, fn in cases.items()}
        del got, want, empty6, outs, no_flag, cases

    occ = {}
    for name, fn in (("occ_rowmax", lambda: pm.occ_rowmax(p6[0], geom)),
                     ("occupancy_bounds",
                      lambda: pm.occupancy_bounds(p6, params, geom))):
        hot = kernel_us(torch, fn, args.reps)
        occ[name] = {"event_ms": event_ms(torch, fn, args.reps),
                     "hot_device_ms": sum(us for us, _ in hot.values())
                     / 1e3 / args.reps,
                     "cold_device_ms": [cold_ms(torch, fn, args.reps)
                                        for _ in range(3)],
                     "launches_per_call": sum(c for _, c in hot.values())
                     / args.reps}
    print(json.dumps({"card": card, "particles": n,
                      "steps_before": args.warm, "reps": args.reps,
                      "movers": movers_n, "ms": ms, "occupancy": occ}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
