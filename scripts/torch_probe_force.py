"""Split the rank-plane force kernels' time on the card by what a tile does.

    python3 scripts/torch_probe_force.py [--scene 1m|5m] [--warm N]
        [--reps 20]

Evolves config 4 (``--scene 1m``, ``double_dam_break(n=1_000_000,
dim=3)``, 1,197,770 particles; 2,000 steps unless ``--warm``) or config 5
(``--scene 5m``, ``double_dam_break(n=4_000_000, dim=3)``, 4,825,800
particles on planes two x tiles wide; 3,175 steps) through
``FluidSim(method="auto")``: the states the benchmark's ``ddb3d_1m`` and
``ddb3d_5m`` cells start their calls from.  It builds the planes as the
incremental step does, and times ``accel_planes``
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
``no_stage - fill_only`` the queries' loads and epilogue.  ``fill`` gives,
for the fused steps, the sectors (8 lanes of a rank row) a launch's fill
visited and those it skipped, holding no query
(``sph.fill_sectors``; null on a tree without it).

From the same planes, ``tiles`` counts what the staging has to do (by
PyTorch, on the planes, independent of any kernel): the histogram of
queries per tile of 4 rows x 32 lanes (``queries_per_tile``, bins of 64;
``two_rounds``: tiles of more than 256 queries, which the row tile of
csrc/tile.cuh served in two rounds, staging every plane again), and the
valid slots staged per query by the row tile (each round stages the 6 x
34 cells of its planes z-1, z, z+1) and by the z-marching column of
csrc/ring.cuh (each plane a column needs staged once, ``--z`` planes a
column), with the ring planes past ``--cap`` slots
(``ring_planes_over_cap``) and the slots whose x the staging loads to
count (``x_loads_per_query``).  ``ring_overflows`` is the force kernels'
own count over the probe's launches (``sph.ring_overflows``; null on a
tree without it).  Prints one JSON line with the card's name and power
limit.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scripts.torch_timing import card_line, event_ms  # noqa: E402


def tile_stats(torch, p6, occ_s, geom, z_planes: int, cap: int) -> dict:
    """What the row tile and the z-marching column stage on these planes
    (the module docstring)."""
    import torch.nn.functional as tf
    from gpufluidsimulator_torch.ops import planes as pm
    rows, lanes, threads = 4, 32, 256
    cnt = (p6[0] < pm.SENTINEL * 0.5).sum(0).double()   # (pz, n_bx, py, 128)
    pz, n_bx, py, _ = cnt.shape
    inter = pm.interior_mask(geom, p6.device).double()
    box = rows * lanes

    def flat(t):
        return t.reshape(pz * n_bx, 1, py, -1)

    # queries of each tile: (pz, n_bx, py / 4, 4)
    nq = tf.avg_pool2d(flat(cnt * inter), (rows, lanes)) * box
    nq = nq.reshape(pz, n_bx, py // rows, 128 // lanes).round().long()
    # valid slots of the 6 x 34 cells around each tile, per plane
    reg = tf.avg_pool2d(tf.pad(flat(cnt), (1, 1, 1, 1)),
                        (rows + 2, lanes + 2), stride=(rows, lanes))
    reg = (reg * (rows + 2) * (lanes + 2)).round().long()
    reg = reg.reshape(pz, n_bx, py // rows, 128 // lanes)
    # cells whose x the count loads: kz ranks of the in-range cells
    in_range = torch.tensor([lanes + 1, lanes + 2, lanes + 2, lanes + 1],
                            dtype=torch.float64, device=p6.device)
    kz = torch.zeros((pz, n_bx, py // rows, 3), dtype=torch.float64,
                     device=p6.device)
    dim3 = geom.dim == 3
    zq = slice(1, geom.nz + 1) if dim3 else slice(0, 1)
    tr = torch.arange(py // rows, device=p6.device)
    blk = (tr * rows - pm.ROWS_PER_BLOCK) // pm.ROWS_PER_BLOCK
    ok = (blk >= 0) & (blk < geom.n_by)
    kz[zq][:, :, ok] = occ_s[:, :, blk[ok]].double().clamp(max=geom.k)
    has = nq > 0
    n_queries = int(nq.sum())
    rounds = (nq + threads - 1) // threads
    dzs = (-1, 0, 1) if dim3 else (0,)
    old_slots = old_loads = 0
    for i, dz in enumerate(dzs):
        sh = torch.roll(reg, -dz, dims=0)                 # plane z + dz
        k_dz = kz[..., i if dim3 else 1][..., None]
        old_slots += int((rounds * sh * has).sum())
        old_loads += int((rounds * has * (k_dz * in_range)
                          * (rows + 2)).sum())
    # each plane's own bound (its occ_s as the query plane z sees it)
    if dim3:
        bound = kz[..., 1].clone()
        bound[0] = kz[1, ..., 0]
        bound[pz - 1] = kz[pz - 2, ..., 2]
    else:
        bound = kz[..., 1]
    # the column: each plane within one of a query plane, once a column
    new_slots = new_loads = over = 0
    for c0 in range(0, pz, z_planes):
        c1 = min(c0 + z_planes, pz)
        lo, hi = max(c0 - 1, 0), min(c1 + 1, pz)
        near = torch.zeros((hi - lo,) + has.shape[1:], dtype=torch.bool,
                           device=p6.device)
        for dz in dzs:
            for z in range(c0, c1):
                if lo <= z + dz < hi:
                    near[z + dz - lo] |= has[z]
        new_slots += int((reg[lo:hi] * near).sum())
        new_loads += int((bound[lo:hi, ..., None] * in_range
                          * (rows + 2) * near).sum())
        over += int(((reg[lo:hi] > cap) & near).sum())
    hist = torch.bincount(((nq[has] - 1) // 64).clamp(max=15), minlength=16)
    return {"tiles_with_queries": int(has.sum()), "queries": n_queries,
            "queries_per_tile": {f"{64 * i + 1}-{64 * (i + 1)}": int(v)
                                 for i, v in enumerate(hist.tolist())},
            "two_rounds": int((nq > threads).sum()),
            "queries_in_two_round_tiles": int(nq[nq > threads].sum()),
            "staged_slots_per_query": {
                "row_tile": old_slots / max(n_queries, 1),
                "column": new_slots / max(n_queries, 1)},
            "x_loads_per_query": {
                "row_tile": old_loads / max(n_queries, 1),
                "column": new_loads / max(n_queries, 1)},
            "ring_planes_over_cap": over,
            "largest_ring_plane": int(reg.max()), "cap": cap,
            "z": z_planes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("1m", "5m"), default="1m")
    ap.add_argument("--warm", type=int, default=None,
                    help="steps before the planes (1m: 2000, 5m: 3175)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--z", type=int, default=2,
                    help="planes a column marches (csrc/force.cu FK_Z)")
    ap.add_argument("--cap", type=int, default=576,
                    help="slots a ring plane holds (csrc/force.cu FK_CAP)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import gpufluidsimulator_torch as ft
    from gpufluidsimulator_torch.ops import inc, sph
    from gpufluidsimulator_torch.ops import planes as pm

    card = card_line()
    n, warm = {"1m": (1_000_000, 2000), "5m": (4_000_000, 3175)}[args.scene]
    warm = warm if args.warm is None else args.warm
    params, state = ft.scenes.double_dam_break(n=n, dim=3)
    sim = ft.FluidSim(params, state, method="auto")
    sim.step(warm)
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
    count = getattr(sph, "ring_overflows", None)
    sectors = getattr(sph, "fill_sectors", None)
    before = count(p6.device) if count else None
    ms, fill = {}, {}
    for name, fn in kernels.items():
        ms[name], fill[name] = {}, {}
        for label, (q, s) in bounds.items():
            was = sectors(p6.device) if sectors else None
            ms[name][label] = event_ms(torch, lambda: fn(
                p6, rho, q, s, params, geom), args.reps)
            if sectors is None or name == "force":
                fill[name][label] = None
                continue
            skipped, seen = (b - a for a, b in zip(was, sectors(p6.device)))
            calls = args.reps + 2
            fill[name][label] = {
                "force_fill_skipped": skipped // calls,
                "sectors": seen // calls,
                "skipped_share": skipped / seen if seen else None}
    launches = 3 * (args.reps + 2)          # per kernel with true bounds
    tiles = tile_stats(torch, p6, occ_s, geom, args.z, args.cap)
    tiles["ring_overflows"] = (count(p6.device) - before) if count else None
    tiles["ring_overflows_per_launch"] = (
        tiles["ring_overflows"] / launches if count else None)
    print(json.dumps({"card": card, "scene": args.scene,
                      "particles": state.n, "steps_before": warm,
                      "reps": args.reps, "ms": ms, "fill": fill,
                      "tiles": tiles}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
