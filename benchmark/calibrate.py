"""The readings a cell's limits are set from (not run by the benchmark).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out calib.jsonl]

For each seed, in one process: the cell's set-up, the loop's ``one`` (one
timed call, or one episode of frames), and the check exactly as ``run.py``
makes it: the program's readings, whose largest over a dozen seeds or more is each
number's lower reading.  For each control seed also the readings of

  control    the reference with its pair arithmetic in bfloat16 (the
             precision below the configuration's float32; sums and state
             in float32) put in the program's place, for the states and,
             in a frame, for the framebuffer;
  unchanged  the returned state left as the input (a step that returns
             its state unchanged);
  half       every second particle by id left as the input, the rest
             stepped (half of the particles left out);
  altered    the positions and velocities of a run of 0.5% of the ids
             exchanged with another run's in the reference's answer, as
             a mis-addressed write would (and one pixel of a frame's
             image moved by 64 levels): an answer altered where it is
             produced;

each against the float64 reference, as the program is.  The smallest
control reading is each number's upper reading.  Prints one JSON line per
seed and reading kind, and a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

HARNESS = Path(__file__).resolve().parent
ROOT = HARNESS.parent


def _faults(c, start, ref, seed):
    import torch
    n = start.pos.shape[0]
    by = torch.argsort(start.ids.long())          # row of each id
    m = max(1, n // 200)
    rng = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    a = int(torch.randint(0, n // 2 - m, (1,), generator=rng))
    b = a + n // 2
    ra, rb = by[a:a + m], by[b:b + m]
    alt_pos, alt_vel = ref.pos.clone(), ref.vel.clone()
    alt_pos[ra], alt_pos[rb] = ref.pos[rb], ref.pos[ra]
    alt_vel[ra], alt_vel[rb] = ref.vel[rb], ref.vel[ra]
    half = (start.ids % 2 == 0)[:, None]
    rho_in = start.rho.to(ref.rho.dtype)
    return {
        "unchanged": SimpleNamespace(ids=start.ids, pos=start.pos,
                                     vel=start.vel, rho=start.rho),
        "half": SimpleNamespace(
            ids=start.ids,
            pos=torch.where(half, start.pos.to(ref.pos.dtype), ref.pos),
            vel=torch.where(half, start.vel.to(ref.vel.dtype), ref.vel),
            rho=torch.where(half[:, 0], rho_in, ref.rho)),
        "altered": SimpleNamespace(ids=start.ids, pos=alt_pos, vel=alt_vel,
                                   rho=ref.rho),
    }


def readings(c, rec, control: bool, seed: int):
    """{kind: [numbers per comparison]}."""
    import torch
    from fbench import bench
    out = {"program": []}
    if control:
        out.update(control=[], unchanged=[], half=[], altered=[])
    extra = getattr(c.loop, "extra_readings", None)
    for cmp in bench.comparisons(c, rec):
        out["program"].append(cmp.numbers)
        if not control:
            continue
        got = {"control": c.gaps(c.reference(cmp.start, torch.bfloat16),
                                 cmp.ref)}
        for kind, fault in _faults(c, cmp.start, cmp.ref, seed).items():
            got[kind] = c.gaps(fault, cmp.ref)
        if extra is not None and cmp.extra is not None:
            for kind, nums in extra(c, cmp, seed).items():
                got[kind].update(nums)
        for kind, v in got.items():
            out[kind].append(v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--bench", default=str(ROOT / "BENCHMARK.json"))
    ap.add_argument("--harness", default=str(HARNESS))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HARNESS))
    import torch
    from fbench import bench, check, spec
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("calibrate.py: CUDA is not available", file=sys.stderr)
        return 2
    cell = spec.load_cell(Path(args.bench), args.workload,
                          Path(args.harness))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    lower, upper = {}, {}
    try:
        for seed in seeds + sorted(controls - set(seeds)):
            c = bench.Cell(cell, seed, args.device)
            c.setup()
            rec = SimpleNamespace()
            c.loop.one(c, rec)
            got = readings(c, rec, seed in controls, seed)
            for kind, rows in got.items():
                w = check.worst(rows)
                agg = lower if kind == "program" and seed in seeds else None
                if kind == "control":
                    for k, v in w.items():
                        upper[k] = min(upper.get(k, v), v)
                if agg is not None:
                    for k, v in w.items():
                        agg[k] = max(agg.get(k, v), v)
                line = json.dumps({"workload": cell.name, "seed": seed,
                                   "kind": kind, "worst": w, "each": rows})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
            del c
            if args.device.startswith("cuda"):
                torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    print(json.dumps({"workload": cell.name, "summary": True,
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
