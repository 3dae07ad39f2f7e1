"""Time FluidSim steps of the PyTorch port on the card, several times over.

    python3 scripts/torch_time_steps.py [--method pallas] [--scene dam_break]
        [--n 262144] [--dim 3] [--warm 5] [--steps 100] [--reps 5]

Runs ``--warm`` steps, then ``--reps`` runs of ``--steps`` steps, each timed
with CUDA events and the host clock (both end in a synchronise), and prints
one JSON line with the card, the package's path and the ms per step of each
run.  It imports the package next to the scripts folder it sits in, so a
copy placed in another checkout times that checkout: run the same copy in
two checkouts in turns (a, b, b, a) to compare them within one call.
Needs a CUDA card.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="pallas")
    ap.add_argument("--scene", default="dam_break",
                    choices=["dam_break", "double_dam_break"])
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import gpufluidsimulator_torch as ft

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    params, state = ft.scenes.SCENES[args.scene](n=args.n, dim=args.dim)
    sim = ft.FluidSim(params, state, method=args.method)
    sim.step(args.warm)
    torch.cuda.synchronize()
    event_ms, wall_ms = [], []
    for _ in range(args.reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        t0.record()
        sim.step(args.steps)
        t1.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - w0) * 1e3 / args.steps)
        event_ms.append(t0.elapsed_time(t1) / args.steps)
    print(json.dumps({
        "card": card, "package": os.path.dirname(ft.__file__),
        "method": args.method, "scene": args.scene, "particles": state.n,
        "steps": args.steps, "ms_per_step": event_ms,
        "wall_ms_per_step": wall_ms,
        "median_ms_per_step": statistics.median(event_ms)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
