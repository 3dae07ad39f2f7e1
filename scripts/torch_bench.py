"""Benchmark of the PyTorch port on one NVIDIA card; prints ONE JSON line.

    python3 scripts/torch_bench.py          # needs a CUDA card

The port's counterpart of ``bench.py``: particle-steps per second of the
incremental path on the 3D double dam break of 1,197,770 particles
(config 4), ``inc.step_planes`` over the plane stack, timed by
``utils.profiling.slope_time(k1=3, k2=15, reps=4)`` (CUDA events), at
two operating points:

  * ``early``   - after 100 warm ``pallas`` steps off the rest lattice;
  * ``evolved`` - on to 2,000 steps on ``pallas_inc`` (the churning flow).

Each point is timed on both tiers: ``pallas_inc`` (summation density, the
reference-faithful tier) and ``pallas_inc_cont`` (continuity density,
rho seeded by one density sweep and the age set to 1, off the re-sum
step).  ``value`` is evolved ``pallas_inc_cont``, ``faithful_value``
evolved ``pallas_inc``, as in ``bench.py``; the line also carries the
card's name and power limit.  ``bench.py``'s ``vs_baseline`` and
``fraction_of_*_ceiling`` fields are left out: their constants are TPU
figures.  Imports the package next to the scripts folder, never JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

WARM_EARLY = 100
WARM_EVOLVED = 2000


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_bench: CUDA is not available; this script needs a "
              "card", file=sys.stderr)
        return 1
    from gpufluidsimulator_torch import scenes
    from gpufluidsimulator_torch.models.solver import run
    from gpufluidsimulator_torch.ops import inc, sph
    from gpufluidsimulator_torch.ops import planes as pm
    from gpufluidsimulator_torch.utils.profiling import slope_time

    params, state = scenes.double_dam_break(n=1_000_000, dim=3)
    params = params.replace(diagnostics=False)
    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(state.n)

    def rate_at(state, continuity=False):
        s0 = inc.to_planes(state.pos, state.vel, state.ids, params, geom,
                           continuity=continuity)
        if continuity:
            p6 = pm.halo_x(s0.fields6)
            occ_q, occ_s = pm.occupancy_bounds(p6, params, geom)
            s0 = s0._replace(
                rhop=sph.density_planes(p6[:3], occ_q, occ_s, params, geom),
                age=1)
        t = slope_time(lambda s: inc.step_planes(s, params, geom, m_cap),
                       s0, k1=3, k2=15, reps=4)
        return state.n / t

    state = run(state, params, WARM_EARLY, method="pallas")
    early = rate_at(state)
    early_cont = rate_at(state, continuity=True)
    state = run(state, params, WARM_EVOLVED - WARM_EARLY,
                method="pallas_inc")
    evolved = rate_at(state)
    evolved_cont = rate_at(state, continuity=True)
    print(json.dumps({
        "metric": ("particle-steps/sec/chip @1M 3D double-dam-break "
                   "(pallas_inc_cont, evolved 2000 steps)"),
        "value": evolved_cont,
        "unit": "particle-steps/s",
        "faithful_value": evolved,
        "particles": state.n,
        "operating_points": {
            "early": {"warm_steps": WARM_EARLY, "value": early},
            "early_continuity": {"warm_steps": WARM_EARLY,
                                 "value": early_cont},
            "evolved": {"warm_steps": WARM_EVOLVED, "value": evolved},
            "evolved_continuity": {"warm_steps": WARM_EVOLVED,
                                   "value": evolved_cont},
        },
        "device": card(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
