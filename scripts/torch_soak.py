"""Long soak of the incremental path at config 4, on the card.

    python3 scripts/torch_soak.py [N] [steps] [chunk] [method] [out]

Counterpart of ``scripts/soak.py``.  The 3D double dam break of ``N``
requested particles (default 1,000,000: 1,197,770 particles, config 4)
with ``diagnostics=False`` is converted to rank planes once
(``inc.to_planes``) and stepped ``steps`` times (default 5,000) by
``inc.step_planes`` in chunks of ``chunk`` steps (default 250) on
``method`` ``pallas_inc`` (default; summation density) or ``cont``
(``pallas_inc_cont``, the continuity tier).  The first chunk is the
warm-up and is not timed or recorded.  Each later chunk records its
ms/step (CUDA events around the chunk's steps), the live count (valid
interior slots), ``overflow`` and ``mig_overflow``, whether every live
field (and the carried rho) is finite, and the largest live speed
component ``vmax``.  The JSON (rows, a summary, the card's name and power
limit) goes to ``out`` (default ``docs/torch_soak.json`` or
``docs/torch_soak_cont.json``).  Exits 1 if a chunk lost a particle,
overflowed or went non-finite.  Imports the package next to the scripts
folder, never JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def chunk_check(torch, s, geom) -> dict:
    """Live count, finiteness and vmax of the live slots of state ``s``."""
    from gpufluidsimulator_torch.ops import planes as pm
    valid = (s.fields6[0] < pm.SENTINEL * 0.5) \
        & pm.interior_mask(geom, s.idp.device)[None]
    fields = [s.fields6] + ([s.rhop[None]] if s.rhop is not None else [])
    finite = all(bool(torch.isfinite(torch.where(valid[None], f, 0.0)).all())
                 for f in fields)
    speed = torch.where(valid, s.fields6[3:6].abs().amax(dim=0), 0.0)
    return dict(live=int(valid.sum()), finite=finite,
                vmax=float(speed.max()))


def soak(n: int = 1_000_000, steps: int = 5000, chunk: int = 250,
         continuity: bool = False, device="cuda") -> dict:
    """The soak; returns the JSON record (``rows``, ``summary``,
    ``config``).  On the CPU the chunks are timed by the host's clock."""
    import torch
    from gpufluidsimulator_torch import scenes
    from gpufluidsimulator_torch.ops import inc
    from gpufluidsimulator_torch.ops import planes as pm

    params, state = scenes.double_dam_break(n=n, dim=3, device=device)
    params = params.replace(diagnostics=False)
    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(state.n)
    cuda = state.pos.is_cuda
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom,
                      continuity=continuity)

    def roll(s):
        for _ in range(chunk):
            s = inc.step_planes(s, params, geom, m_cap)
        return s

    s = roll(s)                    # warm-up, outside the timing
    rows = []
    for done in range(2 * chunk, steps + 1, chunk):
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            s = roll(s)
            t1.record()
            t1.synchronize()
            ms = t0.elapsed_time(t1)
        else:
            w0 = time.perf_counter()
            s = roll(s)
            ms = 1e3 * (time.perf_counter() - w0)
        rows.append(dict(step=done, ms_per_step=ms / chunk,
                         overflow=int(s.overflow),
                         mig_overflow=int(s.mig_overflow),
                         **chunk_check(torch, s, geom)))
    return dict(
        config=dict(n=state.n, dim=3, scene="double_dam_break",
                    steps=steps, chunk=chunk,
                    method="pallas_inc_cont" if continuity else "pallas_inc",
                    grid=list(params.grid_res)),
        card=card() if cuda else "cpu",
        rows=rows,
        summary=dict(
            overflow_final=rows[-1]["overflow"],
            mig_overflow_final=rows[-1]["mig_overflow"],
            live_final=rows[-1]["live"],
            all_finite=all(r["finite"] for r in rows),
            ms_per_step_median=float(np.median(
                [r["ms_per_step"] for r in rows])),
            vmax_max=max(r["vmax"] for r in rows)))


def failures(out: dict) -> list:
    """Chunks that lost a particle, overflowed or went non-finite."""
    n = out["config"]["n"]
    return [f"step {r['step']}: live {r['live']} of {n}, overflow "
            f"{r['overflow']}, mig_overflow {r['mig_overflow']}, finite "
            f"{r['finite']}" for r in out["rows"]
            if (r["live"], r["overflow"], r["mig_overflow"], r["finite"])
            != (n, 0, 0, True)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_soak: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 5000
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else 250
    continuity = len(sys.argv) > 4 and sys.argv[4] == "cont"
    name = "torch_soak_cont.json" if continuity else "torch_soak.json"
    path = sys.argv[5] if len(sys.argv) > 5 else os.path.join(REPO, "docs",
                                                               name)
    out = soak(n, steps, chunk, continuity)
    for row in out["rows"]:
        print(json.dumps(row))
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}: {out['summary']}")
    bad = failures(out)
    for b in bad:
        print(f"FAILED: {b}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
