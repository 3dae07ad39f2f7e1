"""Where the continuity tier loses particles: every drop of a benchmark
cell's whole traffic, by step and cause, and the fullest cell.

    python3 scripts/torch_cont_drops.py --config <benchmark config json> \
        --seeds 1,2 [--capacity K] [--warm-to 3175] [--steps 500] \
        [--calls 17] [--method pallas_inc_cont] [--locate 3] \
        [--out drops.jsonl] [--device cuda]

For each seed, the cell's protocol (``benchmark/fbench``: the scene from
the configuration and the seed, the port's parameters from it, with
``--capacity`` as the cell capacity K where given): 100 ``pallas`` steps,
then ``--method`` to step ``--warm-to`` (the set-up), then ``--calls``
calls of ``--steps`` steps, each from the set-up's state, as the
benchmark's closed loop makes them.  The set-up's incremental stage and
the first and last calls run step by step under a profiler session (CPU
only), each step its own call of the port's record (``utils/profiling``),
so its counters are per step: the drops by cause (``drops_cell_capacity``;
``drops_mover_capacity``, movers past the mover capacity), the fullest
cell after the step (``cell_fill_max``) and the sweeps' ring overflows.
The calls between them run through ``solver.run``, untimed by the record,
and each must return the first call's state bit for bit (the path is
deterministic).  For the first ``--locate`` drop steps of each stage the
stage is replayed to the step before, and the step's lost ids are found
with the cell each was moving into and how full that cell was.  Every
returned state is held to the benchmark's guarantees
(``fbench.check.Guard``).  One JSON line per stage and call, one per seed
and a summary (with the card's name and power limit) go to standard output
and ``--out``.  Imports the port and the benchmark's harness, never JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(1, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from fbench import check, program, scene  # noqa: E402
from gpufluidsimulator_torch.models import solver  # noqa: E402
from gpufluidsimulator_torch.ops import inc  # noqa: E402
from gpufluidsimulator_torch.ops import planes as pm  # noqa: E402
from gpufluidsimulator_torch.ops import sph  # noqa: E402
from gpufluidsimulator_torch.utils import profiling  # noqa: E402

CHUNK = 500          # recorded steps a profiler session holds


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "none"


def recorded_steps(s, params, geom, m_cap, steps):
    """``steps`` steps of ``s``, each its own recorded call -> (state,
    [per-step counters])."""
    rows = []
    profiling.take_calls()
    for c0 in range(0, steps, CHUNK):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(min(CHUNK, steps - c0)):
                s = inc.step_planes(s, params, geom, m_cap)
        rows += [e["counters"] for e in profiling.take_calls()
                 if e["steps"] == 1]
    return s, rows


def plain_steps(s, params, geom, m_cap, steps):
    for _ in range(steps):
        s = inc.step_planes(s, params, geom, m_cap)
    return s


def live_ids(s, geom) -> torch.Tensor:
    valid = (s.fields6[0] < pm.SENTINEL * 0.5) \
        & pm.interior_mask(geom, s.idp.device)[None]
    return s.idp[valid].long()


def locate(s, params, geom, m_cap) -> list:
    """The particles one step from planes ``s`` loses: per id its slot's
    cell and the cell it was moving into (``sph.accel_step(_cont)``'s
    position, the step's own arithmetic), and that cell's count after the
    step."""
    nxt = inc.step_planes(s, params, geom, m_cap)
    before, after = live_ids(s, geom), live_ids(nxt, geom)
    lost = before[~torch.isin(before, after)]
    planes6 = pm.halo_x(s.fields6)
    occ_q, occ_s = pm.occupancy_bounds(planes6, params, geom)
    if s.rhop is None or inc.resums(s, params):
        rho = sph.density_planes(planes6[:3], occ_q, occ_s, params, geom)
    else:
        rho = s.rhop
    rho_h = pm.halo_x(rho)
    if s.rhop is not None:
        new6, _, _ = sph.accel_step_cont(planes6, rho_h, occ_q, occ_s, params,
                                         geom, None, None)
    else:
        new6, _ = sph.accel_step(planes6, rho_h, occ_q, occ_s, params, geom,
                                 None, None)
    valid = (nxt.fields6[0] < pm.SENTINEL * 0.5) \
        & pm.interior_mask(geom, s.idp.device)[None]
    pos_after = torch.stack([nxt.fields6[d][valid] for d in range(3)], -1)
    counts = torch.bincount(pm.cell_linear_parts(pos_after, params, geom),
                            minlength=geom.cells)
    cell = torch.tensor(params.cell)
    lo = torch.tensor(params.bounds_min)
    out = [{"lost": int(lost.numel())}]
    for pid in lost[:20].tolist():
        slot = (s.idp == float(pid)) & (s.fields6[0] < pm.SENTINEL * 0.5)
        p_old = torch.stack([s.fields6[d][slot][0] for d in range(3)]).cpu()
        p_new = torch.stack([new6[d][slot][0] for d in range(3)])
        cid = int(pm.cell_linear_parts(p_new[None], params, geom)[0])
        out.append({
            "id": pid,
            "from_cell": ((p_old - lo) / cell).floor().long().tolist(),
            "to_cell": ((p_new.cpu() - lo) / cell).floor().long().tolist(),
            "to_cell_after": int(counts[cid])})
    return out


def drop_steps(rows) -> list:
    """[(step index, {cause: count})] of the steps that dropped."""
    out = []
    for i, c in enumerate(rows):
        d = {k: c.get(k, 0) for k in ("drops_cell_capacity",
                                      "drops_mover_capacity")}
        if any(d.values()):
            out.append((i, d))
    return out


def stage_line(name, rows, s, n_locate, replay, params, geom, m_cap):
    drops = drop_steps(rows)
    line = {"stage": name, "steps": len(rows),
            "dropped": {k: sum(d[k] for _, d in drops)
                        for k in ("drops_cell_capacity",
                                  "drops_mover_capacity")},
            "drop_steps": len(drops),
            "drops": [{"step": i, **d} for i, d in drops[:100]],
            "cell_fill_max": max((c.get("cell_fill_max", 0) for c in rows),
                                 default=None),
            "force_ring_overflows": sum(c.get("force_ring_overflows", 0)
                                        for c in rows),
            "density_ring_overflows": sum(c.get("density_ring_overflows", 0)
                                          for c in rows),
            "movers_per_step": sum(c.get("movers", 0) for c in rows)
            / max(len(rows), 1)}
    located = []
    for i, _ in drops[:n_locate]:
        located.append({"step": i, "lost": locate(
            plain_steps(replay(), params, geom, m_cap, i), params, geom,
            m_cap)})
    if located:
        line["located"] = located
    return line


def one_seed(cfg, seed, args, dev, emit):
    const = scene.constants(cfg)
    params = program.params(const)
    geom = pm.geometry(params)
    guard = check.Guard(const, dev)
    cont = args.method == "pallas_inc_cont"
    t0 = time.perf_counter()
    s0 = program.state(scene.positions(cfg, seed), dev)
    n = s0.n
    m_cap = inc.mover_capacity(n)
    s = solver.run(s0, params, 100, method="pallas", device=dev)
    emit({"seed": seed, "stage": "pallas", "steps": 100,
          "overflow": int(s.overflow)})
    warm_steps = args.warm_to - 100
    start = inc._convert_in(s, params, geom, cont)
    planes, rows = recorded_steps(start, params, geom, m_cap, warm_steps)
    evolved = inc._flat_state(*inc.to_flat(planes, params, geom, n),
                              planes.overflow, params, n)
    line = stage_line("set-up", rows, planes, args.locate, lambda: start,
                      params, geom, m_cap)
    line.update(seed=seed, overflow=int(evolved.overflow),
                mig_overflow=int(planes.mig_overflow),
                guard=guard.explain(evolved))
    emit(line)
    first = None
    fills, rates = [], []
    for k in range(args.calls):
        traced = k in (0, args.calls - 1)
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        t1 = time.perf_counter()
        if traced:
            cin = inc._convert_in(evolved, params, geom, cont)
            planes, rows = recorded_steps(cin, params, geom, m_cap,
                                          args.steps)
            out = inc._flat_state(*inc.to_flat(planes, params, geom, n),
                                  planes.overflow, params, n)
        else:
            out = solver.run(evolved, params, args.steps, method=args.method,
                             device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t1
        line = {"seed": seed, "stage": f"call {k}", "seconds": secs,
                "overflow": int(out.overflow),
                "ids_missing": int((out.ids < 0).sum()),
                "guard_failed": int(guard(out))}
        if first is None:
            first = out
        else:
            line["equal_to_call_0"] = all(
                torch.equal(a, b) for a, b in zip(
                    (out.pos, out.vel, out.ids), (first.pos, first.vel,
                                                  first.ids)))
        if traced:
            line["mig_overflow"] = int(planes.mig_overflow)
            line.update(stage_line(
                f"call {k}", rows, planes, args.locate if k == 0 else 0,
                lambda: inc._convert_in(evolved, params, geom, cont),
                params, geom, m_cap))
            fills.append(line["cell_fill_max"])
        else:
            rates.append(n * args.steps / secs)
        emit(line)
    emit({"seed": seed, "done": True, "particles": n, "k": geom.k,
          "slots": geom.k * geom.cells, "cell_fill_max": max(fills),
          "untraced_particle_steps_per_s": rates,
          "peak_bytes": torch.cuda.max_memory_allocated(dev)
          if dev.type == "cuda" else 0,
          "seconds": time.perf_counter() - t0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--capacity", type=int, default=0)
    ap.add_argument("--warm-to", type=int, default=3175)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--calls", type=int, default=17)
    ap.add_argument("--method", default="pallas_inc_cont")
    ap.add_argument("--locate", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_cont_drops.py: no CUDA card", file=sys.stderr)
        return 2
    cfg = json.loads(Path(args.config).read_text())
    if args.capacity:
        cfg["physics"]["cell_capacity"] = args.capacity
    sink = open(args.out, "a") if args.out else None
    head = {"config": args.config,
            "capacity": cfg["physics"]["cell_capacity"], "method": args.method,
            "warm_to": args.warm_to, "steps": args.steps,
            "calls": args.calls, "card": card() if dev.type == "cuda"
            else "none"}

    def emit(d):
        line = json.dumps({**head, **d}) if "done" in d else json.dumps(d)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    emit({"head": head})
    try:
        for seed in (int(x) for x in args.seeds.split(",") if x):
            one_seed(cfg, seed, args, dev, emit)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
