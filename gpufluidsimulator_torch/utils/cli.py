"""Command-line interface: ``python -m gpufluidsimulator_torch``.

Counterpart: ``gpufluidsimulator_tpu/utils/cli.py``, with the same
subcommands, flags and output lines:

  run     simulate; optional frames, movie export, checkpoints, metrics
  bench   headless benchmark of one configuration -> one JSON line
  render  one frame from a checkpoint -> PNG

Every subcommand takes ``--device`` (default ``cuda``): only an explicit
``--device cpu`` runs on the host.  The kernels build on their own at
first use, so there is no compile cache to enable.  ``run --sharded``
steps a ``parallel.sharded.ShardedSim`` over one x slab per visible card
(``--device cpu``: one slab on the host); ``bench`` ignores ``--sharded``
and times one device, as the reference's does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time

import numpy as np


def _parse_box(spec: str, dim: int):
    """'x0,y0[,z0]:x1,y1[,z1][:vx,vy[,vz]]' -> (min, max[, velocity])."""
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise argparse.ArgumentTypeError(
            f"--box wants min:max[:vel], got {spec!r}")
    vecs = []
    for part in parts:
        v = tuple(float(x) for x in part.split(","))
        if len(v) != dim:
            raise argparse.ArgumentTypeError(
                f"--box component {part!r} has {len(v)} coords, dim={dim}")
        vecs.append(v)
    return tuple(vecs)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; "
                        "'cpu' runs every kernel's plain PyTorch version)")


def _add_scene_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="dam_break",
                   choices=["dam_break", "double_dam_break", "spawn_boxes"])
    p.add_argument("--box", action="append", default=None, metavar="SPEC",
                   help="spawn box for --scene spawn_boxes, repeatable: "
                        "'x0,y0[,z0]:x1,y1[,z1][:vx,vy[,vz]]' (domain "
                        "units; optional per-box velocity)")
    p.add_argument("-n", "--particles", type=int, default=65536)
    p.add_argument("--dim", type=int, default=2, choices=[2, 3])
    p.add_argument("--jitter", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    # parameter overrides (reference SimParams surface)
    p.add_argument("--h", type=float, default=None)
    p.add_argument("--rest-density", type=float, default=None)
    p.add_argument("--stiffness", type=float, default=None)
    p.add_argument("--viscosity", type=float, default=None)
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--gravity", type=float, default=None,
                   help="vertical gravity (m/s^2, negative = down)")
    p.add_argument("--cell-capacity", type=int, default=None)
    p.add_argument("--method", default="auto",
                   choices=["auto", "naive", "gridded", "pallas",
                            "pallas_inc", "pallas_inc_cont", "native"],
                   help="'pallas_inc' = incremental binning (planes-resident"
                        " state, movers-only re-sort); 'pallas_inc_cont' = "
                        "+ continuity-equation density (no per-step density "
                        "sweep); 'native' = multithreaded C++ CPU engine")
    p.add_argument("--sharded", action="store_true",
                   help="spatial sharding: one x slab per visible card "
                        "(run only; bench ignores it)")
    _add_device_arg(p)


def _build_scene(args):
    from ..models import scenes
    kw = {}
    if getattr(args, "box", None):
        if args.scene != "spawn_boxes":
            raise SystemExit("--box requires --scene spawn_boxes")
        kw["boxes"] = [_parse_box(s, args.dim) for s in args.box]
    params, state = scenes.SCENES[args.scene](
        n=args.particles, dim=args.dim, jitter=args.jitter, seed=args.seed,
        device=args.device, **kw)
    over = {}
    for name, attr in [("h", "h"), ("rest_density", "rest_density"),
                       ("stiffness", "stiffness"),
                       ("viscosity", "viscosity"), ("dt", "dt"),
                       ("cell_capacity", "cell_capacity")]:
        v = getattr(args, name)
        if v is not None:
            over[attr] = v
    if args.gravity is not None:
        g = [0.0] * args.dim
        g[1] = args.gravity
        over["gravity"] = tuple(g)
    if over:
        params = params.replace(**over)
    return params, state


def _traced(args, body, stream) -> int:
    """Run ``body(args)``, inside a profiler trace with --profile-dir."""
    from . import profiling

    ctx = (profiling.trace(args.profile_dir) if args.profile_dir
           else contextlib.nullcontext())
    with ctx:
        rc = body(args)
    if args.profile_dir:
        print(f"profiler trace -> {args.profile_dir} "
              f"(TensorBoard / Perfetto)", file=stream)
    return rc


def cmd_run(args) -> int:
    return _traced(args, _run_body, sys.stdout)


def _run_body(args) -> int:
    from .. import FluidSim
    from ..ops import render
    from . import checkpoint, metrics

    if args.sharded and args.movie:
        # the movie records frames through solver.rollout, which has no
        # sharded counterpart
        raise SystemExit(
            "--sharded and --movie are mutually exclusive: in-scan frame "
            "recording is not implemented on the sharded path (use "
            "--frames-dir for per-interval PNGs, or drop --sharded)")
    if args.resume:
        state, params, start = checkpoint.load(args.resume,
                                               device=args.device)
        print(f"resumed from {args.resume} at step {start}")
    else:
        params, state = _build_scene(args)
        start = 0
    if args.movie:
        from ..models import solver
        final, traj = solver.rollout(state, params, args.steps,
                                     method=args.method,
                                     record_every=args.movie_every,
                                     device=args.device)
        frames = traj.cpu().numpy()            # one copy to the host
        np.savez_compressed(args.movie, frames=frames,
                            every=np.asarray(args.movie_every))
        print(f"movie: {frames.shape[0]} frames -> {args.movie} "
              f"(every {args.movie_every} steps)")
        final_inv = metrics.invariants(final, params)
        print(json.dumps({k: v for k, v in final_inv.items()
                          if k != "momentum"}))
        return 1 if final_inv["nan"] else 0
    if args.sharded:
        sim = _ShardedAdapter(params, state, args.method, args.device)
    else:
        sim = FluidSim(params, state, method=args.method, device=args.device)
    mets = metrics.RunMetrics(params, state.n, sim.method)
    print(f"scene={args.scene} N={state.n} dim={params.dim} "
          f"h={params.h:.4g} dt={params.dt:.3g} method={sim.method}")

    interval = max(1, args.report_every)
    step = start
    while step < start + args.steps:
        chunk = min(interval, start + args.steps - step)
        sim.step(chunk)
        step += chunk
        s = mets.record(step, sim.state, params)
        print(f"  step {step}: {s['steps_per_sec']:.1f} steps/s "
              f"ms/frame={s['ms_per_frame']:.2f} vmax={s['vmax']:.3f} "
              f"overflow={s['overflow']}")
        if args.frames_dir:
            os.makedirs(args.frames_dir, exist_ok=True)
            render.save_frame(
                os.path.join(args.frames_dir, f"frame_{step:09d}.png"),
                sim.state, params, width=args.width, height=args.height)
        if args.checkpoint_dir and (step - start) % (
                interval * max(1, args.checkpoint_every)) == 0:
            path = checkpoint.rotate(args.checkpoint_dir, sim.state,
                                     params, step)
            print(f"  checkpoint -> {path}")
    if args.checkpoint_dir:
        checkpoint.rotate(args.checkpoint_dir, sim.state, params, step)
    if args.metrics_json:
        mets.dump_json(args.metrics_json)
    if args.metrics_csv:
        mets.dump_csv(args.metrics_csv)
    final = metrics.invariants(sim.state, params)
    print(json.dumps({k: v for k, v in final.items() if k != "momentum"}))
    return 1 if final["nan"] else 0


class _ShardedAdapter:
    """A ShardedSim behind FluidSim's step / state / method, over one slab
    per visible card, or one slab on a named device (``--device cpu``)."""

    def __init__(self, params, state, method: str, device: str):
        from ..parallel import mesh as meshmod
        from ..parallel.sharded import SHARDED_METHODS, ShardedSim
        mesh = (meshmod.make_mesh() if device == "cuda"
                else meshmod.make_mesh(devices=[device]))
        method = method if method in SHARDED_METHODS else "pallas"
        self._sim = ShardedSim(params, state,
                               mesh=mesh, method=method)
        self.method = f"sharded-{method} x{mesh.size}"
        self.state = state

    def step(self, n: int):
        self._sim.step(n)
        self.state = self._sim.gather()
        return self.state


def cmd_bench(args) -> int:
    return _traced(args, _bench_body, sys.stderr)


def _bench_body(args) -> int:
    from ..models import solver
    from . import profiling

    # --sharded is ignored: the bench times one device, as the
    # reference's does
    params, state = _build_scene(args)
    if args.method == "native":
        # the host engine: the wall clock over k2 - k1 steps after a
        # k1-step warm-up
        from .. import FluidSim
        sim = FluidSim(params, state, method="native", device=args.device)
        sim.step(args.k1)
        t0 = time.perf_counter()
        sim.step(max(1, args.k2 - args.k1))
        t = (time.perf_counter() - t0) / max(1, args.k2 - args.k1)
        method = "native"
    elif args.method in solver.INC_METHODS:
        # the carried state is the plane stack: time step_planes over an
        # IncState (the single-step facade converts on every call)
        from ..ops import inc, sph
        from ..ops import planes as pm
        method = args.method
        cont = method == "pallas_inc_cont"
        geom = pm.geometry(params)
        m_cap = inc.mover_capacity(state.n)
        s0 = inc.to_planes(state.pos, state.vel, state.ids, params, geom,
                           continuity=cont)
        if cont:
            # the steady rate: rho seeded, age 1 (off the resum step)
            p6 = pm.halo_x(s0.fields6)
            occ_q, occ_s = pm.occupancy_bounds(p6, params, geom)
            s0 = s0._replace(
                rhop=sph.density_planes(p6[:3], occ_q, occ_s, params, geom),
                age=1)
        t = profiling.slope_time(
            lambda s: inc.step_planes(s, params, geom, m_cap), s0,
            k1=args.k1, k2=args.k2)
    else:
        method = solver.resolve_method(args.method, state.n)
        fn = solver.METHODS[method]
        t = profiling.slope_time(lambda s: fn(s, params), state,
                                 k1=args.k1, k2=args.k2)
    result = {
        "metric": "particle-steps/sec/chip",
        "scene": args.scene, "n": state.n, "dim": params.dim,
        "method": method,
        "ms_per_frame": t * 1e3,
        "steps_per_sec": 1.0 / t,
        "value": state.n / t,
    }
    print(json.dumps(result))
    return 0


def cmd_render(args) -> int:
    from ..ops import render
    from . import checkpoint

    state, params, step = checkpoint.load(args.checkpoint,
                                          device=args.device)
    render.save_frame(args.out, state, params, width=args.width,
                      height=args.height, color_by=args.color_by,
                      azimuth=args.azimuth, elevation=args.elevation)
    print(f"step {step} -> {args.out}")
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=os.environ.get("FLUID_LOGLEVEL", "WARNING"))
    ap = argparse.ArgumentParser(
        prog="python -m gpufluidsimulator_torch",
        description="SPH fluid simulation on one NVIDIA card (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="simulate a scene")
    _add_scene_args(p)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--report-every", type=int, default=100)
    p.add_argument("--frames-dir", default=None)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=10,
                   help="checkpoints every N report intervals")
    p.add_argument("--resume", default=None, help="checkpoint to resume")
    p.add_argument("--metrics-json", default=None)
    p.add_argument("--metrics-csv", default=None)
    p.add_argument("--movie", default=None,
                   help="export an .npz of position frames (frames, N, "
                        "dim) recorded during the rollout; see "
                        "--movie-every")
    p.add_argument("--movie-every", type=int, default=10,
                   help="record a movie frame every N steps")
    p.add_argument("--profile-dir", default=None,
                   help="wrap the run in a torch.profiler trace; dump to "
                        "this dir (open in TensorBoard/Perfetto)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("bench", help="benchmark one config")
    _add_scene_args(p)
    p.add_argument("--k1", type=int, default=2)
    p.add_argument("--k2", type=int, default=12)
    p.add_argument("--profile-dir", default=None,
                   help="wrap the bench in a torch.profiler trace; dump to "
                        "this dir (open in TensorBoard/Perfetto)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("render", help="render a checkpoint to PNG")
    p.add_argument("checkpoint")
    p.add_argument("-o", "--out", default="frame.png")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--color-by", default="speed",
                   choices=["speed", "density", "none"])
    p.add_argument("--azimuth", type=float, default=30.0)
    p.add_argument("--elevation", type=float, default=20.0)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_render)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
