"""The sharded path across processes: one x slab per process, one process
per card (NCCL), against the same mesh stepped in one process.

    python3 scripts/torch_multigpu.py                       # every card
    python3 scripts/torch_multigpu.py --procs 4 --device cpu --n 2000 \
        --dim 2                                             # gloo, host

The parent starts ``--procs`` copies of itself as ranks of one process
group (``parallel.mesh.init_distributed``, a rendezvous on localhost),
waits for them and stops them if one fails.  Each rank builds the scene,
keeps its own slab (``sharded.distribute_global``), runs ``--steps`` steps
of ``--method`` after two warm-up steps, timed between two barriers by the
wall clock, and gathers the state (an all-gather).  Rank 0 then runs the
same mesh in one process, its slabs all on its own device, and the
unsharded method, and prints one JSON line: ms/step and particle-steps/s
across the processes, the same steps timed in rank 0's process alone (the
mesh's slabs on its device, and one slab), the largest position
difference by id to each
(0.0 to the one-process mesh when the exchanges deliver what the
in-process copies do), ids conserved, overflow and mig_overflow.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parent(args) -> int:
    import torch
    procs = args.procs
    if procs is None:
        procs = torch.cuda.device_count() if args.device == "cuda" else 2
    if args.device == "cuda":
        from gpufluidsimulator_torch import _build
        _build.build()                 # once, before the ranks load it
    port = _free_port()
    children = []
    for rank in range(procs):
        env = dict(os.environ, FLUID_COORDINATOR=f"127.0.0.1:{port}",
                   FLUID_NUM_PROCESSES=str(procs),
                   FLUID_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
        children.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             *sys.argv[1:]], env=env))
    deadline = time.monotonic() + args.timeout
    rc = 0
    try:
        while any(c.poll() is None for c in children):
            if any(c.poll() not in (None, 0) for c in children):
                rc = 1
                break
            if time.monotonic() > deadline:
                print(f"torch_multigpu: ranks still running after "
                      f"{args.timeout} s", file=sys.stderr)
                rc = 1
                break
            time.sleep(0.2)
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
            c.wait()
    return rc or max(c.returncode for c in children)


def child(args) -> int:
    import numpy as np
    import torch
    import gpufluidsimulator_torch as ft
    from gpufluidsimulator_torch.parallel import mesh as meshmod
    from gpufluidsimulator_torch.parallel import sharded

    torch.set_num_threads(1)
    assert meshmod.init_distributed(device=args.device)
    dist = torch.distributed
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = meshmod.make_mesh()                     # one slab a process
    dev = mesh.devices[mesh.local[0]]
    scene = ft.scenes.SCENES[args.scene]
    params, state = scene(n=args.n, dim=args.dim, device="cpu")
    params = params.replace(diagnostics=False)
    n = state.n
    inc = args.method != "pallas"
    cont = args.method == "pallas_inc_cont"

    def run(sstate, m, steps, m_cap):
        if inc:
            return sharded.run_sharded_inc(sstate, params, m, steps,
                                           continuity=cont)
        return sharded.run_sharded(sstate, params, m, steps, m_cap)

    def sync_local():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def sync():
        sync_local()
        dist.barrier()

    sstate, m_cap = sharded.distribute_global(params, state, mesh)
    run(sstate, mesh, 2, m_cap)                    # first touch
    sync()
    t0 = time.perf_counter()
    out = run(sstate, mesh, args.steps, m_cap)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / args.steps
    got = sharded.gather(out, n)                   # raises on a lost id
    # on the rank's device: NCCL reduces CUDA tensors only
    counts = torch.tensor([sum(int(o) for o in f if o is not None)
                           for f in (out.overflow, out.mig_overflow)],
                          device=dev)
    dist.all_reduce(counts)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    if rank == 0:
        # the same mesh in one process: every slab here, on this device
        # (built by hand: make_mesh would join the process group)
        one = meshmod.Mesh(devices=(dev,) * world, ranks=(0,) * world)
        s1, _ = sharded.distribute(params, state, one)
        ref = sharded.gather(run(s1, one, args.steps, m_cap), n)
        # the same steps in this process alone: the mesh on this device,
        # and one slab (the unsharded geometry), timed alike
        single = meshmod.Mesh(devices=(dev,), ranks=(0,))
        s_one, m_one = sharded.distribute(params, state, single)
        ms_alone = {}
        for label, m, st, cap in (("slabs_on_one_device", one, s1, m_cap),
                                  ("one_slab", single, s_one, m_one)):
            run(st, m, 2, cap)
            sync_local()
            t0 = time.perf_counter()
            run(st, m, args.steps, cap)
            sync_local()
            ms_alone[label] = (time.perf_counter() - t0) * 1e3 / args.steps
        flat = ft.run(state.to(dev), params, args.steps, method=args.method,
                      device=dev)
        flat_pos = flat.pos[torch.argsort(flat.ids.long())]
        card = ""
        if dev.type == "cuda":
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
        print(json.dumps({
            "phase": "multigpu", "card": card, "device": dev.type,
            "backend": dist.get_backend(), "processes": world,
            "method": args.method, "scene": args.scene, "particles": n,
            "steps": args.steps, "ms_per_step": ms,
            "particle_steps_per_s": n * 1e3 / ms,
            "ms_per_step_in_one_process": ms_alone,
            "max_abs_err_pos_one_process": float(
                (got.pos - ref.pos).abs().max()),
            "max_abs_err_pos_unsharded": float(
                (got.pos - flat_pos).abs().max()),
            "ids_conserved": bool(torch.equal(
                got.ids.long().cpu(), torch.arange(n))),
            "overflow": int(counts[0]), "mig_overflow": int(counts[1]),
            "peak_mem_gb_rank0": peak,
            "slab_counts": [int(np.sum(a >= 0)) for a in
                            sharded._slab_arrays(params, state, world)[0]
                            ["ids"]]}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=None,
                    help="processes (default: every card; 2 on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scene", default="double_dam_break",
                    choices=["dam_break", "double_dam_break"])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--method", default="pallas_inc",
                    choices=["pallas", "pallas_inc", "pallas_inc_cont"])
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the parent waits for the ranks")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    return child(args) if args.child else parent(args)


if __name__ == "__main__":
    sys.exit(main())
