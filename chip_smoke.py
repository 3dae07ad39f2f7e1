#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpufluidsimulator_torch) on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each printing JSON lines; any failed check exits non-zero:
  1. env      card name and power limit, torch / CUDA / nvcc versions, and
              the build of the hand-written kernels from csrc/
  2. parity   one FluidSim(method="pallas") step and three
              method="pallas_inc" steps on the card against the port's CPU
              path (2D n=600, 3D n=1,200), re-aligned by ids
  3. run      200 steps of the 3D dam break (260,850 particles) and 20 of
              the 3D double dam break (1,197,770 particles) on "pallas";
              then the double dam break through FluidSim(method="auto"),
              which resolves to "pallas_inc", at bench.py's two operating
              points: 100 warm steps on "pallas" then 200 timed ("early"),
              on to 2,000 steps then 200 timed ("evolved").  Each run:
              overflow 0, finite, in bounds, ids a permutation, and launch
              counts that show every step went through every kernel; at
              each point one inc.step_planes call runs under CUDA's sync
              debug mode "error", where a wait for the card fails the run.
              At each point the same start also runs 200 steps through
              FluidSim(method="pallas_inc_cont"), the continuity tier:
              the same checks, its launch counts (force_step_cont and
              consolidate_rho every step, density at ages 0, 64, 128,
              192), the carried rho's range, the position gap to the
              pallas_inc run, step_planes alone with rho seeded and age 1,
              and an age-0 and an age-1 step under sync debug mode
  4. kernels  the full-rebuild kernels at the shapes of the 260,850-particle
              3D dam break (and a jittered copy): held against their plain
              PyTorch versions on the same inputs, timed with CUDA events,
              with their bounds; occ_rowmax both alone (row maxima) and as
              occupancy_bounds (the one occ_rowmax launch that also writes
              occ_q and occ_s, the steps' call), exactly; occ_rowmax,
              occupancy_bounds and gather, whose calls are shorter than
              their launch path, also with their device time and their
              library call's (torch.profiler; the kernel phases come after
              the timed runs, which a profiler session slowed), occ_rowmax
              and occupancy_bounds also cold (cold_ms: device time with L2
              flushed before each call)
  5. kernels  the incremental path's kernels (and occ_rowmax,
              occupancy_bounds, density) at the double dam break's shapes,
              on the planes of the evolved state and on a copy with
              numpy-seeded velocity noise (>= 1% movers): against their
              plain versions, timed, with bounds (occ_rowmax,
              occupancy_bounds and compact also with device times, the
              first two also cold); force_step_cont in every form and
              switch, the 8-channel compact and consolidate_rho
  6. tools     the user-facing entry points at config 4: the CLI's `run`
              in-process (200 steps, frames, checkpoints, metrics JSON;
              overflow 0, the launch counts), `run --resume` and, in the
              API, pallas_inc from the loaded checkpoint and from the
              state that was saved (bitwise equal), pallas_inc_cont
              across save_planes / load_planes (bitwise, a re-sum among
              the steps); `bench` on pallas_inc and pallas_inc_cont and
              scripts/torch_bench.py, held within a factor of 1.25 of the
              run_inc lines' step_planes_ms; the evolved state rendered
              twice (equal PNG bytes) and on the CPU (within 1e-5 of the
              maximum, one level), `render` of a checkpoint;
              debug.assert_deterministic on config 3 pallas, config 4
              pallas_inc and pallas_inc_cont, checked_step on a NaN and an
              overflow; FluidSim(method="native") against naive and
              `bench --method native`
  7. sharded  spatial sharding (parallel/): sharded_parity runs config 4
              with two engineered slab crossers on a 4-slab mesh of the
              card (make_mesh(devices=[cuda:0] * 4)) for 10 steps of
              pallas_inc and pallas_inc_cont and 5 of pallas, against the
              same state unsharded (positions by id within 1e-5, ids
              conserved, overflow and mig_overflow 0, each crosser on its
              neighbour slab), and one sharded pallas_inc step under sync
              debug mode "error"; slab_force holds force_step and
              force_step_cont on the planes of slabs 2 and 3 (x origin not
              bounds_min[0], the global walls, ghost lanes filled, velocity
              noise) against their plain versions; sharded_run runs config
              5 (4,825,800 particles) on 8 slabs and on 1 for 100 steps of
              pallas_inc and pallas_inc_cont: ms/step, rate, peak memory,
              slab counts, both counters 0, the exchanges' share of the
              step (CUDA events around each exchange); sharded_tools runs
              `run --sharded` through the CLI and resumes a 4-slab
              run_sharded from save_sharded / load_sharded bitwise
  8. acceptance  the reference's acceptance gates at its sizes, step
              counts and bars: dt2_parity runs config 1's scene (the 2D
              dam break of 4,096) at half its CFL dt for 1,000 steps on
              naive, gridded, pallas and pallas_inc (within 1e-3 of the
              port's float64 C++ oracle, particles by id) and
              pallas_inc_cont (1e-2), overflow 0; statistical runs the
              full-CFL statistical acceptance of pallas_inc and
              pallas_inc_cont (scripts/torch_accept_cont.py: binned
              density, centre of mass and kinetic energy at 250, 500, 750
              and 1,000 steps within max(8 x the oracle's 1-ulp envelope,
              floors), the centre of mass fallen by more than 0.02);
              invariant_* runs scripts/torch_invariants.py's momentum,
              energy, finiteness, bounds and obstacle checks on naive,
              pallas_inc and pallas_inc_cont; soak steps config 4 5,000
              times on each incremental tier in chunks of 250
              (scripts/torch_soak.py): in every chunk overflow and
              mig_overflow 0, all 1,197,770 particles live, every field
              finite, with each chunk's ms/step and vmax, and launch
              counts that show every step went through the tier's kernels
  9. the kernels line (occ_rowmax's entry leads with occupancy_bounds'
     numbers, the mode the steps launch, and holds the row-maxima-only
     call's under row_maxima_only; every entry has launches_sharded and
     launches_sharded_cont, its launches per config-5 step on 8 slabs,
     and launches_soak and launches_soak_cont, its launches in each
     tier's soak), the card line, and the final ok line.
Phase 2 also runs three pallas_inc_cont steps (rate with RESUM_EVERY = 2,
then sum) on the card against the port's CPU path, with the carried rho,
one FluidSim(method="gridded") step (2D n=600, 3D n=1,200) and the packed
sweep's accel_mxu (a settled 3D scene of 1,080 particles) likewise.
Phase 3 also runs config 2, the 2D dam break of 65,522 particles, for 200
steps through FluidSim(method="gridded") (plain PyTorch: no kernel).
Phase 5 also runs the packed-pair sweep on the evolved double dam break:
accel_mxu with the launch counts zeroed, the kernel against its plain
version, its padding accounting (table_stats, the pairs the kernel's
query groups evaluate, and the exact 27-cell pair ideal), its time and
bound, and the rank-plane accel_planes (force) on the
same positions, velocities and density, timed and held within 1e-6 of its
largest acceleration.
The redesigned kernels (density, force, force_step, force_step_cont,
gather, compact, consolidate, consolidate_rho, occ_rowmax, sweep_packed)
carry in their config-4 (force, gather: config-3) kernel_time lines, and
in the `redesigned` line, the registers, spills and shared memory of their
main-path instantiation (from the build's -Xptxas -v report and the
sweep kernels' own dynamic shared memory queries) and their previous
design's time (prev_ms, a constant).  Phase 5 also holds the plain force
kernel against its plain version on both config-4 planes.
Imports nothing of JAX or of gpufluidsimulator_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
# flops per candidate pair, counted from the kernels' arithmetic
DENSITY_PAIR_FLOPS = 13
FORCE_PAIR_FLOPS = 32
# the continuity step's default form (rate, cont_beta > 0) adds dv.d (8),
# d2 (2), d4, d4 dot, the clamped correction (4) and the rate sum
FORCE_CONT_PAIR_FLOPS = FORCE_PAIR_FLOPS + 17
# the packed sweep (csrc/packed_sweep.cu): every candidate pair costs the
# difference, r^2, max, rsqrt, r, h - r, max and the two tests; a pair
# inside the support adds the two coefficients (7) and the six
# multiply-adds with the three velocity differences (15).  Its bound counts
# the pairs of the exact 27-cell candidate set, as the rank-plane force
# bound does, not the padded pairs its three ranges cover.
PACKED_PAIR_FLOPS = 15
PACKED_SUPPORT_FLOPS = 22
# the kernel's test of a segment row against its group's bounding box (6
# differences, 6 maxima, the squared distance, the compare); its issued
# rate counts that per row walked, the pair cost per row tested
PACKED_BOX_FLOPS = 16
REPS = 20
# the previous designs' times of the redesigned kernels, as PERF.md
# section 6 records them (this script on an H100 80GB HBM3 at 700.00 W):
# force and gather at config 3, the others on the evolved config-4 planes
PREV_MS = {"force": 0.33824, "force_step": 1.87198,
           "force_step_cont": 2.80023, "compact": 0.12058,
           "density": 0.46470, "gather": 0.02869, "consolidate": 0.40340,
           "consolidate_rho": 0.47705,
           # occ_rowmax: its device time (torch.profiler), 20 calls in a row
           "occ_rowmax": 0.01028,
           # the previous design (a block per query tile over its whole ranges)
           "sweep_packed": 1.30029}
PREV_AT_CONFIG3 = ("force", "gather")
# the instantiation each of them runs on the main paths (K = 8, 3D; the
# continuity tier's default form, rate; the step's 4 gathered channels
# with diagnostics on): a prefix of its mangled name
MAIN_INSTANCE = {"force": "_Z12force_kernelILi8ELi3ELb0ELi0EE",
                 "force_step": "_Z12force_kernelILi8ELi3ELb1ELi0EE",
                 "force_step_cont": "_Z12force_kernelILi8ELi3ELb1ELi1EE",
                 "compact": "_Z14compact_kernel",
                 "density": "_Z14density_kernelILi8ELi3EE",
                 "gather": "_Z13gather_kernelILi4EE",
                 "consolidate": "_Z18consolidate_kernelILb0EE",
                 "consolidate_rho": "_Z18consolidate_kernelILb1EE",
                 "occ_rowmax": "_Z17occ_rowmax_kernel",
                 "sweep_packed": "_Z19packed_sweep_kernel"}
WARM_EARLY = 100            # bench.py's operating points
WARM_EVOLVED = 2000
INC_STEPS = 200


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call, from CUDA events around ``reps`` calls
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# profiler sessions a device time may take: a session now and then records
# no device activity at all (seen on the H100), so an empty one is retried
PROFILE_TRIES = 3


def kernel_us(torch, fn, reps: int) -> dict:
    """Device time (us) and launches of each kernel, copy and fill that
    ``reps`` calls of ``fn`` launched, by name, summed by torch.profiler
    after two warm-up calls; an empty session is retried."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {e.key: (e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
        if out:
            return out
    check(False, f"torch.profiler saw no device time in {PROFILE_TRIES} "
                 f"sessions")


def device_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call (kernel_us summed).  For a call
    shorter than its launch path, time_ms times the host."""
    return sum(us for us, _ in kernel_us(torch, fn, reps).values()) \
        / 1e3 / reps


def cold_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call with L2 flushed before it: kernel_us
    over ``reps`` pairs of a flush (a bitwise_not_ of a FLUSH_BYTES buffer)
    and a call, less the kernels a flush alone launches."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    flush_keys = set(kernel_us(torch, buf.bitwise_not_, 3))
    pairs = kernel_us(torch, lambda: (buf.bitwise_not_(), fn()), reps)
    return sum(us for k, (us, _) in pairs.items()
               if k not in flush_keys) / 1e3 / reps


# kernels whose calls are shorter than their launch path: timed on the
# device too, with their library call, after the other cases of their
# phase (the kernel phases run after the timed steps: a torch.profiler
# session slowed the host-bound steps that came after it)
DEVICE_TIMED = ("occ_rowmax", "occupancy_bounds", "gather", "compact")
# of those, the calls whose input a step finds outside L2 while 20 calls
# in a row find it inside: also timed cold (cold_ms)
COLD_TIMED = ("occ_rowmax", "occupancy_bounds")
FLUSH_BYTES = 128 << 20          # over twice the H100's 50 MB of L2


def rel_err(a, b) -> tuple:
    d = float((a.double() - b.double()).abs().max())
    scale = max(float(b.double().abs().max()), 1e-9)
    return d, d / scale


def phase_env(torch, ft_build):
    nvcc = subprocess.run([ft_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    emit({"phase": "env", "card": card_line(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "device_count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    ft_build.library()
    secs = time.perf_counter() - t0
    # per kernel instantiation (mangled name): registers, spills, static
    # shared memory
    emit({"phase": "build", "seconds": round(secs, 3),
          "library": ft_build.build_log["path"],
          "ptxas": ft_build.ptxas_report(ft_build.build_log["text"])})


def redesign_facts(report: dict, dyn_smem: dict) -> dict:
    """registers, spills, smem_bytes (static + the dynamic ``dyn_smem`` of
    the kernels that have one) and prev_ms of each redesigned kernel's
    main-path instantiation."""
    facts = {}
    for kernel, prefix in MAIN_INSTANCE.items():
        hits = [v for k, v in report.items() if k.startswith(prefix)]
        check(len(hits) == 1, f"ptxas report: {len(hits)} entries for "
                              f"{kernel} ({prefix})")
        dyn = dyn_smem.get(kernel, 0)
        facts[kernel] = {"registers": hits[0]["registers"],
                         "spills": hits[0]["spills"],
                         "smem_bytes": hits[0]["static_smem"] + dyn,
                         "prev_ms": PREV_MS[kernel]}
    return facts


def stencil_pairs(torch, planes, geom):
    """Candidate pairs the sweeps evaluate on this data: for every valid
    rank of an interior cell, the valid ranks of its 3^d neighbour cells
    (self included)."""
    from gpufluidsimulator_torch.ops import sph
    from gpufluidsimulator_torch.ops import planes as pm
    occ = (planes[0] < pm.SENTINEL * 0.5).sum(0).to(torch.float64)
    centre = sph._window(occ, geom)
    nbr = sum(sph._window(occ, geom, dz, dy, dx)
              for dz, dy, dx in sph._offsets(geom.dim))
    return float((centre * nbr).sum())


def plane_touch(torch, planes, geom, region):
    """Elements a rank loop must read on this data, given dense ranks: the
    valid slots, and the x probes that find them (a cell's valid ranks plus
    its first sentinel rank, where it has one) over the cells the loop
    visits.  ``region``: "all" (occ_rowmax reads every row), "interior"
    (consolidate) or "sweep" (density, force, force_step: every interior
    cell, and the 3^d neighbours of each one that holds a particle)."""
    from gpufluidsimulator_torch.ops import sph
    from gpufluidsimulator_torch.ops import planes as pm
    occ = (planes[0] < pm.SENTINEL * 0.5).sum(0)
    probes = torch.clamp_max(occ + 1, geom.k)
    if region != "all":
        inter = pm.interior_mask(geom, occ.device)
        mask = inter.clone()
        if region == "sweep":
            held = sph._window(inter & (occ > 0), geom)
            for dz, dy, dx in sph._offsets(geom.dim):
                sph._window(mask, geom, dz, dy, dx)[...] |= held
        probes = probes[mask]
    return float(occ.sum()), float(probes.sum())


TIME_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "bytes", "flops")
DEVICE_KEYS = ("device_ms", "library_device_ms", "cold_ms")


def timings(torch, name, c, shape, r, deferred) -> None:
    """ms, plain_ms, library_ms of a case (CUDA events) and its bounds into
    ``r``; a DEVICE_TIMED kernel's case goes on ``deferred`` for
    device_times."""
    r.update(ms=time_ms(torch, c["kernel"], REPS),
             plain_ms=time_ms(torch, c["plain"], 3),
             library_ms=(time_ms(torch, c["library"], REPS)
                         if c["library"] is not None else None),
             **bounds(c))
    if name in DEVICE_TIMED:
        deferred.append((name, shape, c, r))


def device_times(torch, deferred) -> None:
    """device_ms, library_device_ms and, for COLD_TIMED, cold_ms
    (torch.profiler) of the deferred cases, into their results; empties
    ``deferred``."""
    while deferred:
        name, shape, c, r = deferred.pop(0)
        r.update(device_ms=device_ms(torch, c["kernel"], REPS),
                 library_device_ms=(device_ms(torch, c["library"], REPS)
                                    if c["library"] is not None else None))
        if name in COLD_TIMED:
            r["cold_ms"] = cold_ms(torch, c["kernel"], REPS)
        emit({"phase": "device_time", "kernel": name, "shape": shape,
              **{k: r[k] for k in ("ms", "library_ms") + DEVICE_KEYS
                 if k in r}})


def bounds(c) -> dict:
    """bound_ms: the larger of the bytes the kernel must move on this run's
    data over the memory rate and its pair operations over the float32
    rate."""
    by_bytes = c["bytes"] / HBM_BYTES_PER_S
    by_ops = c["flops"] / F32_FLOPS
    return dict(bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=c["bytes"], flops=c["flops"])


def phase_kernels(torch, ft, facts):
    from gpufluidsimulator_torch.ops import planes as pm
    from gpufluidsimulator_torch.ops import route, sph

    dev = torch.device("cuda")
    results = {}
    deferred = []
    for label, jitter in (("lattice", 0.0), ("jittered", 0.3)):
        params, state = ft.scenes.dam_break(n=262144, dim=3, jitter=jitter,
                                            seed=1, device=dev)
        geom = pm.geometry(params)
        table = pm.build_planes(state.pos, state.vel, state.ids, params,
                                geom)
        planes = table.planes
        fields = torch.cat([table.pos_s.T, table.vel_s.T]).contiguous()
        occ_q, occ_s = pm.occupancy_bounds(planes, params, geom)
        rho = pm.halo_x(sph.density_planes(planes[:3], occ_q, occ_s, params,
                                           geom))
        acc = sph.accel_planes(planes, rho, occ_q, occ_s, params, geom)
        stack = torch.cat([acc, rho[None]]).contiguous()
        slot, ok = table.slot, table.ok
        n = state.n
        kc = geom.k * geom.cells
        dim = geom.dim
        valid, probes_all = plane_touch(torch, planes, geom, "all")
        _, probes = plane_touch(torch, planes, geom, "sweep")
        rows_b = geom.pz * geom.n_bx * geom.py * 4
        bounds_b = 4 * geom.nz * geom.n_bx * geom.n_by * 4
        cases = {
            "occ_rowmax": dict(
                kernel=lambda: pm.occ_rowmax(planes[0], geom),
                plain=lambda: pm.occ_rowmax_plain(planes[0]),
                library=lambda: torch.amax(torch.sum(
                    planes[0] < pm.SENTINEL * 0.5, dim=0,
                    dtype=torch.int32), dim=-1),
                tol=0.0, exact=True, bytes=probes_all * 4 + rows_b, flops=0),
            # the step's call: one occ_rowmax launch writes occ_q, occ_s
            "occupancy_bounds": dict(
                kernel=lambda: pm.occupancy_bounds(planes, params, geom),
                plain=lambda: pm.occupancy_bounds_plain(planes, params,
                                                        geom),
                library=None, tol=0.0, exact=True,
                bytes=probes_all * 4 + bounds_b, flops=0),
            "place": dict(
                kernel=lambda: route.place(fields, slot, ok, geom, 3),
                plain=lambda: route.place_plain(fields, slot, ok, geom, 3),
                library=None, tol=0.0, exact=True,
                bytes=6 * n * 4 + n * 4 + n + 6 * kc * 4,
                flops=0),
            "density": dict(
                kernel=lambda: sph.density_planes(planes[:3], occ_q, occ_s,
                                                  params, geom),
                plain=lambda: sph.density_plain(planes[:3], params, geom),
                library=None, tol=1e-5, exact=False,
                bytes=(probes + (dim - 1) * valid + kc) * 4,
                flops=DENSITY_PAIR_FLOPS * stencil_pairs(torch, planes,
                                                         geom)),
            "force": dict(
                kernel=lambda: sph.accel_planes(planes, rho, occ_q, occ_s,
                                                params, geom),
                plain=lambda: sph.accel_plain(planes, rho, params, geom),
                library=None, tol=1e-4, exact=False,
                bytes=(probes + 2 * dim * valid + 3 * kc) * 4,
                flops=FORCE_PAIR_FLOPS * stencil_pairs(torch, planes, geom)),
            "gather": dict(
                kernel=lambda: route.gather(stack, slot),
                plain=lambda: route.gather_plain(stack, slot),
                library=None, tol=0.0, exact=True,
                bytes=n * 4 * 4 + n * 4 + n * 4 * 4,
                flops=0),
        }
        # one PyTorch call computing the same function, where one exists:
        # the (N, C) rows at the clamped slots
        flat_stack = stack.reshape(stack.shape[0], -1)
        idx = torch.clamp_max(slot.to(torch.int64), kc - 1)
        cases["gather"]["library"] = lambda: flat_stack.T[idx]
        slot_ok = slot[ok].to(torch.int64)
        vals_ok = fields[:, ok]
        chan = torch.arange(6, device=dev)[:, None]
        # out of place: a copy of the sentinel-filled planes with the
        # particles scattered in, the whole function of place
        prefilled = route.place_plain(fields[:, :0], slot[:0], ok[:0], geom,
                                      3).reshape(6, -1)
        cases["place"]["library"] = lambda: prefilled.index_put(
            (chan, slot_ok[None, :]), vals_ok)

        for name, c in cases.items():
            got, want = c["kernel"](), c["plain"]()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      f"{name} ({label}): shape/dtype {tuple(a.shape)} "
                      f"{a.dtype} vs plain {tuple(b.shape)} {b.dtype}")
            if c["exact"]:
                err = rel = max(float((a.double() - b.double()).abs().max())
                                for a, b in zip(got, want))
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"{name} ({label}) differs from its plain version")
            else:
                err, rel = rel_err(got[0], want[0])
                check(np.isfinite(err) and rel <= c["tol"],
                      f"{name} ({label}) rel err {rel} > {c['tol']}")
            emit({"phase": "kernel_check", "kernel": name, "input": label,
                  "max_abs_err": err, "rel_err": rel, "tol": c["tol"],
                  "exact": c["exact"]})
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if label == "lattice":
                shape = "dam_break n=262144 3D (260,850 particles)"
                timings(torch, name, c, shape, r, deferred)
                emit({"phase": "kernel_time", "kernel": name,
                      "shape": shape, "valid_slots": valid,
                      "probe_slots": probes,
                      **{k: r[k] for k in TIME_KEYS if k in r},
                      **(facts.get(name, {}) if name in PREV_AT_CONFIG3
                         else {})})
        device_times(torch, deferred)
        del cases, planes, table, rho, acc, stack, prefilled
        torch.cuda.empty_cache()
    return results


def aligned(state):
    o = np.argsort(state.ids.cpu().numpy())
    return (state.pos.cpu().numpy()[o], state.vel.cpu().numpy()[o],
            state.rho.cpu().numpy()[o])


def phase_parity(torch, ft):
    for dim, n in ((2, 600), (3, 1200)):
        params, state = ft.scenes.dam_break(n=n, dim=dim, jitter=0.3,
                                            seed=11, device="cpu")
        gpu = ft.FluidSim(params, state, method="pallas")
        gpu.step(1)
        cpu = ft.FluidSim(params, state, method="pallas", device="cpu")
        cpu.step(1)
        pg, vg, rg = aligned(gpu.state)
        pc, vc, rc = aligned(cpu.state)
        errs = {}
        for key, a, b, tol in (("rho", rg, rc, 1e-5), ("pos", pg, pc, 1e-6),
                               ("vel", vg, vc, 1e-4)):
            rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))
            errs[key] = rel
            check(rel <= tol, f"parity {dim}D n={n}: {key} rel {rel} > {tol}")
        check(int(gpu.state.overflow) == int(cpu.state.overflow),
              "parity: overflow differs")
        emit({"phase": "parity", "dim": dim, "n": state.n,
              "rel_err": errs, "tol": {"rho": 1e-5, "pos": 1e-6,
                                       "vel": 1e-4}})


def settled_packed_input(ft, n, steps):
    """A 3D dam break settled by a few all-pairs steps on the CPU, with its
    summation density and pressure (tests/test_torch_mxu.py's input)."""
    from gpufluidsimulator_torch.ops import naive, physics
    params, state = ft.scenes.dam_break(n=n, dim=3, jitter=0.3, seed=3,
                                        device="cpu")
    state = ft.run(state, params, steps, method="naive", device="cpu")
    rho = naive.density_naive(state.pos, params)
    return params, [state.pos, state.vel, rho,
                    physics.eos_pressure(rho, params)]


def phase_parity_gridded(torch, ft):
    """One FluidSim(method="gridded") step on the card against the port's
    CPU path (the pallas parity's tolerances), and accel_mxu on the card
    against the CPU within 1e-5."""
    from gpufluidsimulator_torch.ops import mxu_sweep
    tol = {"rho": 1e-5, "pos": 1e-6, "vel": 1e-4}
    for dim, n in ((2, 600), (3, 1200)):
        params, state = ft.scenes.dam_break(n=n, dim=dim, jitter=0.3,
                                            seed=11, device="cpu")
        gpu = ft.FluidSim(params, state, method="gridded")
        gpu.step(1)
        cpu = ft.FluidSim(params, state, method="gridded", device="cpu")
        cpu.step(1)
        errs = {}
        for key, a, b in zip(("pos", "vel", "rho"), aligned(gpu.state),
                             aligned(cpu.state)):
            errs[key] = float(np.abs(a - b).max()
                              / max(np.abs(b).max(), 1e-9))
            check(errs[key] <= tol[key], f"gridded parity {dim}D n={n}: "
                                         f"{key} rel {errs[key]}")
        check(int(gpu.state.overflow) == int(cpu.state.overflow) == 0,
              "gridded parity: overflow")
        emit({"phase": "parity_gridded", "dim": dim, "n": state.n,
              "rel_err": errs, "tol": tol})
    params, host = settled_packed_input(ft, 1100, 5)
    got = mxu_sweep.accel_mxu(*(t.cuda() for t in host), params)
    want = mxu_sweep.accel_mxu(*host, params)
    err, rel = rel_err(got.cpu(), want)
    check(rel <= 1e-5, f"accel_mxu card vs CPU: rel {rel}")
    emit({"phase": "parity_accel_mxu", "dim": 3, "n": host[0].shape[0],
          "max_abs_err": err, "rel_err": rel, "tol": 1e-5})


def phase_parity_inc(torch, ft):
    """Three pallas_inc steps on the card against the port's CPU path;
    summation order compounds over the steps: pos 1e-5, vel 1e-3."""
    tol = {"pos": 1e-5, "vel": 1e-3}
    for dim, scene, kw in ((2, ft.scenes.dam_break,
                            dict(n=600, jitter=0.3, seed=11)),
                           (3, ft.scenes.double_dam_break, dict(n=1200))):
        params, state = scene(dim=dim, **kw, device="cpu")
        gpu = ft.run(state, params, 3, method="pallas_inc", device="cuda")
        cpu = ft.run(state, params, 3, method="pallas_inc", device="cpu")
        pg, vg, _ = aligned(gpu)
        pc, vc, _ = aligned(cpu)
        errs = {}
        for key, a, b in (("pos", pg, pc), ("vel", vg, vc)):
            errs[key] = float(np.abs(a - b).max()
                              / max(np.abs(b).max(), 1e-9))
            check(errs[key] <= tol[key], f"pallas_inc parity {dim}D: {key} "
                                         f"rel {errs[key]} > {tol[key]}")
        check(int(gpu.overflow) == int(cpu.overflow),
              "pallas_inc parity: overflow differs")
        emit({"phase": "parity_inc", "dim": dim, "n": state.n, "steps": 3,
              "rel_err": errs, "tol": tol})


def carried_rho(torch, state, params, device, steps):
    """The carried rho after ``steps`` inc.step_planes calls from ``state``
    on ``device``, indexed by particle id (numpy)."""
    from gpufluidsimulator_torch.ops import inc
    from gpufluidsimulator_torch.ops import planes as pm
    geom = pm.geometry(params)
    s = inc.to_planes(*(t.to(device) for t in
                        (state.pos, state.vel, state.ids)), params, geom,
                      continuity=True)
    for _ in range(steps):
        s = inc.step_planes(s, params, geom, inc.mover_capacity(state.n))
    valid = (s.fields6[0] < pm.SENTINEL * 0.5) \
        & pm.interior_mask(geom, s.idp.device)[None]
    out = np.zeros(state.n, np.float32)
    out[s.idp[valid].long().cpu().numpy()] = s.rhop[valid].cpu().numpy()
    return out


def phase_parity_inc_cont(torch, ft):
    """Three pallas_inc_cont steps on the card against the port's CPU path,
    rate with RESUM_EVERY = 2 (step 3 re-sums) and then sum: positions and
    velocities through ft.run, the carried rho keyed by id through three
    inc.step_planes calls on each device."""
    from gpufluidsimulator_torch.ops import inc
    tol = {"pos": 1e-5, "vel": 1e-3, "rho": 1e-5}
    resum = inc.RESUM_EVERY
    inc.RESUM_EVERY = 2
    try:
        for form in ("rate", "sum"):
            for dim, scene, kw in ((2, ft.scenes.dam_break,
                                    dict(n=600, jitter=0.3, seed=11)),
                                   (3, ft.scenes.double_dam_break,
                                    dict(n=1200))):
                params, state = scene(dim=dim, **kw, device="cpu")
                params = params.replace(cont_form=form)
                runs = [ft.run(state, params, 3, method="pallas_inc_cont",
                               device=dev) for dev in ("cuda", "cpu")]
                (pg, vg, _), (pc, vc, _) = (aligned(r) for r in runs)
                rg, rc = (carried_rho(torch, state, params, dev, 3)
                          for dev in ("cuda", "cpu"))
                errs = {}
                for key, a, b in (("pos", pg, pc), ("vel", vg, vc),
                                  ("rho", rg, rc)):
                    errs[key] = float(np.abs(a - b).max()
                                      / max(np.abs(b).max(), 1e-9))
                    check(errs[key] <= tol[key],
                          f"pallas_inc_cont parity {form} {dim}D: {key} "
                          f"rel {errs[key]} > {tol[key]}")
                check(int(runs[0].overflow) == int(runs[1].overflow),
                      "pallas_inc_cont parity: overflow differs")
                emit({"phase": "parity_inc_cont", "cont_form": form,
                      "resum_every": inc.RESUM_EVERY, "dim": dim,
                      "n": state.n, "steps": 3, "rel_err": errs,
                      "tol": tol})
    finally:
        inc.RESUM_EVERY = resum


def check_state(torch, st, params, n, label):
    pos = st.pos
    lo = torch.tensor(params.bounds_min, device=pos.device)
    hi = torch.tensor(params.bounds_max, device=pos.device)
    overflow = int(st.overflow)
    finite = bool(torch.isfinite(pos).all() and torch.isfinite(st.vel).all())
    inside = bool(((pos >= lo - 1e-6) & (pos <= hi + 1e-6)).all())
    perm = bool(torch.equal(torch.sort(st.ids.long()).values,
                            torch.arange(n, device=pos.device)))
    check(overflow == 0, f"{label}: overflow {overflow}")
    check(finite, f"{label}: non-finite positions or velocities")
    check(inside, f"{label}: positions out of bounds")
    check(perm, f"{label}: ids are not a permutation")
    return dict(overflow=overflow, finite=finite, in_bounds=inside,
                ids_permutation=perm)


def phase_run(torch, ft, ft_build, scene, kwargs, steps, label):
    params, state = scene(**kwargs, device="cuda")
    n = state.n
    warm = ft.FluidSim(params, state, method="pallas")
    warm.step(1)                      # first-touch allocations, sort setup
    torch.cuda.synchronize()
    del warm
    sim = ft.FluidSim(params, state, method="pallas")
    ft_build.reset_launches()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    t0.record()
    sim.step(steps)
    t1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    counts = dict(ft_build.launches)
    ms = t0.elapsed_time(t1) / steps
    checks = check_state(torch, sim.state, params, n, label)
    for name, cnt in counts.items():
        want = steps if name in SLICE1 else 0
        check(cnt == want, f"{label}: kernel {name} launched {cnt} times "
                           f"in {steps} steps (expected {want})")
    rho = sim.state.rho
    emit({"phase": "run", "scene": label, "particles": n, "steps": steps,
          "ms_per_step": ms, "particle_steps_per_s": n * 1e3 / ms,
          "wall_s": wall, "launches": counts,
          "rho_mean": float(rho.mean()), "rho_max": float(rho.max()),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **checks})
    return counts


def phase_gridded_run(torch, ft, ft_build):
    """Config 2 (BASELINE.json configs[1]): the 2D dam break of 65,522
    particles, 200 steps through FluidSim(method="gridded"), which runs
    plain PyTorch on the card and launches none of the kernels."""
    params, state = ft.scenes.dam_break(n=65536, dim=2, device="cuda")
    n = state.n
    sim = ft.FluidSim(params, state, method="gridded")
    sim.step(1)                           # first-touch allocations
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft_build.reset_launches()
    steps = 200
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    w0 = time.perf_counter()
    t0.record()
    sim.step(steps)
    t1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    counts = dict(ft_build.launches)
    ms = t0.elapsed_time(t1) / steps
    checks = check_state(torch, sim.state, params, n, "gridded config 2")
    check(not any(counts.values()), f"gridded launched kernels: {counts}")
    rho = sim.state.rho
    emit({"phase": "run", "scene": "dam_break_2d_65522", "method":
          sim.method, "particles": n, "steps": steps, "ms_per_step": ms,
          "particle_steps_per_s": n * 1e3 / ms, "wall_s": wall,
          "launches": counts, "rho_mean": float(rho.mean()),
          "rho_max": float(rho.max()),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **checks})


def phase_inc_run(torch, ft, ft_build):
    """Config 4 through FluidSim(method="auto") at bench.py's two operating
    points.  Returns the evolved state, the params, the launch counts of
    the early runs (pallas_inc, pallas_inc_cont) and step_planes' ms at
    each point."""
    from gpufluidsimulator_torch.models import solver
    from gpufluidsimulator_torch.ops import inc
    from gpufluidsimulator_torch.ops import planes as pm

    params, state = ft.scenes.double_dam_break(n=1_000_000, dim=3,
                                               device="cuda")
    params = params.replace(diagnostics=False)     # as bench.py:59
    n = state.n
    geom = pm.geometry(params)
    warm = ft.FluidSim(params, state, method="pallas")
    warm.step(WARM_EARLY)
    torch.cuda.synchronize()
    resolved = solver._run_method("auto", INC_STEPS, n)
    check(resolved == "pallas_inc",
          f"auto resolved to {resolved!r} for {INC_STEPS} steps at n={n}")
    sim = ft.FluidSim(params, warm.state)            # method="auto"
    del warm
    counts = counts_cont = {}
    step_planes_ms = {}
    done = WARM_EARLY
    for label, at in (("early", WARM_EARLY), ("evolved", WARM_EVOLVED)):
        if at > done:
            sim.step(at - done)
            done = at
        start = sim.state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ft_build.reset_launches()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        t0.record()
        sim.step(INC_STEPS)
        t1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        done += INC_STEPS
        got = dict(ft_build.launches)
        ms = t0.elapsed_time(t1) / INC_STEPS
        peak = torch.cuda.max_memory_allocated() / 1e9
        checks = check_state(torch, sim.state, params, n,
                             f"pallas_inc {label}")
        want = dict.fromkeys(got, 0)
        want.update(occ_rowmax=INC_STEPS, density=INC_STEPS,
                    force_step=INC_STEPS, consolidate=INC_STEPS,
                    compact=INC_STEPS + 1, place=1)
        check(got == want, f"pallas_inc {label}: launches {got}, expected "
                           f"{want}")
        if label == "early":
            counts = got
        # the steady step alone (conversions excluded), as bench.py's
        # slope timer sees it
        s0 = inc.to_planes(sim.state.pos, sim.state.vel, sim.state.ids,
                           params, geom)
        m_cap = inc.mover_capacity(n)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            inc.step_planes(s0, params, geom, m_cap)
        except RuntimeError as err:
            check(False, f"step_planes waited for the card: {err}")
        finally:
            torch.cuda.set_sync_debug_mode("default")

        def steps(s=s0):
            for _ in range(20):
                s = inc.step_planes(s, params, geom, m_cap)
            return s
        step_ms = time_ms(torch, steps, 3) / 20
        step_planes_ms[label] = step_ms
        del s0
        emit({"phase": "run_inc", "scene": "double_dam_break_3d_1197770",
              "method": resolved, "point": label,
              "steps_before": done - INC_STEPS, "steps": INC_STEPS,
              "ms_per_step": ms, "particle_steps_per_s": n * 1e3 / ms,
              "step_planes_ms": step_ms,
              "step_planes_particle_steps_per_s": n * 1e3 / step_ms,
              "wall_s": wall, "peak_mem_gb": peak, "launches": got,
              **checks})
        got = cont_point(torch, ft, ft_build, params, start, sim.state,
                         label, done - INC_STEPS)
        if label == "early":
            counts_cont = got
    return sim.state, params, counts, counts_cont, step_planes_ms


def positions_by_id(st):
    out = st.pos.new_zeros(st.pos.shape)
    out[st.ids.long()] = st.pos
    return out


def cont_point(torch, ft, ft_build, params, start, inc_end, label, before):
    """The continuity tier at one operating point: 200 steps through
    FluidSim(method="pallas_inc_cont") from ``start`` (the state that the
    pallas_inc run timed there started from; ``inc_end`` is where it
    ended).  Returns the launch counts."""
    from gpufluidsimulator_torch.ops import inc, sph
    from gpufluidsimulator_torch.ops import planes as pm

    n = start.n
    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(n)
    sim = ft.FluidSim(params, start, method="pallas_inc_cont")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft_build.reset_launches()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    w0 = time.perf_counter()
    t0.record()
    sim.step(INC_STEPS)
    t1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = dict(ft_build.launches)
    ms = t0.elapsed_time(t1) / INC_STEPS
    peak = torch.cuda.max_memory_allocated() / 1e9
    checks = check_state(torch, sim.state, params, n,
                         f"pallas_inc_cont {label}")
    want = dict.fromkeys(got, 0)
    want.update(occ_rowmax=INC_STEPS,
                density=len(range(0, INC_STEPS, inc.RESUM_EVERY)),
                force_step_cont=INC_STEPS, consolidate_rho=INC_STEPS,
                compact=INC_STEPS + 1, place=1)
    check(got == want, f"pallas_inc_cont {label}: launches {got}, "
                       f"expected {want}")
    # O(dt)-different formulations: printed, not gated
    gap = float((positions_by_id(sim.state)
                 - positions_by_id(inc_end)).abs().max())
    # the carried rho after the same 200 steps on the resident planes
    s = inc.to_planes(start.pos, start.vel, start.ids, params, geom,
                      continuity=True)
    for _ in range(INC_STEPS):
        s = inc.step_planes(s, params, geom, m_cap)
    valid = (s.fields6[0] < pm.SENTINEL * 0.5) \
        & pm.interior_mask(geom, s.idp.device)[None]
    rho = s.rhop[valid].double()
    check(bool(torch.isfinite(rho).all()), f"pallas_inc_cont {label}: "
                                           f"carried rho not finite")
    del s, valid
    # an age-0 (seeding sweep) and an age-1 step under sync debug "error"
    s0 = inc.to_planes(start.pos, start.vel, start.ids, params, geom,
                       continuity=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s2 = inc.step_planes(inc.step_planes(s0, params, geom, m_cap),
                             params, geom, m_cap)
    except RuntimeError as err:
        check(False, f"continuity step_planes waited for the card: {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(s2.age == 2, f"age {s2.age} after two steps")
    del s2
    # the steady step alone, as bench.py:76-84 times it: rho seeded by one
    # density sweep, age pinned to 1 (no re-sum in the 20 steps)
    p6 = pm.halo_x(s0.fields6)
    occ_q, occ_s = pm.occupancy_bounds(p6, params, geom)
    seeded = s0._replace(rhop=sph.density_planes(p6[:3], occ_q, occ_s,
                                                 params, geom), age=1)

    def steps(s=seeded):
        for _ in range(20):
            s = inc.step_planes(s, params, geom, m_cap)
        return s
    step_ms = time_ms(torch, steps, 3) / 20
    del s0, seeded, p6
    emit({"phase": "run_inc_cont",
          "scene": "double_dam_break_3d_1197770",
          "method": sim.method, "cont_form": params.cont_form,
          "resum_every": inc.RESUM_EVERY, "point": label,
          "steps_before": before, "steps": INC_STEPS,
          "ms_per_step": ms, "particle_steps_per_s": n * 1e3 / ms,
          "step_planes_ms": step_ms,
          "step_planes_particle_steps_per_s": n * 1e3 / step_ms,
          "wall_s": wall, "peak_mem_gb": peak, "launches": got,
          "carried_rho": {"min": float(rho.min()), "mean": float(rho.mean()),
                          "max": float(rho.max())},
          "max_pos_gap_to_pallas_inc": gap, **checks})
    return got


def phase_inc_kernels(torch, ft, state, params, facts):
    """The incremental path's kernels at config 4: on the planes of
    ``state`` and on a copy with numpy-seeded velocity noise that moves
    about 3% of the particles across a cell face in one step.  The
    continuity tier's force step takes the density sweep's rho as its
    carried rho (as at age 0) and is checked in every form and switch."""
    from gpufluidsimulator_torch.ops import inc, sph
    from gpufluidsimulator_torch.ops import planes as pm

    geom = pm.geometry(params)
    n = state.n
    m_cap = inc.mover_capacity(n)
    kc = geom.k * geom.cells
    plane_b = kc * 4
    results = {}
    base = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
    rng = np.random.default_rng(7)
    noisy6 = base.fields6.clone()
    live = torch.nonzero((noisy6[0] < pm.SENTINEL * 0.5).reshape(-1))[:, 0]
    noise = rng.normal(size=(3, live.numel())) * (
        0.0125 * params.cell / params.dt)
    flat_v = noisy6[3:].reshape(3, -1)
    flat_v[:, live] += torch.from_numpy(noise).to(flat_v)
    inputs = (("evolved", base.fields6), ("vel_noise", noisy6))
    inter = pm.interior_mask(geom, base.idp.device)
    touched = torch.zeros(geom.cells + 1, dtype=torch.bool,
                          device=base.idp.device)
    touched[:-1] |= inter.reshape(-1)
    touched[1:] |= inter.reshape(-1)
    starts_read = float(touched.sum())
    rows_b = geom.pz * geom.n_bx * geom.py * 4
    bounds_b = 4 * geom.nz * geom.n_bx * geom.n_by * 4
    deferred = []
    for label, fields6 in inputs:
        p6 = pm.halo_x(fields6)
        occ_q, occ_s = pm.occupancy_bounds(p6, params, geom)
        rho = pm.halo_x(sph.density_planes(p6[:3], occ_q, occ_s, params,
                                           geom))
        new6, flagp = sph.accel_step(p6, rho, occ_q, occ_s, params, geom)
        movers, m, total = inc.compact([*new6, base.idp], flagp, m_cap)
        arr = inc.arrival_planes(movers, m, params, geom)
        # the continuity tier's mover path, rho as channel 7
        new6c, rhoc, flagc = sph.accel_step_cont(p6, rho, occ_q, occ_s,
                                                 params, geom)
        chans8 = [*new6c, base.idp, rhoc]
        movers8, m8, total8 = inc.compact(chans8, flagc, m_cap)
        arr8 = inc.arrival_planes(movers8, m8, params, geom)
        m_i, total_i = int(m), int(total)
        m8_i, total8_i = int(m8), int(total8)
        check(m_i > 0 and m8_i > 0, f"config-4 kernels ({label}): no movers")
        if label == "vel_noise":
            check(total_i >= 0.01 * n, f"config-4 kernels ({label}): "
                                       f"{total_i} movers < 1%")
        pairs = stencil_pairs(torch, p6, geom)
        valid, probes_all = plane_touch(torch, p6, geom, "all")
        _, probes = plane_touch(torch, p6, geom, "sweep")
        _, probes_in = plane_touch(torch, new6, geom, "interior")
        _, probes_in8 = plane_touch(torch, new6c, geom, "interior")
        # consolidate reads the taken arrival rows that fit (m less the
        # drops) and starts[c], starts[c + 1] of each interior cell
        rows_read = m_i - int(inc.consolidate(new6, base.idp, flagp, arr,
                                              geom)[2])
        rows_read8 = m8_i - int(inc.consolidate(new6c, base.idp, flagc, arr8,
                                                geom, rhop=rhoc)[3])
        kept, kept8 = valid - total_i, valid - total8_i
        flat7 = torch.cat([new6.reshape(6, -1), base.idp.reshape(1, -1)])
        flat_flag = flagp.reshape(-1)
        cases = {
            "occ_rowmax": dict(
                kernel=lambda: pm.occ_rowmax(p6[0], geom),
                plain=lambda: pm.occ_rowmax_plain(p6[0]),
                library=lambda: torch.amax(torch.sum(
                    p6[0] < pm.SENTINEL * 0.5, dim=0, dtype=torch.int32),
                    dim=-1),
                bytes=probes_all * 4 + rows_b,
                flops=0),
            # the step's call: one occ_rowmax launch writes occ_q, occ_s
            "occupancy_bounds": dict(
                kernel=lambda: pm.occupancy_bounds(p6, params, geom),
                plain=lambda: pm.occupancy_bounds_plain(p6, params, geom),
                library=None, bytes=probes_all * 4 + bounds_b, flops=0),
            "density": dict(
                kernel=lambda: sph.density_planes(p6[:3], occ_q, occ_s,
                                                  params, geom),
                plain=lambda: sph.density_plain(p6[:3], params, geom),
                library=None, tol=1e-5,
                bytes=(probes + 2 * valid) * 4 + plane_b,
                flops=DENSITY_PAIR_FLOPS * pairs),
            "force": dict(
                kernel=lambda: sph.accel_planes(p6, rho, occ_q, occ_s,
                                                params, geom),
                plain=lambda: sph.accel_plain(p6, rho, params, geom),
                library=None, tol=1e-4,
                bytes=(probes + 6 * valid) * 4 + 3 * plane_b,
                flops=FORCE_PAIR_FLOPS * pairs),
            "force_step": dict(
                kernel=lambda: sph.accel_step(p6, rho, occ_q, occ_s, params,
                                              geom),
                plain=lambda: sph.accel_step_plain(p6, rho, params, geom),
                library=None, bytes=(probes + 6 * valid) * 4 + 7 * plane_b,
                flops=FORCE_PAIR_FLOPS * pairs),
            "force_step_cont": dict(
                kernel=lambda: sph.accel_step_cont(p6, rho, occ_q, occ_s,
                                                   params, geom),
                plain=lambda: sph.accel_step_cont_plain(p6, rho, params,
                                                        geom),
                library=None, bytes=(probes + 6 * valid) * 4 + 8 * plane_b,
                flops=FORCE_CONT_PAIR_FLOPS * pairs),
            "compact": dict(
                kernel=lambda: inc.compact([*new6, base.idp], flagp,
                                           m_cap),
                plain=lambda: inc.compact_plain([*new6, base.idp], flagp,
                                                m_cap),
                library=lambda: flat7[:, torch.nonzero(
                    flat_flag > 0.5)[:m_cap, 0]],
                bytes=plane_b + 7 * min(total_i, m_cap) * 4
                + 7 * m_cap * 4, flops=0),
            "compact_8ch": dict(
                kernel=lambda: inc.compact(chans8, flagc, m_cap),
                plain=lambda: inc.compact_plain(chans8, flagc, m_cap),
                timed=False),
            "consolidate": dict(
                kernel=lambda: inc.consolidate(new6, base.idp, flagp, arr,
                                               geom),
                plain=lambda: inc.consolidate_plain(new6, base.idp, flagp,
                                                    arr, geom),
                library=None,
                # x probes of the interior cells, the flag of each valid
                # slot, the other 6 channels of each kept one, the arrival
                # rows and sort index read, the start table entries; 7
                # planes written
                bytes=(probes_in + valid + 6 * kept + 7 * rows_read) * 4
                + rows_read * 8 + starts_read * 4 + 7 * plane_b, flops=0),
            "consolidate_rho": dict(
                kernel=lambda: inc.consolidate(new6c, base.idp, flagc, arr8,
                                               geom, rhop=rhoc),
                plain=lambda: inc.consolidate_plain(new6c, base.idp, flagc,
                                                    arr8, geom, rhoc),
                library=None,
                # as consolidate, with rho read for each kept slot and from
                # each taken mover row, and an 8th plane written
                bytes=(probes_in8 + valid + 7 * kept8 + 8 * rows_read8) * 4
                + rows_read8 * 8 + starts_read * 4 + 8 * plane_b, flops=0),
        }
        for name, c in cases.items():
            entry = {"phase": "kernel_check", "kernel": name,
                     "input": f"double_dam_break 3D ({label})"}
            if name.startswith("force_step"):
                cont = name == "force_step_cont"
                err = 0.0
                for form, kw in (CONT_CASES if cont else {"": {}}).items():
                    pf = params.replace(**kw)
                    fn = sph.accel_step_cont if cont else sph.accel_step
                    plain = (sph.accel_step_cont_plain if cont
                             else sph.accel_step_plain)
                    got = fn(p6, rho, occ_q, occ_s, pf, geom)
                    want = plain(p6, rho, pf, geom)
                    torch.cuda.synchronize()
                    e = check_force_step(torch, got, want, p6, pf, geom,
                                         f"{name} {form} ({label})")
                    err = max(err, e.pop("max_abs_err"))
                    emit({**entry, "cont_form": form or None, **kw, **e,
                          "max_abs_err": err, "movers": m_i,
                          "flagged": total_i})
                del got, want
            else:
                got, want = c["kernel"](), c["plain"]()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                if "tol" in c:
                    err, rel = rel_err(got[0], want[0])
                    check(rel <= c["tol"], f"{name} ({label}) rel err {rel} "
                                           f"> {c['tol']}")
                    entry.update(rel_err=rel, tol=c["tol"])
                else:
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    err = max(float((a.double() - b.double()).abs().max())
                              for a, b in zip(got, want))
                    check(same, f"{name} ({label}) differs from its plain "
                                f"version")
                    entry.update(exact=True, channels=int(got[0].shape[0])
                                 if name.startswith("compact") else None)
                entry["max_abs_err"] = err
                emit(entry)
                del got, want
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if label != "evolved" or not c.get("timed", True):
                continue
            shape = ("double_dam_break n=1e6 3D (1,197,770 particles), "
                     "evolved planes")
            timings(torch, name, c, shape, r, deferred)
            r["movers"] = m8_i if name.endswith("_rho") else m_i
            emit({"phase": "kernel_time", "kernel": name, "shape": shape,
                  "valid_slots": valid, "probe_slots": probes,
                  **{k: r[k] for k in TIME_KEYS + ("movers",) if k in r},
                  **(facts.get(name, {}) if name not in PREV_AT_CONFIG3
                     else {})})
        device_times(torch, deferred)
        del cases, new6, flagp, movers, arr, rho, flat7, p6
        del new6c, rhoc, flagc, chans8, movers8, arr8
        torch.cuda.empty_cache()
    return results


def support_pairs(torch, f, desc, params) -> float:
    """Covered pairs of the packed sweep inside the kernel support
    (r^2 in (1e-16, h^2)): the pairs whose coefficients it computes."""
    from gpufluidsimulator_torch.ops import mxu_sweep as mx
    qt, tile, lo, hi = mx._slots(desc)
    fq = f.reshape(-1, mx.TQ, 8)
    lane = torch.arange(mx.TC, device=f.device)
    total = 0
    for s0 in range(0, qt.numel(), 2048):
        sl = slice(s0, s0 + 2048)
        jid = tile[sl, None] * mx.TC + lane
        rng = (jid >= lo[sl, None]) & (jid < hi[sl, None])
        d = fq[qt[sl]][:, None, :, :3] - fq[tile[sl]][:, :, None, :3]
        r2 = (d * d).sum(-1)
        total += int((rng[:, :, None] & (r2 > 1e-16)
                      & (r2 < params.h * params.h)).sum())
    return float(total)


def packed_inputs(torch, state, params) -> dict:
    """The packed sweep's input on a state, from the rank planes: the
    slot-sorted positions and velocities with the density sweep's rho
    (floored at 1e-3 rest density, as accel_planes' EOS takes it) and its
    pressure (``args``), and the planes' own density and acceleration."""
    from gpufluidsimulator_torch.ops import physics, route, sph
    from gpufluidsimulator_torch.ops import planes as pm

    geom = pm.geometry(params)
    table = pm.build_planes(state.pos, state.vel, state.ids, params, geom)
    check(bool(table.ok.all()), "packed sweep: binning dropped particles")
    planes = table.planes
    occ_q, occ_s = pm.occupancy_bounds(planes, params, geom)
    rho_p = pm.halo_x(sph.density_planes(planes[:3], occ_q, occ_s, params,
                                         geom))
    acc_p = sph.accel_planes(planes, rho_p, occ_q, occ_s, params, geom)
    per = route.gather(torch.cat([acc_p, rho_p[None]]).contiguous(),
                       table.slot)
    rho = torch.clamp_min(per[:, 3], 1e-3 * params.rest_density)
    return dict(geom=geom, planes=planes, occ_q=occ_q, occ_s=occ_s,
                rho_p=rho_p, acc_planes=per[:, :3],
                args=(table.pos_s, table.vel_s, rho,
                      physics.eos_pressure(rho, params)))


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


def phase_packed_sweep(torch, ft, ft_build, state, params, facts):
    """The packed-pair sweep on the evolved config-4 state: accel_mxu with
    the counts zeroed, the kernel against its plain version, the padding
    accounting, the kernel's time and bound, and the rank-plane
    accel_planes (plain force) on the same positions, velocities and rho,
    timed and held particle by particle.  Returns (kernel entry, launches)."""
    from gpufluidsimulator_torch.ops import grid, mxu_sweep, sph

    inp = packed_inputs(torch, state, params)
    geom, planes, rho_p = inp["geom"], inp["planes"], inp["rho_p"]
    occ_q, occ_s, args = inp["occ_q"], inp["occ_s"], inp["args"]
    n = state.n

    torch.cuda.synchronize()
    ft_build.reset_launches()
    acc = mxu_sweep.accel_mxu(*args, params)
    torch.cuda.synchronize()
    counts = dict(ft_build.launches)
    want = dict.fromkeys(counts, 0)
    want["sweep_packed"] = 1
    check(counts == want, f"accel_mxu launches {counts}")
    # both in slot-sorted order; accel_planes has no gravity either.  The
    # largest |a| (a close pair) sets the scale: 1e-6 of it still fails a
    # dropped viscosity term or a dropped neighbour range
    err_p, rel_p = rel_err(acc, inp["acc_planes"])
    check(rel_p <= 1e-6, f"accel_mxu vs accel_planes: rel {rel_p}")
    norm = torch.linalg.vector_norm
    rms_p = float(norm((acc - inp["acc_planes"]).double())
                  / norm(inp["acc_planes"].double()))

    f, cids, _ = mxu_sweep.pack(*args, params)
    desc = mxu_sweep.build_desc(cids, f.shape[0], params)
    got = mxu_sweep.sweep_packed(f, cids, desc, params)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want_f = mxu_sweep.sweep_packed_plain(f, cids, desc, params)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    err, rel = rel_err(got, want_f)
    check(rel <= 1e-5, f"sweep_packed rel err {rel} > 1e-5")
    emit({"phase": "kernel_check", "kernel": "sweep_packed",
          "input": "double_dam_break 3D (evolved), packed",
          "max_abs_err": err, "rel_err": rel, "tol": 1e-5})

    cids_np = cids.cpu().numpy()
    stats = mxu_sweep.table_stats(cids_np, f.shape[0], params)
    hist = np.bincount(cids_np, minlength=grid.num_padded_cells(params))
    ideal = int(sum(hist[cids_np + o].sum()
                    for o in grid.neighbor_offsets(params)))
    support = support_pairs(torch, f, desc, params)
    evaluated, tested = evaluated_pairs(torch, f, cids, desc, params)
    check(evaluated <= 0.4 * stats["covered_pairs"],
          f"sweep_packed evaluates {evaluated} pairs, over 40% of the "
          f"{stats['covered_pairs']} its tiles' ranges cover")
    stats.update(candidate_pair_ideal=ideal, support_pairs=support,
                 evaluated_pairs=evaluated, tested_pairs=tested,
                 pad_eval_vs_ideal=stats["eval_pairs"] / ideal,
                 pad_covered_vs_ideal=stats["covered_pairs"] / ideal,
                 evaluated_vs_ideal=evaluated / ideal,
                 evaluated_vs_covered=evaluated / stats["covered_pairs"])
    emit({"phase": "packed_table", **stats})

    q = f.shape[0] // mxu_sweep.TQ
    c = dict(bytes=f.numel() * 4 + n * 4 + q * 8 * 4 + f.shape[0] * 3 * 4,
             flops=PACKED_PAIR_FLOPS * ideal + PACKED_SUPPORT_FLOPS * support)
    r = dict(max_abs_err=err,
             ms=time_ms(torch, lambda: mxu_sweep.sweep_packed(
                 f, cids, desc, params), REPS),
             plain_ms=plain_ms, library_ms=None, **bounds(c))
    emit({"phase": "kernel_time", "kernel": "sweep_packed",
          "shape": f"double_dam_break n=1e6 3D ({n:,} particles), evolved, "
                   f"packed: Npad {f.shape[0]}, Q {q}",
          "candidate_pairs": ideal, "covered_pairs": stats["covered_pairs"],
          "evaluated_pairs": evaluated, "tested_pairs": tested,
          "support_pairs": support,
          **facts["sweep_packed"],
          "gflops_useful": c["flops"] / r["ms"] / 1e6,
          "gflops_issued": (PACKED_BOX_FLOPS * evaluated / mxu_sweep.GROUP
                            + PACKED_PAIR_FLOPS * tested
                            + PACKED_SUPPORT_FLOPS * support) / r["ms"] / 1e6,
          **{k: r[k] for k in TIME_KEYS}})
    emit({"phase": "packed_vs_planes", "particles": n,
          "accel_mxu_ms": time_ms(torch, lambda: mxu_sweep.accel_mxu(
              *args, params), 5),
          "pack_ms": time_ms(torch, lambda: mxu_sweep.pack(*args, params),
                             5),
          "build_desc_ms": time_ms(torch, lambda: mxu_sweep.build_desc(
              cids, f.shape[0], params), 5),
          "sweep_packed_ms": r["ms"],
          "accel_planes_ms": time_ms(torch, lambda: sph.accel_planes(
              planes, rho_p, occ_q, occ_s, params, geom), REPS),
          "max_abs_err": err_p, "rel_err": rel_p, "tol": 1e-6,
          "rms_rel_err": rms_p,
          "gravity": "in neither"})
    return r, counts


# the continuity forms and switches the on-card checks cover
CONT_CASES = {"rate": dict(cont_form="rate"),
              "relax": dict(cont_form="relax"),
              "sum": dict(cont_form="sum"),
              "alpha": dict(cont_form="rate", cont_alpha=0.1),
              "delta": dict(cont_form="rate", cont_delta=0.1),
              "beta0": dict(cont_form="rate", cont_beta=0.0)}


def check_force_step(torch, got, want, p6, params, geom, what):
    """A fused force step (new6, flag) or continuity step (new6, rho, flag)
    against its plain version: positions 1e-6 and velocities 1e-4
    (relative), rho 1e-5, every other slot equal, and mover flags equal
    except within 1e-5 cell of a face."""
    from gpufluidsimulator_torch.ops import planes as pm
    (g6, *grho, gf), (w6, *wrho, wf) = got, want
    ok = (p6[0] < pm.SENTINEL * 0.5) \
        & pm.interior_mask(geom, p6.device)[None]
    _, rel_p = rel_err(g6[:3, ok], w6[:3, ok])
    _, rel_v = rel_err(g6[3:, ok], w6[3:, ok])
    err = float((g6[:, ok] - w6[:, ok]).abs().max())
    near = torch.zeros_like(ok)
    for d in range(3):
        for q in (g6[d], w6[d]):
            u = (q.double() - params.bounds_min[d]) / params.cells_axis[d]
            near |= (u - torch.round(u)).abs() < 1e-5
    differ = (gf != wf) & ok
    bad = int((differ & ~near).sum())
    rest_equal = torch.equal(g6[:, ~ok], w6[:, ~ok])
    out = dict(rel_err_pos=rel_p, rel_err_vel=rel_v,
               tol={"pos": 1e-6, "vel": 1e-4},
               flags_differ_near_face=int(differ.sum()))
    rel_r = 0.0
    if grho:
        err_r, rel_r = rel_err(grho[0][ok], wrho[0][ok])
        err = max(err, err_r)
        rest_equal &= torch.equal(grho[0][~ok], wrho[0][~ok])
        out.update(rel_err_rho=rel_r, tol={"pos": 1e-6, "vel": 1e-4,
                                           "rho": 1e-5})
    check(rel_p <= 1e-6 and rel_v <= 1e-4 and rel_r <= 1e-5 and bad == 0
          and rest_equal,
          f"{what}: pos rel {rel_p}, vel rel {rel_v}, rho rel {rel_r}, "
          f"{bad} flags differ away from a face, other slots equal "
          f"{rest_equal}")
    out["max_abs_err"] = err
    return out


# the tools phase: the CLI run at config 4 (two report intervals), the
# steps after each resume, and how far bench's time of step_planes may lie
# from the run_inc phase's
TOOLS_STEPS = 200
TOOLS_REPORT = 100
TOOLS_RESUME = 100
BENCH_FACTOR = 1.25
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def cli_call(argv):
    """``cli.main(argv)`` with its standard output captured: (rc, lines)."""
    import contextlib
    import io
    from gpufluidsimulator_torch.utils import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def last_json(lines) -> dict:
    found = [ln for ln in lines if ln.startswith("{")]
    check(bool(found), f"no JSON line in {lines[-3:]}")
    return json.loads(found[-1])


def same_state(torch, a, b) -> bool:
    """Every field of two NamedTuple states equal: tensors bitwise, host
    values (an IncState's age, a missing rhop) by ==."""
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b))


def is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG_MAGIC


def tools_run(torch, ft_build, tmp, scene4):
    """``python -m gpufluidsimulator_torch run`` in-process at config 4,
    with frames, checkpoints and the metrics JSON; returns the states that
    ``checkpoint.rotate`` was handed, by step."""
    import os
    from gpufluidsimulator_torch.utils import checkpoint

    ckdir, frdir = os.path.join(tmp, "ckpts"), os.path.join(tmp, "frames")
    mj = os.path.join(tmp, "metrics.json")
    saved = {}
    rotate = checkpoint.rotate

    def keep(directory, state, params, step, keep=3):
        saved[step] = (state, params)
        return rotate(directory, state, params, step, keep)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft_build.reset_launches()
    checkpoint.rotate = keep
    w0 = time.perf_counter()
    try:
        rc, lines = cli_call(
            ["run", *scene4, "--method", "auto", "--steps", str(TOOLS_STEPS),
             "--report-every", str(TOOLS_REPORT), "--checkpoint-dir", ckdir,
             "--frames-dir", frdir, "--width", "512", "--height", "512",
             "--metrics-json", mj])
    finally:
        checkpoint.rotate = rotate
    wall = time.perf_counter() - w0
    got = dict(ft_build.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(rc == 0, f"cli run: rc {rc}: {lines[-3:]}")
    final = last_json(lines)
    check(final["overflow"] == 0 and not final["nan"],
          f"cli run: final invariants {final}")
    frames = sorted(os.listdir(frdir))
    ckpts = sorted(os.listdir(ckdir))
    check(len(frames) == TOOLS_STEPS // TOOLS_REPORT
          and all(is_png(os.path.join(frdir, f)) for f in frames),
          f"cli run: frames {frames}")
    check(len(ckpts) >= 1, "cli run: no checkpoint")
    # FluidSim(method="auto") runs each report interval on pallas_inc; its
    # conversion back to a flat state with diagnostics on (the CLI's
    # scenes) sums the density once more
    chunks = TOOLS_STEPS // TOOLS_REPORT
    want = dict.fromkeys(got, 0)
    want.update(occ_rowmax=TOOLS_STEPS + chunks,
                density=TOOLS_STEPS + chunks,
                force_step=TOOLS_STEPS, consolidate=TOOLS_STEPS,
                compact=TOOLS_STEPS + chunks, place=chunks)
    check(got == want, f"cli run: launches {got}, expected {want}")
    with open(mj) as f:
        m = json.load(f)
    emit({"phase": "tools", "step": "cli_run",
          "scene": "double_dam_break_3d_1197770", "header": lines[0],
          "particles": m["n_particles"], "steps": m["steps"],
          "particle_steps_per_s": m["mean_particle_steps_per_sec"],
          "samples": [{k: smp[k] for k in ("step", "ms_per_frame",
                                           "particle_steps_per_sec")}
                      for smp in m["samples"]],
          "wall_s": wall, "peak_mem_gb": peak, "launches": got,
          "frames": frames, "checkpoints": ckpts,
          "checkpoint_mb": os.path.getsize(os.path.join(ckdir, ckpts[-1]))
          / 1e6, "final": final})
    return saved, os.path.join(ckdir, ckpts[-1])


def tools_resume(torch, ft, tmp, scene4, latest, saved):
    """The CLI resumes the latest checkpoint; in the API, pallas_inc from
    the loaded file and from the state that was saved agree bitwise, and
    so does pallas_inc_cont across a save_planes / load_planes in the
    middle of a step_planes loop (saved at age 30, 50 steps more: the
    re-sum at age 64 among them)."""
    import os
    from gpufluidsimulator_torch.ops import inc
    from gpufluidsimulator_torch.ops import planes as pm
    from gpufluidsimulator_torch.utils import checkpoint

    rc, lines = cli_call(["run", "--resume", latest, *scene4[:2],
                          "--method", "auto", "--steps", str(TOOLS_RESUME),
                          "--report-every", str(TOOLS_RESUME)])
    check(rc == 0 and lines[0].startswith("resumed from"),
          f"cli resume: rc {rc}: {lines[:2]}")
    final = last_json(lines)
    check(final["overflow"] == 0 and not final["nan"],
          f"cli resume: final invariants {final}")

    loaded, params, step = checkpoint.load(latest)
    mem, params_mem = saved[step]
    check(params == params_mem and same_state(torch, loaded, mem),
          "checkpoint.load differs from the state saved")
    a = ft.FluidSim(params, loaded, method="pallas_inc")
    b = ft.FluidSim(params_mem, mem, method="pallas_inc")
    a.step(TOOLS_RESUME)
    b.step(TOOLS_RESUME)
    flat_equal = same_state(torch, a.state, b.state)
    check(flat_equal, "pallas_inc from the loaded checkpoint differs from "
                      "the run from the state saved")
    del a, b

    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(loaded.n)
    s = inc.to_planes(loaded.pos, loaded.vel, loaded.ids, params, geom,
                      continuity=True)
    for _ in range(30):
        s = inc.step_planes(s, params, geom, m_cap)
    path = os.path.join(tmp, "planes.npz")
    w0 = time.perf_counter()
    checkpoint.save_planes(path, s, params, step=step + 30, n=loaded.n)
    save_s = time.perf_counter() - w0
    w0 = time.perf_counter()
    r, params_r, step_r, n_r = checkpoint.load_planes(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - w0
    check(same_state(torch, r, s) and params_r == params
          and (step_r, n_r) == (step + 30, loaded.n),
          "load_planes differs from the IncState saved")
    for _ in range(50):
        s = inc.step_planes(s, params, geom, m_cap)
        r = inc.step_planes(r, params_r, geom, m_cap)
    check(s.age == 80 and same_state(torch, s, r),
          "pallas_inc_cont from load_planes differs from the uninterrupted "
          "run")
    emit({"phase": "tools", "step": "resume", "checkpoint_step": step,
          "cli_resume_final": final, "pallas_inc_steps": TOOLS_RESUME,
          "pallas_inc_bitwise": flat_equal,
          "planes_saved_at_age": 30, "planes_steps_after": 50,
          "resum_ages_crossed": [64], "planes_bitwise": True,
          "planes_mb": os.path.getsize(path) / 1e6,
          "save_planes_s": save_s, "load_planes_s": load_s})


def tools_bench(scene4, step_planes_ms):
    """bench at config 4 on both tiers and scripts/torch_bench.py; bench's
    ms_per_frame on pallas_inc and torch_bench's rates against the
    step_planes times of the run_inc phase."""
    import contextlib
    import importlib.util
    import io
    from pathlib import Path

    lines = {}
    for method in ("pallas_inc", "pallas_inc_cont"):
        rc, out = cli_call(["bench", *scene4, "--method", method])
        check(rc == 0, f"cli bench {method}: rc {rc}")
        lines[method] = last_json(out)
    spec = importlib.util.spec_from_file_location(
        "torch_bench", Path(__file__).resolve().parent / "scripts"
        / "torch_bench.py")
    tb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tb)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tb.main()
    check(rc == 0, f"torch_bench: rc {rc}")
    tb_line = last_json(buf.getvalue().splitlines())
    n = tb_line["particles"]
    ratio = lines["pallas_inc"]["ms_per_frame"] / step_planes_ms["early"]
    check(1 / BENCH_FACTOR <= ratio <= BENCH_FACTOR,
          f"bench ms_per_frame {lines['pallas_inc']['ms_per_frame']} vs "
          f"run_inc step_planes_ms {step_planes_ms['early']}: ratio {ratio}")
    tb_ratio = {}
    for point in ("early", "evolved"):
        ms = n * 1e3 / tb_line["operating_points"][point]["value"]
        tb_ratio[point] = ms / step_planes_ms[point]
        check(1 / BENCH_FACTOR <= tb_ratio[point] <= BENCH_FACTOR,
              f"torch_bench {point} {ms} ms vs run_inc step_planes_ms "
              f"{step_planes_ms[point]}: ratio {tb_ratio[point]}")
    emit({"phase": "tools", "step": "bench", "card": card_line(),
          "bench": lines, "torch_bench": tb_line,
          "run_inc_step_planes_ms": step_planes_ms,
          "bench_pallas_inc_vs_step_planes_early": ratio,
          "torch_bench_vs_step_planes": tb_ratio, "factor": BENCH_FACTOR})


def tools_render(torch, tmp, latest, state, params):
    """The evolved config-4 state rendered twice on the card (equal PNG
    bytes) and once on the CPU (framebuffers within 1e-5 of their
    maximum, images within one level); the CLI renders a checkpoint.
    Also times one render_frame (CUDA events), one save_frame and one
    metrics.invariants (host clock): a CLI report interval's extras."""
    import os
    from gpufluidsimulator_torch.ops import render
    from gpufluidsimulator_torch.utils import metrics

    a, b = os.path.join(tmp, "a.png"), os.path.join(tmp, "b.png")
    w0 = time.perf_counter()
    render.save_frame(a, state, params)
    save_s = time.perf_counter() - w0
    render.save_frame(b, state, params)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        check(fa.read() == fb.read(), "two renders of one state differ")
    card = render.render_frame(state, params)
    cpu = render.render_frame(state.to("cpu"), params)
    # printed, not gated: the gates are the tolerances below
    bitwise = torch.equal(card.cpu(), cpu)
    err = float((card.cpu() - cpu).abs().max())
    scale = float(cpu.abs().max())
    check(err <= 1e-5 * scale, f"render card vs cpu: {err} of {scale}")
    levels = int(np.abs(render.tonemap(card).astype(np.int64)
                        - render.tonemap(cpu)).max())
    check(levels <= 1, f"tonemapped card vs cpu differ by {levels} levels")
    ms = time_ms(torch, lambda: render.render_frame(state, params), 10)
    w0 = time.perf_counter()
    metrics.invariants(state, params)
    invariants_s = time.perf_counter() - w0
    out = os.path.join(tmp, "ckpt.png")
    rc, lines = cli_call(["render", latest, "-o", out])
    check(rc == 0 and is_png(out), f"cli render: rc {rc}: {lines}")
    emit({"phase": "tools", "step": "render", "particles": state.n,
          "width": 512, "height": 512, "png_bytes_equal": True,
          "card_vs_cpu_bitwise": bitwise,
          "card_vs_cpu_max_abs": err, "card_vs_cpu_rel": err / scale,
          "tol": 1e-5, "tonemap_max_level_diff": levels,
          "render_frame_ms": ms, "save_frame_s": save_s,
          "invariants_s": invariants_s,
          "cli_render": lines[-1]})


def tools_checks(torch, ft, state, params):
    """debug.assert_deterministic on the three step paths (config 3
    pallas, config 4 pallas_inc and pallas_inc_cont, the latter across a
    re-sum); checked_step on a planted NaN and a forced overflow."""
    from gpufluidsimulator_torch.utils import debug

    p3, s3 = ft.scenes.dam_break(n=262144, dim=3)
    runs = ((p3, s3, 20, "pallas"), (params, state, 50, "pallas_inc"),
            (params, state, 70, "pallas_inc_cont"))
    done = []
    for p, s, steps, method in runs:
        w0 = time.perf_counter()
        try:
            debug.assert_deterministic(p, s, steps, method)
        except AssertionError as err:
            check(False, f"assert_deterministic: {err}")
        done.append({"method": method, "particles": s.n, "steps": steps,
                     "seconds": time.perf_counter() - w0})
    del p3, s3
    pn, sn = ft.scenes.dam_break(n=2000, dim=2)
    clean = debug.checked_step(pn, "pallas")(sn)
    check(int(clean.overflow) == 0, "checked_step: clean step overflowed")
    bad = sn.pos.clone()
    bad[7, 0] = float("nan")
    raised = {}
    for what, call in (
            ("nan", lambda: debug.checked_step(pn, "naive")(
                sn._replace(pos=bad))),
            ("overflow", lambda: debug.checked_step(
                pn.replace(cell_capacity=1), "pallas")(sn))):
        try:
            call()
        except RuntimeError as err:
            raised[what] = str(err)
    check("non-finite" in raised.get("nan", ""),
          f"checked_step let a NaN pass: {raised}")
    check("overflow" in raised.get("overflow", ""),
          f"checked_step let an overflow pass: {raised}")
    emit({"phase": "tools", "step": "checks", "deterministic": done,
          "checked_step": raised})


def tools_native(ft):
    """FluidSim(method="native") against the port's naive run on the card,
    and bench --method native."""
    p, s = ft.scenes.dam_break(n=300, dim=2, jitter=0.2, seed=7)
    w0 = time.perf_counter()
    nat = ft.FluidSim(p, s, method="native")
    build_s = time.perf_counter() - w0
    nat.step(15)
    nai = ft.FluidSim(p, s, method="naive")
    nai.step(15)
    check(nat.state.pos.device.type == "cuda"
          and nat.state.pos.dtype == nai.state.pos.dtype,
          f"native state on {nat.state.pos.device}, {nat.state.pos.dtype}")
    gap = float(np.abs(nat.get_positions() - nai.get_positions()).max())
    check(gap <= 1e-5, f"native vs naive after 15 steps: {gap}")
    rc, lines = cli_call(["bench", "-n", "65536", "--dim", "2",
                          "--method", "native"])
    check(rc == 0, f"cli bench native: rc {rc}")
    emit({"phase": "tools", "step": "native", "particles": s.n,
          "steps": 15, "max_pos_gap_to_naive": gap, "tol": 1e-5,
          "first_use_s": build_s, "bench": last_json(lines)})


def phase_tools(torch, ft, ft_build, state, params, step_planes_ms):
    """The user-facing entry points on the card: the CLI's run, resume,
    bench and render, checkpoints, the renderer, scripts/torch_bench.py,
    the debug harness and the native engine.  ``state`` is the evolved
    config-4 state, ``params`` its parameters, ``step_planes_ms`` the
    run_inc phase's times of step_planes by operating point."""
    import tempfile

    t0 = time.perf_counter()
    scene4 = ["--scene", "double_dam_break", "-n", "1000000", "--dim", "3"]
    ran = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools-") as tmp:
        saved, latest = tools_run(torch, ft_build, tmp, scene4)
        ran.append("cli_run")
        tools_resume(torch, ft, tmp, scene4, latest, saved)
        del saved
        ran.append("resume")
        tools_bench(scene4, step_planes_ms)
        ran.append("bench")
        tools_render(torch, tmp, latest, state, params)
        ran.append("render")
    tools_checks(torch, ft, state, params)
    ran.append("checks")
    tools_native(ft)
    ran.append("native")
    emit({"phase": "tools", "ran": ran,
          "seconds": time.perf_counter() - t0})


# the sharded phases: config 4 on 4 slabs of the card against the same
# state unsharded; config 5 on 8 slabs (the v5e-8's layout) and on 1
SHARD_PARITY = {"pallas_inc": 10, "pallas_inc_cont": 10, "pallas": 5}
SHARD_TOL = 1e-5              # tests/test_sharded_smoke.py's bar
SHARD_RUN_STEPS = 100
SHARD_RUN_SLABS = (8, 1)


def cuda_mesh(torch, n):
    from gpufluidsimulator_torch.parallel import mesh as meshmod
    return meshmod.make_mesh(devices=[torch.device("cuda", 0)] * n)


def sharded_state4(torch, ft):
    """Config 4 on the card, diagnostics off, with particles 0 and 1 made
    crossers of the slab 0/1 face of a 4-slab mesh: above the left column,
    0.4 cell from the face, flying toward it at 0.25 cell a step, one from
    each side (tests/test_sharded.py:211-247)."""
    from gpufluidsimulator_torch.parallel import sharded
    params, state = ft.scenes.double_dam_break(n=1_000_000, dim=3,
                                               device="cuda")
    params = params.replace(diagnostics=False)
    _, nxl = sharded.local_params(params, 4)
    xb = params.bounds_min[0] + nxl * params.cell
    v = 0.25 * params.cell / params.dt
    pos = state.pos.clone()
    vel = state.vel.clone()
    pos[0] = torch.tensor([xb - 0.4 * params.cell, 0.86, 0.3])
    vel[0] = torch.tensor([v, 0.0, 0.0])
    pos[1] = torch.tensor([xb + 0.4 * params.cell, 0.95, 0.3])
    vel[1] = torch.tensor([-v, 0.0, 0.0])
    return params, ft.make_state(pos, vel, device="cuda")


def shard_counters(sstate) -> tuple:
    return (sum(int(o) for o in sstate.overflow),
            sum(int(o) for o in sstate.mig_overflow))


def slab_holds(torch, sstate, d, pid) -> bool:
    return bool((sstate.ids[d] == pid).any())


def phase_sharded_parity(torch, ft, ft_build):
    """Config 4 (+ two crossers) on a 4-slab mesh of the card against the
    same state unsharded: 10 steps of pallas_inc and pallas_inc_cont, 5 of
    pallas; positions by id within SHARD_TOL, ids conserved, both counters
    0, the crossers on their neighbour slab.  Then one sharded pallas_inc
    step under sync debug mode "error"."""
    from gpufluidsimulator_torch.ops import inc
    from gpufluidsimulator_torch.ops import planes as pm
    from gpufluidsimulator_torch.parallel import mesh as meshmod
    from gpufluidsimulator_torch.parallel import sharded

    t0 = time.perf_counter()
    params, state = sharded_state4(torch, ft)
    n = state.n
    mesh = cuda_mesh(torch, 4)
    for method, steps in SHARD_PARITY.items():
        want = positions_by_id(ft.run(state, params, steps, method=method))
        sim = sharded.ShardedSim(params, state, mesh=mesh, method=method)
        check(slab_holds(torch, sim.sstate, 0, 0)
              and slab_holds(torch, sim.sstate, 1, 1),
              f"sharded {method}: the crossers start on slabs 0 and 1")
        ft_build.reset_launches()
        sim.step(steps)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ft_build.launches.items() if v}
        crossed = (slab_holds(torch, sim.sstate, 1, 0)
                   and slab_holds(torch, sim.sstate, 0, 1))
        g = sim.gather()               # raises unless n ids are live
        ids_ok = torch.equal(g.ids.long(), torch.arange(n, device="cuda"))
        err = float((g.pos - want).abs().max())
        ovf, mig = shard_counters(sim.sstate)
        emit({"phase": "sharded_parity", "method": method, "slabs": 4,
              "particles": n, "steps": steps, "max_abs_err_pos": err,
              "tol": SHARD_TOL, "ids_conserved": ids_ok, "overflow": ovf,
              "mig_overflow": mig, "crossers_migrated": crossed,
              "slab_counts": [int((i >= 0).sum()) for i in
                              sim.sstate.ids],
              "launches": counts})
        check(err <= SHARD_TOL and ids_ok and ovf == 0 and mig == 0
              and crossed,
              f"sharded {method}: pos err {err}, ids {ids_ok}, overflow "
              f"{ovf}, mig_overflow {mig}, crossers migrated {crossed}")
        del sim, g, want
    # one sharded pallas_inc step with no wait for the card
    sstate, _ = sharded.distribute(params, state, mesh)
    params_loc, nxl = sharded.local_params(params, 4)
    geom = pm.geometry(params_loc)
    n_cap = sstate.pos[0].shape[0]
    ex = sharded.make_exchange(mesh, nxl)
    x0 = {d: sharded.slab_origin(params, nxl, d) for d in range(4)}
    states = {d: inc.to_planes(sstate.pos[d], sstate.vel[d], sstate.ids[d],
                               params_loc, geom, x_origin=x0[d],
                               active=sstate.ids[d] >= 0)
              for d in range(4)}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        meshmod.lockstep({d: inc.step_phases(
            states[d], params_loc, geom, inc.mover_capacity(n_cap),
            x_origin=x0[d], exchange=ex, wall_params=params,
            mig_cap=max(128, n_cap // 64)) for d in range(4)})
    except RuntimeError as err:
        check(False, f"the sharded step waited for the card: {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit({"phase": "sharded_sync", "slabs": 4, "method": "pallas_inc",
          "sync_debug": "error", "waited": False,
          "seconds": time.perf_counter() - t0})
    return params, state


def phase_slab_force(torch, ft, params, state):
    """force_step and force_step_cont on the planes of slabs 2 (inner) and
    3 (the right wall's) of a 4-slab mesh, whose x origin is not
    bounds_min[0], with the global walls, ghost lanes from the neighbours:
    against accel_step_plain / accel_step_cont_plain on the same inputs,
    at check_force_step's tolerances.  The velocities get numpy-seeded
    noise of 0.3 cell a step, so particles leave their cells, the slab
    (slab 3's left face cuts the right column) and the right wall."""
    from gpufluidsimulator_torch.ops import inc, sph
    from gpufluidsimulator_torch.ops import planes as pm
    from gpufluidsimulator_torch.parallel import sharded

    rng = np.random.default_rng(7)
    noise = rng.normal(size=tuple(state.vel.shape)).astype(np.float32)
    state = state._replace(vel=state.vel + torch.from_numpy(noise).cuda()
                           * (0.3 * params.cell / params.dt))
    mesh = cuda_mesh(torch, 4)
    sstate, _ = sharded.distribute(params, state, mesh)
    params_loc, nxl = sharded.local_params(params, 4)
    geom = pm.geometry(params_loc)
    ex = sharded.make_exchange(mesh, nxl)
    x0 = {d: sharded.slab_origin(params, nxl, d) for d in range(4)}
    p6 = ex({d: pm.halo_x(inc.to_planes(
        sstate.pos[d], sstate.vel[d], sstate.ids[d], params_loc, geom,
        x_origin=x0[d], active=sstate.ids[d] >= 0).fields6)
        for d in range(4)}, 3)
    occ = {d: pm.occupancy_bounds(p6[d], params_loc, geom) for d in p6}
    rho = ex({d: pm.halo_x(sph.density_planes(p6[d][:3], *occ[d],
                                              params_loc, geom))[None]
              for d in p6}, 0)
    for d in (2, 3):
        args = (p6[d], rho[d][0])
        kw = dict(x_origin=x0[d], wall_params=params)
        for name, kern, plain in (
                ("force_step", sph.accel_step, sph.accel_step_plain),
                ("force_step_cont", sph.accel_step_cont,
                 sph.accel_step_cont_plain)):
            got = kern(*args, *occ[d], params_loc, geom, **kw)
            want = plain(*args, params_loc, geom, **kw)
            r = check_force_step(torch, got, want, p6[d], params_loc, geom,
                                 f"{name} on slab {d}")
            flag = got[-1] > 0.5
            x = got[0][0]
            x1 = x0[d] + sharded.slab_width(params, nxl)
            emit({"phase": "slab_force", "kernel": name, "slab": d,
                  "x_origin": x0[d], "slab_end": x1,
                  "walls_x": [params.bounds_min[0], params.bounds_max[0]],
                  "movers": int(flag.sum()),
                  "slab_leavers": int((flag & ((x < x0[d]) | (x >= x1)))
                                      .sum()),
                  **r})
    del p6, rho, occ


class ExchangeClock:
    """``parallel.mesh.lockstep`` with each exchange timed: CUDA events
    around every exchange and every whole step (device time, as the card
    ran them) and the host's time inside the exchange calls."""

    def __init__(self, torch):
        self.torch = torch
        self.steps = []
        self.exchanges = []
        self.host_s = 0.0

    def lockstep(self, steps):
        from gpufluidsimulator_torch.parallel import mesh as meshmod
        torch = self.torch
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()

        def timed(exchange):
            def run(payloads):
                e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                h = time.perf_counter()
                e[0].record()
                out = exchange(payloads)
                e[1].record()
                self.host_s += time.perf_counter() - h
                self.exchanges.append(e)
                return out
            return run

        wrapped = {d: wrap_exchanges(g, timed) for d, g in steps.items()}
        out = meshmod.lockstep(wrapped)
        ev[1].record()
        self.steps.append(ev)
        return out

    def totals(self):
        """(step ms summed, exchange ms summed)."""
        self.torch.cuda.synchronize()
        return (sum(a.elapsed_time(b) for a, b in self.steps),
                sum(a.elapsed_time(b) for a, b in self.exchanges))


def wrap_exchanges(gen, timed):
    """A step generator whose exchanges go through ``timed`` (lockstep
    calls the first slab's, once for all slabs)."""
    try:
        msg = next(gen)
        while True:
            exchange, payload = msg
            msg = gen.send((yield timed(exchange), payload))
    except StopIteration as stop:
        return stop.value


def phase_sharded_run(torch, ft, ft_build):
    """Config 5 (scripts/bench_configs.py:36-37) on 8 slabs of the card and
    on 1: 100 steps of pallas_inc and of pallas_inc_cont, timed by CUDA
    events around the steps (the conversions to and from planes excluded),
    the exchanges' share of that time, peak memory, slab counts, both
    counters 0, ids conserved, and the two meshes' positions within
    SHARD_TOL of each other by id.  Returns the 8-slab launch counts per
    step of each method."""
    from gpufluidsimulator_torch.parallel import sharded

    t0 = time.perf_counter()
    params, state = ft.scenes.double_dam_break(n=4_000_000, dim=3,
                                               device="cuda")
    params = params.replace(diagnostics=False)
    n = state.n
    per_step = {}
    ms_by = {}
    first_pos = {}           # method -> the first mesh's gathered positions
    real_lockstep = sharded.lockstep
    for n_slabs in SHARD_RUN_SLABS:
        mesh = cuda_mesh(torch, n_slabs)
        sstate, _ = sharded.distribute(params, state, mesh)
        slab_counts = [int((i >= 0).sum()) for i in sstate.ids]
        for method in ("pallas_inc", "pallas_inc_cont"):
            cont = method == "pallas_inc_cont"
            sharded.run_sharded_inc(sstate, params, mesh, 2,
                                    continuity=cont)   # first touch
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ft_build.reset_launches()
            clock = ExchangeClock(torch)
            sharded.lockstep = clock.lockstep
            w0 = time.perf_counter()
            try:
                out = sharded.run_sharded_inc(sstate, params, mesh,
                                              SHARD_RUN_STEPS,
                                              continuity=cont)
            finally:
                sharded.lockstep = real_lockstep
            step_ms, ex_ms = clock.totals()
            wall = time.perf_counter() - w0
            counts = dict(ft_build.launches)
            peak = torch.cuda.max_memory_allocated() / 1e9
            ovf, mig = shard_counters(out)
            g = sharded.gather(out, n)
            ids_ok = torch.equal(g.ids.long(),
                                 torch.arange(n, device="cuda"))
            # gather orders by id: the meshes' positions line up row by
            # row (kept on the host, out of the next run's peak memory)
            if method in first_pos:
                pos_err = float((g.pos.cpu() - first_pos.pop(method))
                                .abs().max())
            else:
                first_pos[method] = g.pos.cpu()
                pos_err = None
            ms = step_ms / SHARD_RUN_STEPS
            ms_by[(n_slabs, method)] = ms
            if n_slabs == 8:
                per_step[method] = {k: v / SHARD_RUN_STEPS
                                    for k, v in counts.items()}
            emit({"phase": "sharded_run", "scene":
                  "double_dam_break_3d_4825800", "method": method,
                  "slabs": n_slabs, "particles": n,
                  "steps": SHARD_RUN_STEPS, "ms_per_step": ms,
                  "particle_steps_per_s": n * 1e3 / ms,
                  "exchange_ms_per_step": ex_ms / SHARD_RUN_STEPS,
                  "exchange_share": ex_ms / step_ms,
                  "exchange_host_s": clock.host_s, "wall_s": wall,
                  "peak_mem_gb": peak, "slab_counts": slab_counts,
                  "n_cap": int(sstate.pos[0].shape[0]),
                  "overflow": ovf, "mig_overflow": mig,
                  "ids_conserved": ids_ok,
                  "max_abs_err_pos_vs_" + str(SHARD_RUN_SLABS[0]): pos_err,
                  "tol": SHARD_TOL, "launches": counts})
            check(ovf == 0 and mig == 0 and ids_ok
                  and (pos_err is None or pos_err <= SHARD_TOL),
                  f"sharded_run {method} x{n_slabs}: overflow {ovf}, "
                  f"mig_overflow {mig}, ids conserved {ids_ok}, positions "
                  f"{pos_err} from x{SHARD_RUN_SLABS[0]}")
            del out, g
        del sstate
    for method in ("pallas_inc", "pallas_inc_cont"):
        emit({"phase": "sharded_cost", "method": method,
              "ms_per_step_8": ms_by[(8, method)],
              "ms_per_step_1": ms_by[(1, method)],
              "ratio": ms_by[(8, method)] / ms_by[(1, method)],
              "seconds": time.perf_counter() - t0})
    return per_step


def phase_sharded_tools(torch, ft):
    """``run --sharded`` through the CLI at small scale on the card (one
    slab per visible card), and save_sharded / load_sharded in the middle
    of a 4-slab run_sharded, resumed bitwise against the uninterrupted run
    (tests/test_sharded.py:250-268)."""
    import os
    import tempfile
    from gpufluidsimulator_torch.parallel import sharded
    from gpufluidsimulator_torch.utils import checkpoint

    t0 = time.perf_counter()
    rc, lines = cli_call(["run", "--sharded", "--scene", "dam_break", "-n",
                          "20000", "--dim", "3", "--steps", "20",
                          "--report-every", "10", "--method", "pallas_inc"])
    final = last_json(lines)
    head = [ln for ln in lines if ln.startswith("scene=")]
    n_cards = torch.cuda.device_count()
    check(rc == 0 and bool(head)
          and f"method=sharded-pallas_inc x{n_cards}" in head[0]
          and final["overflow"] == 0 and not final["nan"],
          f"run --sharded: rc {rc}, {head}, {final}")
    params, state = ft.scenes.dam_break(n=50_000, dim=3, jitter=0.2, seed=2,
                                        device="cuda")
    mesh = cuda_mesh(torch, 4)
    sstate, m_cap = sharded.distribute(params, state, mesh)
    full = sharded.run_sharded(sstate, params, mesh, 20, m_cap)
    half = sharded.run_sharded(sstate, params, mesh, 10, m_cap)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard-") as tmp:
        path = os.path.join(tmp, "shard.npz")
        checkpoint.save_sharded(path, half, params, step=10,
                                n_total=state.n)
        loaded, p2, step, n_total = checkpoint.load_sharded(path, mesh)
    resumed = sharded.run_sharded(loaded, p2, mesh, 10, m_cap)
    bitwise = all(torch.equal(a, b) for fa, fb in zip(full, resumed)
                  for a, b in zip(fa, fb))
    check(bitwise and (step, n_total) == (10, state.n) and p2 == params,
          "save_sharded / load_sharded: the resumed run differs")
    emit({"phase": "sharded_tools", "cli": head[0].strip(),
          "cli_final": final, "resume_bitwise": bitwise,
          "resume_particles": state.n, "slabs": 4,
          "seconds": time.perf_counter() - t0})


# the acceptance phase: the reference's gates (tests/test_naive_vs_oracle.py,
# tests/test_invariants.py, scripts/soak.py) on the card, at the reference's
# sizes and step counts and with its bars
DT2_STEPS = 1000
DT2_BARS = {"naive": 1e-3, "gridded": 1e-3, "pallas": 1e-3,
            "pallas_inc": 1e-3,
            # an O(dt)-different density evolution: the reference's bar
            "pallas_inc_cont": 1e-2}
# the reference's own errors there, on the TPU (BASELINE.md:729, :420-425)
DT2_REFERENCE = {"pallas": 4.9e-5, "pallas_inc": 6.3e-5,
                 "pallas_inc_cont": 4.8e-3}
INVARIANT_METHODS = ("naive", "pallas_inc", "pallas_inc_cont")
INVARIANT_CHECKS = ("momentum", "energy", "finite", "bounds", "obstacles")
SOAK_STEPS = 5000
SOAK_CHUNK = 250


def acceptance_dt2(torch, ft):
    """1000 steps of config 1's scene at dt/2 on each method, against the
    port's float64 C++ oracle (cell lists), particles by id."""
    from gpufluidsimulator_torch.oracle import native
    params, state = ft.scenes.dam_break(n=4096, dim=2, device="cuda")
    params = params.replace(dt=params.dt * 0.5)
    t0 = time.perf_counter()
    want, _, _, _ = native.run(state.pos.double().cpu().numpy(),
                               state.vel.double().cpu().numpy(), params,
                               DT2_STEPS, use_grid=True)
    oracle_s = time.perf_counter() - t0
    for method, bar in DT2_BARS.items():
        t0 = time.perf_counter()
        st = ft.run(state, params, DT2_STEPS, method=method)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = positions_by_id(st).double().cpu().numpy()
        err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))
        overflow = int(st.overflow)
        emit({"phase": "acceptance", "check": "dt2_parity",
              "method": method, "particles": state.n, "steps": DT2_STEPS,
              "rel_err": err, "bar": bar,
              "reference_tpu_rel_err": DT2_REFERENCE.get(method),
              "overflow": overflow, "seconds": secs,
              "oracle_seconds": oracle_s})
        check(err < bar and overflow == 0,
              f"dt/2 parity {method}: rel_err {err} (bar {bar}), overflow "
              f"{overflow}")


def acceptance_statistical():
    """The full-CFL statistical acceptance of both incremental tiers
    (scripts/torch_accept_cont.py)."""
    from scripts import torch_accept_cont as acc
    params, state = acc.scene()
    result = acc.accept(params, state)
    for r in result["runs"]:
        for row in r["rows"]:
            emit({"phase": "acceptance", "check": "statistical", **row})
        emit({"phase": "acceptance", "check": "statistical_fall",
              "method": r["method"], "com_fall": r["com_fall"],
              "bar": acc.COM_FALL, "seconds": r["seconds"],
              "oracle_seconds": result["oracle_s"]})
    bad = acc.failures(result)
    check(not bad, f"statistical acceptance: {bad}")


def acceptance_invariants():
    """tests/test_invariants.py's checks on the card
    (scripts/torch_invariants.py)."""
    from scripts import torch_invariants as inv
    for method in INVARIANT_METHODS:
        for name in INVARIANT_CHECKS:
            t0 = time.perf_counter()
            r = inv.CHECKS[name](method, "cuda")
            emit({"phase": "acceptance", "check": f"invariant_{name}",
                  "method": method, **r,
                  "seconds": time.perf_counter() - t0})
            check(r["ok"], f"invariant {name} on {method}: {r}")


def acceptance_soak(ft_build):
    """5,000 steps of config 4 on each incremental tier in chunks of 250
    (scripts/torch_soak.py).  Returns each tier's launch counts."""
    from gpufluidsimulator_torch.ops import inc
    from scripts import torch_soak
    counts = {}
    for continuity in (False, True):
        ft_build.reset_launches()
        out = torch_soak.soak(steps=SOAK_STEPS, chunk=SOAK_CHUNK,
                              continuity=continuity)
        got = dict(ft_build.launches)
        method = out["config"]["method"]
        want = dict.fromkeys(got, 0)
        want.update(occ_rowmax=SOAK_STEPS, compact=SOAK_STEPS, place=1)
        if continuity:
            want.update(density=len(range(0, SOAK_STEPS, inc.RESUM_EVERY)),
                        force_step_cont=SOAK_STEPS,
                        consolidate_rho=SOAK_STEPS)
        else:
            want.update(density=SOAK_STEPS, force_step=SOAK_STEPS,
                        consolidate=SOAK_STEPS)
        emit({"phase": "acceptance", "check": "soak", "method": method,
              "particles": out["config"]["n"], "steps": SOAK_STEPS,
              "chunk": SOAK_CHUNK, "card": out["card"],
              **out["summary"], "launches": got,
              "chunks": [[r["step"], r["ms_per_step"], r["vmax"]]
                         for r in out["rows"]]})
        bad = torch_soak.failures(out)
        check(not bad, f"soak {method}: {bad}")
        check(got == want, f"soak {method}: launches {got}, expected {want}")
        counts[method] = got
    return counts


def phase_acceptance(torch, ft, ft_build):
    """The acceptance gates: dt/2 trajectory parity, the full-CFL
    statistical acceptance, the invariants and the soak."""
    t0 = time.perf_counter()
    acceptance_dt2(torch, ft)
    acceptance_statistical()
    acceptance_invariants()
    counts = acceptance_soak(ft_build)
    emit({"phase": "acceptance", "check": "done",
          "seconds": time.perf_counter() - t0})
    return counts


SOURCES = {
    "occ_rowmax": ("gpufluidsimulator_torch/csrc/occ_rowmax.cu",
                   "gpufluidsimulator_tpu/ops/planes.py:326"),
    "place": ("gpufluidsimulator_torch/csrc/place.cu",
              "gpufluidsimulator_tpu/ops/route.py:124"),
    "density": ("gpufluidsimulator_torch/csrc/density.cu",
                "gpufluidsimulator_tpu/ops/pallas_sph.py:98"),
    "force": ("gpufluidsimulator_torch/csrc/force.cu",
              "gpufluidsimulator_tpu/ops/pallas_sph.py:187"),
    "gather": ("gpufluidsimulator_torch/csrc/gather.cu",
               "gpufluidsimulator_tpu/ops/route.py:407 + "
               "gpufluidsimulator_tpu/ops/route.py:487"),
    "force_step": ("gpufluidsimulator_torch/csrc/force.cu",
                   "gpufluidsimulator_tpu/ops/pallas_sph.py:187 "
                   "(fuse_integrate + emit_movers)"),
    "compact": ("gpufluidsimulator_torch/csrc/compact.cu",
                "gpufluidsimulator_tpu/ops/inc.py:185 + "
                "gpufluidsimulator_tpu/ops/route.py:487"),
    "consolidate": ("gpufluidsimulator_torch/csrc/consolidate.cu",
                    "gpufluidsimulator_tpu/ops/inc.py:726"),
    "force_step_cont": ("gpufluidsimulator_torch/csrc/force.cu",
                        "gpufluidsimulator_tpu/ops/pallas_sph.py:187 "
                        "(continuity)"),
    "consolidate_rho": ("gpufluidsimulator_torch/csrc/consolidate.cu",
                        "gpufluidsimulator_tpu/ops/inc.py:726 (has_rho)"),
    "sweep_packed": ("gpufluidsimulator_torch/csrc/packed_sweep.cu",
                     "gpufluidsimulator_tpu/ops/mxu_sweep.py:174"),
}
# kernels whose launches come from the continuity tier's early run
CONT = ("force_step_cont", "consolidate_rho")
# kernels whose line entry comes from the full-rebuild run at config 3
SLICE1 = ("occ_rowmax", "place", "density", "force", "gather")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    import gpufluidsimulator_torch as ft
    from gpufluidsimulator_torch import _build as ft_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_env(torch, ft_build)
    # the main paths' instantiations hold K = 8 ranks a cell, in 3D
    lib = ft_build.library()
    force_smem = lib.fk_force_smem(8)
    facts = redesign_facts(ft_build.ptxas_report(ft_build.build_log["text"]),
                           {"force": force_smem, "force_step": force_smem,
                            "force_step_cont": force_smem,
                            "density": lib.fk_density_smem(8),
                            "sweep_packed": lib.fk_sweep_packed_smem()})
    emit({"phase": "redesigned", **facts})
    phase_parity(torch, ft)
    phase_parity_inc(torch, ft)
    phase_parity_inc_cont(torch, ft)
    phase_parity_gridded(torch, ft)
    counts = phase_run(torch, ft, ft_build, ft.scenes.dam_break,
                       dict(n=262144, dim=3), 200, "dam_break_3d_260850")
    phase_run(torch, ft, ft_build, ft.scenes.double_dam_break,
              dict(n=1_000_000, dim=3), 20, "double_dam_break_3d_1197770")
    phase_gridded_run(torch, ft, ft_build)
    state, params, counts_inc, counts_cont, step_planes_ms = \
        phase_inc_run(torch, ft, ft_build)
    results = phase_kernels(torch, ft, facts)
    results_inc = phase_inc_kernels(torch, ft, state, params, facts)
    packed, counts_packed = phase_packed_sweep(torch, ft, ft_build, state,
                                               params, facts)
    phase_tools(torch, ft, ft_build, state, params, step_planes_ms)
    del state
    params4, state4 = phase_sharded_parity(torch, ft, ft_build)
    phase_slab_force(torch, ft, params4, state4)
    del state4
    sharded_counts = phase_sharded_run(torch, ft, ft_build)
    phase_sharded_tools(torch, ft)
    soak_counts = phase_acceptance(torch, ft, ft_build)
    kernels = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def picked(r):
        return {k: r[k] for k in keys + DEVICE_KEYS if k in r}
    for name, (src, replaces) in SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces}
        if name == "sweep_packed":
            entry.update(launches=counts_packed[name], **picked(packed))
        elif name == "occ_rowmax":
            # the steps launch it through occupancy_bounds: its numbers
            # lead, the row-maxima-only call's stand beside them
            entry.update(launches=counts[name],
                         **picked(results["occupancy_bounds"]),
                         launches_pallas_inc=counts_inc[name],
                         config4=picked(results_inc["occupancy_bounds"]),
                         row_maxima_only=picked(results[name]),
                         row_maxima_only_config4=picked(results_inc[name]))
        elif name in SLICE1:
            entry.update(launches=counts[name], **picked(results[name]))
            entry["launches_pallas_inc"] = counts_inc[name]
            if name in results_inc:
                entry["config4"] = picked(results_inc[name])
        else:
            run_counts = counts_cont if name in CONT else counts_inc
            entry.update(launches=run_counts[name],
                         **picked(results_inc[name]))
            if name not in CONT:
                entry["launches_pallas_inc_cont"] = counts_cont[name]
        # launches per sharded step of config 5 on 8 slabs
        entry["launches_sharded"] = sharded_counts["pallas_inc"][name]
        entry["launches_sharded_cont"] = \
            sharded_counts["pallas_inc_cont"][name]
        # launches in the 5,000-step soak of each tier
        entry["launches_soak"] = soak_counts["pallas_inc"][name]
        entry["launches_soak_cont"] = soak_counts["pallas_inc_cont"][name]
        kernels.append(entry)
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line())
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
