#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpufluidsimulator_torch) on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each printing JSON lines; any failed check exits non-zero:
  1. env      card name and power limit, torch / CUDA / nvcc versions, and
              the build of the hand-written kernels from csrc/
  2. kernels  each kernel at the shapes of the 260,850-particle 3D dam break
              (and a jittered copy): held against its plain PyTorch version
              on the same inputs, timed with CUDA events, with its bound
  3. parity   one FluidSim(method="pallas") step on the card against the
              port's CPU path (2D n=600, 3D n=1,200), re-aligned by ids
  4. run      200 steps of the 3D dam break (260,850 particles) and 20 of
              the 3D double dam break (1,197,770 particles): overflow 0,
              finite, in bounds, ids a permutation, and launch counts that
              show every step went through every kernel
  5. the kernels line, the card line, and the final ok line.
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
REPS = 20


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
    ptxas = [ln.strip() for ln in ft_build.build_log["text"].splitlines()
             if "registers" in ln or "spill" in ln or ln.startswith("==")]
    emit({"phase": "build", "seconds": round(secs, 3),
          "library": ft_build.build_log["path"], "ptxas": ptxas})


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


def phase_kernels(torch, ft):
    from gpufluidsimulator_torch.ops import planes as pm
    from gpufluidsimulator_torch.ops import route, sph

    dev = torch.device("cuda")
    results = {}
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
        cases = {
            "occ_rowmax": dict(
                kernel=lambda: pm.occ_rowmax(planes[0], geom),
                plain=lambda: pm.occ_rowmax_plain(planes[0]),
                library=lambda: torch.amax(torch.sum(
                    planes[0] < pm.SENTINEL * 0.5, dim=0,
                    dtype=torch.int32), dim=-1),
                tol=0.0, exact=True,
                bytes=kc * 4 + geom.pz * geom.n_bx * geom.py * 4, flops=0),
            "place": dict(
                kernel=lambda: route.place(fields, slot, ok, geom, 3),
                plain=lambda: route.place_plain(fields, slot, ok, geom, 3),
                library=None, tol=0.0, exact=True,
                bytes=6 * n * 4 + n * 4 + n + 6 * kc * 4, flops=0),
            "density": dict(
                kernel=lambda: sph.density_planes(planes[:3], occ_q, occ_s,
                                                  params, geom),
                plain=lambda: sph.density_plain(planes[:3], params, geom),
                library=None, tol=1e-5, exact=False,
                bytes=(3 + 1) * kc * 4,
                flops=DENSITY_PAIR_FLOPS * stencil_pairs(torch, planes,
                                                         geom)),
            "force": dict(
                kernel=lambda: sph.accel_planes(planes, rho, occ_q, occ_s,
                                                params, geom),
                plain=lambda: sph.accel_plain(planes, rho, params, geom),
                library=None, tol=1e-4, exact=False,
                bytes=(6 + 1 + 3) * kc * 4,
                flops=FORCE_PAIR_FLOPS * stencil_pairs(torch, planes, geom)),
            "gather": dict(
                kernel=lambda: route.gather(stack, slot),
                plain=lambda: route.gather_plain(stack, slot),
                library=None, tol=0.0, exact=True,
                bytes=n * 4 * 4 + n * 4 + n * 4 * 4, flops=0),
        }
        # one PyTorch call computing the same function, where one exists
        flat_stack = stack.reshape(stack.shape[0], -1)
        idx = torch.clamp_max(slot.to(torch.int64), kc - 1)
        cases["gather"]["library"] = lambda: flat_stack[:, idx]
        slot_ok = slot[ok].to(torch.int64)
        vals_ok = fields[:, ok]
        chan = torch.arange(6, device=dev)[:, None]
        prefilled = route.place_plain(fields[:, :0], slot[:0], ok[:0], geom,
                                      3).reshape(6, -1)
        cases["place"]["library"] = lambda: prefilled.index_put_(
            (chan, slot_ok[None, :]), vals_ok)

        for name, c in cases.items():
            got = c["kernel"]()
            want = c["plain"]()
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} ({label}): shape/dtype {tuple(got.shape)} "
                  f"{got.dtype} vs plain {tuple(want.shape)} {want.dtype}")
            if c["exact"]:
                err = rel = float((got.double() - want.double()).abs().max())
                check(torch.equal(got, want),
                      f"{name} ({label}) differs from its plain version")
            else:
                err, rel = rel_err(got, want)
                check(np.isfinite(err) and rel <= c["tol"],
                      f"{name} ({label}) rel err {rel} > {c['tol']}")
            emit({"phase": "kernel_check", "kernel": name, "input": label,
                  "max_abs_err": err, "rel_err": rel, "tol": c["tol"],
                  "exact": c["exact"]})
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if label == "lattice":
                ms = time_ms(torch, c["kernel"], REPS)
                plain_ms = time_ms(torch, c["plain"], 3)
                lib_ms = (time_ms(torch, c["library"], REPS)
                          if c["library"] is not None else None)
                bound_s = max(c["bytes"] / HBM_BYTES_PER_S,
                              c["flops"] / F32_FLOPS)
                r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_s * 1e3,
                         bound_by=("bytes" if c["bytes"] / HBM_BYTES_PER_S
                                   >= c["flops"] / F32_FLOPS
                                   else "operations"),
                         bytes=c["bytes"], flops=c["flops"])
                emit({"phase": "kernel_time", "kernel": name,
                      "shape": "dam_break n=262144 3D (260,850 particles)",
                      **{k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by", "bytes",
                                           "flops")}})
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
        check(cnt == steps, f"{label}: kernel {name} launched {cnt} times "
                            f"in {steps} steps (expected {steps})")
    rho = sim.state.rho
    emit({"phase": "run", "scene": label, "particles": n, "steps": steps,
          "ms_per_step": ms, "particle_steps_per_s": n * 1e3 / ms,
          "wall_s": wall, "launches": counts,
          "rho_mean": float(rho.mean()), "rho_max": float(rho.max()),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **checks})
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
}


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
    results = phase_kernels(torch, ft)
    phase_parity(torch, ft)
    counts = phase_run(torch, ft, ft_build, ft.scenes.dam_break,
                       dict(n=262144, dim=3), 200, "dam_break_3d_260850")
    phase_run(torch, ft, ft_build, ft.scenes.double_dam_break,
              dict(n=1_000_000, dim=3), 20, "double_dam_break_3d_1197770")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line())
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
