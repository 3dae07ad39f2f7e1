"""Run one benchmark cell of gpufluidsimulator_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``.  Needs a CUDA
card (exits 2 without one, printing no result).  Prints one JSON line as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which also end standard error.  See benchmark/README.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HARNESS = Path(__file__).resolve().parent
ROOT = HARNESS.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpufluidsimulator_tpu")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was loaded where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None, device=None, bench_json=None, harness=HARNESS) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HARNESS))
    from fbench import spec
    cell = spec.load_cell(Path(bench_json or ROOT / "BENCHMARK.json"),
                          args.workload, harness)

    import torch
    torch.set_num_threads(1)     # one process with few threads on the host
    if device is None:
        if not torch.cuda.is_available():
            print("run.py: CUDA is not available; this benchmark needs a "
                  "card", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"run.py: {cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        device = "cuda:0"
    from fbench import bench, check

    c = bench.Cell(cell, args.seed, device)
    c.setup()
    setup_s = process_age()
    tables = spec.tables(harness) if args.trace else None
    t_window = time.perf_counter()
    rec = bench.measure(c, args.seconds, bool(args.trace), tables)
    t_check = time.perf_counter()
    rec.setup_s = setup_s
    cuda = c.dev.type == "cuda"
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.metric_reader(harness, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(c.dev) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": rec.peak_bytes,
    }
    out = {"correct": False, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": dev_info}
    notes = [f"card: {card_line() if cuda else 'none'}"]
    if args.trace:
        from fbench import trace
        dev_info.update(busy_s=rec.trace.a.busy_s,
                        window_s=rec.trace.a.window_s)
        out["breakdown"] = trace.breakdown(rec.trace.a)
        by_layer = trace.device_ms_by(rec.trace.b, "layer")
        total = sum(by_layer.values()) or 1.0
        notes.append("device ms by layer (window B): " + json.dumps(
            {k: v for k, v in sorted(by_layer.items())}))
        notes.append(f"unattributed device share: "
                     f"{by_layer.get(trace.UNATTRIBUTED, 0.0) / total}")
        loose = trace.device_ms_by(
            rec.trace.b._replace(ops=[o for o in rec.trace.b.ops
                                      if o.layer == trace.UNATTRIBUTED]),
            "name")
        notes.append("unattributed (window B, ms): " + json.dumps(
            sorted(loose.items(), key=lambda kv: -kv[1])[:8]))

    # the check, with the window's state freed but for the states it
    # follows from
    numbers = check.worst(bench.compare(c, rec))
    notes.append("numbers read (the worst comparison): "
                 + json.dumps(numbers))
    ok, rows = check.verdict(numbers, cell.limits)
    out["correct"] = bool(ok and rec.failed == 0 and rec.attempted > 0)
    checks = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    checks["failed"] = {"value": rec.failed, "limit": 0}
    out["checks"] = checks
    for what, secs in (("call", getattr(rec, "call_s", None)),
                       ("frame", getattr(rec, "frame_latency", None))):
        if secs:
            import numpy as np
            notes.append(f"{what} ms p0/p50/p90/p95/p99/p100: " + " ".join(
                str(float(np.percentile(np.asarray(secs) * 1e3, q)))
                for q in (0, 50, 90, 95, 99, 100))
                + f" over {len(secs)} {what}s")
    if rec.failed:
        notes.append("guarantees of the last returned state: " + json.dumps(
            c.guard.explain(rec.last)))
    notes.append(f"seconds: set-up {setup_s}, window and traces "
                 f"{t_check - t_window}, check "
                 f"{time.perf_counter() - t_check}")

    bad = forbidden_modules()
    if bad:
        print(f"run.py: modules that must not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
