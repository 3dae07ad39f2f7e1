"""Reading a ``torch.profiler`` window: the device's busy time, each device
operation's layer, and the idle gaps named by what the host was doing.

A device operation (kernel, copy or fill) is tied to its launch on the
host by the trace's correlation id.  Its layer is that of the launcher
entry (``launchers/*.json``) naming a function of the port on the
launch's Python stack: the outermost one that claims its callees (a
conversion claims the sweep and the compaction it runs), else the
innermost one.  Without one (no stack, or no listed function) it is that
of the kernel entry (``kernels/*.json``) whose pattern matches its name;
else it is unattributed.  The kernel entry also names
the kernel for its roofline.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "unattributed"


class DeviceOp(NamedTuple):
    name: str
    ts: float          # us
    dur: float         # us
    kernel: Optional[str]
    layer: str


class Reading(NamedTuple):
    """One traced window."""
    window_s: float
    busy_s: float
    ops: List[DeviceOp]
    gaps: Dict[str, float]       # seconds idle, by what the host was doing


def _launcher_match(tables, fn_name: str, cache: dict):
    """(layer, claims its callees) of the launcher entry naming this
    Python function (``file(line): function``), or None."""
    if fn_name in cache:
        return cache[fn_name]
    hit = None
    head, sep, func = fn_name.rpartition("): ")
    if sep:
        path = head.rsplit("(", 1)[0].replace("\\", "/")
        for ent in tables["launchers"]:
            if func == ent["function"] and path.endswith(ent["file"]):
                hit = (ent["layer"], bool(ent.get("claims_callees")))
                break
    cache[fn_name] = hit
    return hit


def _kernel_match(tables, name: str, cache: dict):
    if name in cache:
        return cache[name]
    hit = (None, None)
    for ent in tables["kernels"]:
        if ent["regex"].search(name):
            hit = (ent["name"], ent["layer"])
            break
    cache[name] = hit
    return hit


def _stab(intervals, points):
    """For each point (sorted list of (t, key)), the chain of intervals
    ((start, end, payload), properly nested) that contain it, outermost
    first."""
    ivs = sorted(intervals, key=lambda e: (e[0], -e[1]))
    out = {}
    stack: list = []
    k = 0
    for t, key in sorted(points):
        while k < len(ivs) and ivs[k][0] <= t:
            while stack and stack[-1][1] < ivs[k][0]:
                stack.pop()
            stack.append(ivs[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = [e for e in stack if e[1] >= t]
    return out


def _union(spans):
    total = 0.0
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        total += e - s
    return total, merged


def read_events(events, tables, window_s: float) -> Reading:
    dev, launch_ts = [], {}
    funcs, host = [], []
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
            host.append((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
        elif cat == "python_function":
            funcs.append((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
        elif cat in ("cpu_op", "user_annotation"):
            host.append((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
    points = []
    for idx, e in enumerate(dev):
        corr = e.get("args", {}).get("correlation")
        if corr in launch_ts:
            points.append((launch_ts[corr], idx))
    chains = _stab(funcs, points) if funcs else {}
    lcache, kcache = {}, {}
    ops = []
    for idx, e in enumerate(dev):
        name = e["name"]
        kernel, layer = _kernel_match(tables, name, kcache)
        hits = [h for h in (_launcher_match(tables, f[2], lcache)
                            for f in chains.get(idx, ())) if h is not None]
        claim = [h[0] for h in hits if h[1]]
        if claim:
            layer = claim[0]
        elif hits:
            layer = hits[-1][0]
        ops.append(DeviceOp(name=name, ts=e["ts"], dur=e.get("dur", 0.0),
                            kernel=kernel, layer=layer or UNATTRIBUTED))
    busy_us, merged = _union([(o.ts, o.ts + o.dur) for o in ops])
    gaps = defaultdict(float)
    if merged:
        holes = [(a[1], b[0]) for a, b in zip(merged, merged[1:])
                 if b[0] > a[1]]
        where = _stab(host, [((s + e) / 2.0, i)
                             for i, (s, e) in enumerate(holes)])
        for i, (s, e) in enumerate(holes):
            gaps[_gap_name(where.get(i, []))] += (e - s) / 1e6
    return Reading(window_s=window_s, busy_s=busy_us / 1e6, ops=ops,
                   gaps=dict(gaps))


def _gap_name(chain) -> str:
    spans = [c[2] for c in chain if c[2].startswith("bench.")]
    inner = [c[2] for c in chain if not c[2].startswith("bench.")]
    return f"{spans[-1] if spans else 'host'}/" \
           f"{inner[-1] if inner else 'python'}"


def profile(fn, tables, with_stack: bool, cuda: bool) -> Reading:
    """Run ``fn`` under ``torch.profiler`` (CPU, and the card's activity
    when ``cuda``) and read its trace; the window is the host's time
    around ``fn`` and the wait for the card."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts, with_stack=with_stack) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return read_events(events, tables, window_s)


def compile_tables(kernels: list, launchers: list) -> dict:
    return {"kernels": [dict(k, regex=re.compile(k["match"]))
                        for k in kernels],
            "launchers": launchers}


def device_ms_by(reading: Reading, key: str) -> Dict[str, float]:
    out = defaultdict(float)
    for o in reading.ops:
        out[getattr(o, key) or UNATTRIBUTED] += o.dur / 1e3
    return dict(out)


def kernel_durations(reading: Reading, kernel: str) -> List[float]:
    """Device seconds of each launch of ``kernel``."""
    return [o.dur / 1e6 for o in reading.ops if o.kernel == kernel]


def _short(name: str) -> str:
    """A device operation's name without ``void``, its argument list and
    anonymous namespaces, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:120]


def breakdown(reading: Reading, top: int = 10) -> dict:
    by_name = defaultdict(float)
    for o in reading.ops:
        name = o.kernel or _short(o.name)
        by_name[name] += o.dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(reading.gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


__all__ = ["Reading", "DeviceOp", "profile", "read_events",
           "compile_tables", "device_ms_by", "kernel_durations",
           "breakdown"]
