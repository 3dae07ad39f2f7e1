"""A script's closed loop: calls of ``solver.run(state, params,
steps_per_call, method)``, back to back, each from the evolved state and
each ending when the card has finished it.

Traffic keys: ``method``, ``steps_per_call``, ``check_steps``,
``returned_rho``, ``trace_a`` and ``trace_b`` (calls in traced windows A
and B).  The run record gets ``steps`` (every call's, in the window) and
``call_s`` (each call's seconds, for the record on standard error).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from fbench import trace


def call(c):
    out = c.prog.solver.run(c.evolved, c.params, c.t["steps_per_call"],
                            method=c.t["method"], device=c.dev)
    bad = c.guard(out)
    c.sync()
    return out, bad


def calls(c, deadline=None, count=None):
    """Calls until ``deadline`` (host clock) has passed, or ``count``
    calls -> (each call's seconds, failed tensor, last output)."""
    secs, failed, last = [], torch.zeros((), dtype=torch.long,
                                         device=c.dev), None
    while True:
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.call"):
            last, bad = call(c)
        t1 = time.perf_counter()
        secs.append(t1 - t0)
        failed += bad
        if (count is not None and len(secs) >= count) or (
                deadline is not None and t1 >= deadline):
            return secs, failed, last


def warm(c):
    call(c)


def window(c, rec, seconds):
    t0 = time.perf_counter()
    rec.call_s, rec.failed, rec.last = calls(c, deadline=t0 + seconds)
    rec.window_s = time.perf_counter() - t0
    rec.attempted = len(rec.call_s)
    rec.steps = rec.attempted * c.t["steps_per_call"]


def traced(c, rec, tables):
    """Window A (the profiler, no stacks) for the device's busy time, the
    rooflines and the breakdown; window B (with Python stacks) for each
    device operation's layer."""
    n_a, n_b = c.t["trace_a"], c.t["trace_b"]
    box = {}
    cuda = c.dev.type == "cuda"
    a = trace.profile(lambda: box.update(a=calls(c, count=n_a)), tables,
                      False, cuda)
    rec.peak_bytes = c.peak()
    b = trace.profile(lambda: box.update(b=calls(c, count=n_b)), tables,
                      True, cuda)
    rec.last = box["a"][2]
    rec.failed = box["a"][1] + box["b"][1]
    rec.attempted = n_a + n_b
    steps = c.t["steps_per_call"]
    rec.trace = SimpleNamespace(a=a, b=b, steps_a=n_a * steps,
                                steps_b=n_b * steps)
    rec.window_s = a.window_s


def one(c, rec):
    rec.call_s, rec.failed, rec.last = calls(c, count=1)


def comparisons(c, rec, dtype):
    """The timed entry for ``check_steps`` from the evolved state every
    call starts from."""
    prog = c.prog.solver.run(c.evolved, c.params, c.t["check_steps"],
                             method=c.t["method"], device=c.dev)
    yield c.compare_states(c.evolved, prog, dtype)
