"""The program's own record of its calls (``gpufluidsimulator_torch``'s
``utils.profiling``: spans and counters kept while a profiler session
records), read for traced window A.

The harness opens a profiler session only around its traced windows, so
the record's first calls are window A's: the readers take calls, oldest
first, until their steps reach ``run.trace.steps_a``.  Read with
``profiling.calls()``, which keeps the record for the next reader.  A
program without a record (no ``profiling.calls``), or whose record holds
no such window, reads as nothing.  The second module of the harness that
touches the port, read-only; it reaches it through ``fbench/program.py``'s
path set-up.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def window_a(run) -> Optional[List[dict]]:
    """Window A's calls, or None."""
    if getattr(run, "trace", None) is None:
        return None
    from . import program  # noqa: F401  (puts the checkout on the path)
    from gpufluidsimulator_torch.utils import profiling
    read = getattr(profiling, "calls", None)
    if read is None:
        return None
    out, steps = [], 0
    for call in read():
        if steps >= run.trace.steps_a:
            break
        out.append(call)
        steps += call["steps"]
    return out if out and steps == run.trace.steps_a else None


def span_total(calls: List[dict], name: str) -> Tuple[int, float]:
    """(count, host seconds) of span ``name`` over ``calls``."""
    count, host_s = 0, 0.0
    for call in calls:
        s = call["spans"].get(name)
        if s is not None:
            count += s["count"]
            host_s += s["host_s"]
    return count, host_s


def counter_total(calls: List[dict], name: str) -> Optional[int]:
    """Counter ``name`` summed over ``calls``, or None where none has it."""
    vals = [c["counters"][name] for c in calls if name in c["counters"]]
    return sum(vals) if vals else None
