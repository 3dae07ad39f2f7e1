"""Microseconds of host time a step inside the program's ``inc.step``
spans in traced window A: what the host spends launching one incremental
step, with the profiler's own host cost (CUPTI on) included."""

from fbench.record import span_total, window_a


def read(run):
    calls = window_a(run)
    if calls is None:
        return None
    steps, host_s = span_total(calls, "inc.step")
    return host_s / steps * 1e6 if steps else None
