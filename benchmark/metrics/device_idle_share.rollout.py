"""Percent of traced window A in which no operation ran on the card: 1
minus the union of the device's kernel, copy and fill intervals over the
window's length (host clock, ending when the card has finished)."""


def read(run):
    if run.trace is None or not run.trace.a.ops:
        return None
    return 100.0 * (1.0 - run.trace.a.busy_s / run.trace.a.window_s)
