"""Movers a step in traced window A: the rows the mover path's
``compact`` keeps, summed over window A's incremental steps (the
program's ``movers`` counter) over the count of its ``inc.step`` spans.
The mover path's work; it moves only with the trajectory or the mover
test."""

from fbench.record import counter_total, span_total, window_a


def read(run):
    calls = window_a(run)
    if calls is None:
        return None
    steps, _ = span_total(calls, "inc.step")
    movers = counter_total(calls, "movers")
    if not steps or movers is None:
        return None
    return movers / steps
