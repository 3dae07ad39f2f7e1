"""The most particles any cell held after a step's consolidation in
traced window A: the largest of its calls' ``cell_fill_max`` counters
(the program's maximum over a call's steps).  What the cell capacity K
leaves spare; nothing to read on a program without the counter."""

from fbench.record import window_a


def read(run):
    calls = window_a(run)
    if calls is None:
        return None
    vals = [c["counters"]["cell_fill_max"] for c in calls
            if "cell_fill_max" in c["counters"]]
    return float(max(vals)) if vals else None
