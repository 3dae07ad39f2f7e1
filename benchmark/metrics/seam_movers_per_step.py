"""Movers a step in traced window A whose arrival cell lies in another x
tile of the rank planes than the slot they left (the program's
``seam_movers`` counter), over the count of window A's ``inc.step``
spans.  The part of the mover path that crosses a tile seam; 0 on planes
of one tile, nothing to read on a program without the counter."""

from fbench.record import counter_total, span_total, window_a


def read(run):
    calls = window_a(run)
    if calls is None:
        return None
    steps, _ = span_total(calls, "inc.step")
    seam = counter_total(calls, "seam_movers")
    if not steps or seam is None:
        return None
    return seam / steps
