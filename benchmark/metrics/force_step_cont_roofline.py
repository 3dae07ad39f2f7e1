"""``force_step_cont``'s share of its roofline (fbench.roofline, rooflines/force_step_cont.py)."""

from fbench.roofline import share


def read(run):
    return share(run, "force_step_cont")
