"""``force_step``'s share of its roofline (fbench.roofline, rooflines/force_step.py)."""

from fbench.roofline import share


def read(run):
    return share(run, "force_step")
