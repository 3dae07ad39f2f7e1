"""``density``'s share of its roofline (fbench.roofline, rooflines/density.py)."""

from fbench.roofline import share


def read(run):
    return share(run, "density")
