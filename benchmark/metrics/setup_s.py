"""Seconds from the process's start to the window's start: imports, the
card's context, the kernel library (built on a checkout's first run),
the scene, its evolution to the cell's start and the warm-up call."""


def read(run):
    return run.setup_s
