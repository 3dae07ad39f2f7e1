"""Particles times the steps of every call in the window, over the
window: whole calls, each ending when the card has finished it."""


def read(run):
    if run.trace is not None or not getattr(run, "steps", None):
        return None
    return run.n * run.steps / run.window_s
